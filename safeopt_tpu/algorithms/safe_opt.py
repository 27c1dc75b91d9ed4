"""SafeOpt: exact safe Bayesian optimization on a discretized grid.

Accelerator-native re-implementation of the reference algorithm class
(/root/reference/safeopt/gp_opt.py:281-712). The public surface —
constructor signature, ``optimize(context, ucb)``,
``get_maximum(context)``, ``compute_sets``, ``compute_safe_set``,
``get_new_query_point``, the ``S``/``M``/``G``/``Q`` attributes, context
handling and the Lipschitz variant — matches the reference; all O(N)
grid work runs in the fused jitted step (``safe_opt_core``).

Host/device split: branchy small-scalar logic (the empty-safe-set
error, context bookkeeping) stays host-side; the grid never leaves the
device between posterior, classification and selection.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..config import default_dtype
from .base import GaussianProcessOptimization
from .safe_opt_core import (certified_finish, certified_scan,
                            device_oracle, full_expander_sets,
                            interval_scan, safe_maximum, safeopt_step,
                            safeopt_step_from_Q)

__all__ = ["SafeOpt", "PendingSafeOptStep"]


class PendingSafeOptStep:
    """Handle for an in-flight SafeOpt iteration (``optimize_async``).

    ``result()`` blocks on the single diagnostics pull, records the
    iteration's stats, and returns the next query point — idempotent.
    The reference's empty-safe-set EnvironmentError surfaces here.
    """

    def __init__(self, opt, result, diag, start):
        self._opt, self._res, self._diag = opt, result, diag
        self._start = start
        self._x = None
        self._done = False
        # start the device->host copy of the diagnostics as soon as
        # the program produces them so result()'s pull overlaps the
        # next iteration's compute (no-op where unsupported)
        buf = diag if diag is not None else result.diag
        try:
            buf.copy_to_host_async()
        except (AttributeError, RuntimeError):  # pragma: no cover
            pass

    def result(self) -> np.ndarray:
        """Block on the diagnostics pull, commit stats, and return the
        next query point (idempotent)."""
        if not self._done:
            self._x = self._opt._finish_step(self._res, self._diag,
                                             self._start)
            self._done = True
        return self._x

# Max scaled interval error of each reduced-precision mode, measured
# on the retired chip (not this one) over the cap512 bench grid, where
# 'high' was an emulated 3-pass bf16 product. refine_band must exceed
# boundary_band by at least this much or a knife-edge row can escape
# both the refinement and the f64 oracle. 1-pass bf16 ('default') was
# unsalvageable at high capacity there; the 5e-2 entry makes ANY
# plausible band warn rather than pretend a ceiling exists. On the GPU
# 'high' means TF32, whose ceiling nobody has measured, so reduced
# precision is refused there (``SafeOpt.__init__``).
_REDUCED_PRECISION_NOISE_CEILING = {"high": 7.3e-3, "default": 5e-2}

# Sentinel distinguishing "keep the current context" (compute_sets,
# reference gp_opt.py:483 never touches the context) from an explicit
# ``context=None`` (which, with num_contexts > 0, is an error exactly
# like the reference setter's, gp_opt.py:445-447).
_KEEP_CONTEXT = object()


class SafeOpt(GaussianProcessOptimization):
    """Safe Bayesian optimization over a discrete candidate set.

    Implements SafeOpt (Sui et al. 2015; Berkenkamp et al. 2016): keep a
    set of certified-safe candidates, and at each step query the most
    uncertain point among the potential maximizers and the potential
    safe-set expanders.

    Parameters
    ----------
    gp : GPRegression or list
        Objective GP first, then one GP per safety constraint.
    parameter_set : 2d-array (N, d)
        Discrete candidate inputs (build with
        ``linearly_spaced_combinations``).
    fmin : float or list of floats
        Safety threshold per GP (``-inf`` = unconstrained).
    lipschitz : float or list of floats, optional
        Lipschitz constants; when given, the expander test uses the
        Lipschitz bound instead of virtual GP observations.
    beta : float or callable
    num_contexts : int
        Trailing context dimensions appended to every candidate.
    threshold : float or list of floats
    scaling : 'auto' or list of floats
    exact_boundaries : bool, optional
        Certify safe-set decisions in float64: candidates whose scaled
        safety margin falls inside ``boundary_band`` (the f32 ambiguity
        band of float32 interval bounds; see ``boundary_scan``) are
        recomputed at float64 and their safe bits overridden before
        maximizers/expanders/query selection. Default ``None``: on
        only when an explicit ``interval_precision`` asks for it;
        ``True`` forces it on, ``False`` off.
        Accepts any model with a float64 host oracle (``predict_f64``):
        ``GPRegression`` and ``SparseGPRegression``. For sparse models
        "exact" means exact for the DTC model, not for the exact GP —
        see ``SparseGPRegression.predict_f64``.
    boundary_band : float
        Scaled-margin width of the certification band (default 1e-3,
        calibrated to the f32 interval noise of exact-GP factors). For
        SPARSE models the float32 interval noise grows with the DTC
        pseudo-factor's magnitude and with the cancellation in
        ``kdiag - colsum(V^2)``: at n=2000, m=64 (max entry ~1e2) it
        reaches ~2e-3 scaled, so widen ``boundary_band`` (to ~1e-2
        there) or raise the model's ``jitter``.
    boundary_k : int, optional
        Triage budget: at most this many near-boundary candidates are
        certified per iteration (overflow logs a warning). Default
        ``None``: 1024.
    interval_precision : str, optional
        Run the full-grid interval pass at a reduced matmul precision
        (``'default'`` or ``'high'``, XLA interval path only). Default
        ``'auto'``, which resolves to ``None``: the plain path at
        ``config.MATMUL_PRECISION`` on every backend. A reduced
        precision is refused on the GPU (``ValueError``): there
        ``'high'`` and ``'default'`` mean TF32, and its interval noise
        ceiling has not been measured on this device, so no refinement
        band can be shown to cover it. On the CPU (tests) the
        certified machinery stays reachable. The decision-critical rows
        are restored to full precision on device before classification:
        the entire reduced-precision safety ambiguity band
        (``refine_band`` wide, up to ``refine_band_k`` rows) plus the
        top-``refine_k`` safe rows by a combined boundary-proximity
        score — so the f64 certification band can stay at its usual
        narrow ``boundary_band``. Requires ``exact_boundaries=True``.
    refine_k : int, optional
        Size of the combined global-threshold head: the top safe rows by the
        pointwise max of three boundary-proximity scores (width / best lower
        bound / maximizer boundary, each 0 at its decision boundary)
        restored to full precision. Default (None) auto-selects 2048
        whenever ``interval_precision`` is set — sized to cover the
        reduced-precision noise band AROUND each decision boundary (measured
        on the retired chip, not this one, at the cap512 bench config:
        3-pass noise flips maximizer membership up to ~2e-3 from ``best_l0``
        and reorders the expander walk at ~5e-4 width gaps, and 1611 rows
        sit within ``refine_band`` of a head boundary; the head shares one
        top-(refine_band_k + refine_k) selection with the safety band, so
        its marginal cost is ~zero and it is sized for slack). With the head
        restored, the CERTIFIED trajectory (after the f64 boundary oracle)
        matches the full-precision certified run on the bench config;
        residual knife-edge flips remain possible because refined rows are
        recomputed on a different (exact-posterior) code path than the
        chunked grid pass, so trajectory identity is measured, not asserted.
        The head's PROVABLE coverage is limited to its three score
        boundaries (safety margin, safe-max width, best_l0/maximizer
        proximity); comparisons away from them — the ``max_var`` candidate
        cutoff, the ``threshold*beta`` cut, deep expander-walk width ties —
        are empirically-gated residuals (see ``safe_opt_core._refine_Q``).
        Explicit ``refine_k=0`` opts out for speed: safe-set decisions
        remain f64-certified through the boundary band, but near-tie query
        selections may differ from the full-precision trajectory by a
        ~1e-3-relative width tie (a runtime warning records this).
    refine_band : float
        Scaled-margin width of the refinement band: the radius around
        every decision boundary within which rows are PROMISED full
        precision. Size it ABOVE the reduced-precision interval noise
        ceiling — default 1e-2, 1.37x the 7.3e-3 max scaled 3-pass
        error measured on the retired chip over the cap512 bench grid,
        not on this one; a band below the noise ceiling lets a
        knife-edge row escape both the refinement and the downstream
        f64 oracle.
    refine_band_k : int
        Budget of near-boundary rows restored to full precision
        (default 20480, sized so the measured 1e-2 band population on
        the 1e6-point bench grid (~16,400 rows) fits in ``band_k``
        alone with ~25% slack — the ``refine_k`` share is never needed
        to absorb the safety band, even in fast mode; overflow is
        reported via
        ``_refine_band_overflow`` and voids the parity guarantee).
    oracle : str
        Where the f64 knife-edge oracle runs: ``'host'`` (the bitwise
        reference — ``predict_f64`` on the host f64 factors; costs, per
        iteration with flips, two extra device round trips + a host
        predict + a redundant re-classification), ``'device'`` (the
        SAME f64 factors evaluated by the GPU in native float64,
        ``safe_opt_core.device_oracle`` — with classification running
        ONCE after the verdicts exist, so the certified path pulls one
        diagnostics buffer per iteration exactly like the plain step;
        decisions agree with the host oracle except on
        ~1e-15-relative knife edges from accumulation order, checked
        by ``chip_smoke.py``), or ``'auto'`` (default: ``'device'`` on
        the GPU, ``'host'`` on the CPU).

    Examples
    --------
    >>> import numpy as np
    >>> from safeopt_tpu import SafeOpt, linearly_spaced_combinations
    >>> from safeopt_tpu.gp import GPRegression
    >>> gp = GPRegression(np.array([[0.]]), np.array([[1.]]),
    ...                   noise_var=0.01 ** 2)
    >>> parameter_set = linearly_spaced_combinations([[-1., 1.]],
    ...                                              num_samples=100)
    >>> opt = SafeOpt(gp, parameter_set, fmin=[0.])
    >>> next_parameters = opt.optimize()
    >>> performance = np.array([[1.]])
    >>> opt.add_new_data_point(next_parameters, performance)
    """

    def __init__(self, gp, parameter_set, fmin, lipschitz=None, beta=2,
                 num_contexts=0, threshold=0, scaling="auto",
                 expander_chunk: int = 32,
                 exact_boundaries=None, boundary_band: float = 1e-3,
                 boundary_k=None, interval_precision="auto",
                 refine_k=None, refine_band: float = 1e-2,
                 refine_band_k: int = 20480, oracle: str = "auto"):
        super().__init__(gp, fmin=fmin, beta=beta,
                         num_contexts=num_contexts, threshold=threshold,
                         scaling=scaling)

        if interval_precision == "auto":
            interval_precision = None
        if interval_precision is not None and config.platform() == "gpu":
            raise ValueError(
                f"interval_precision={interval_precision!r} is refused on "
                "the GPU: reduced precision means TF32 there, and its "
                "interval noise ceiling has not been measured on this "
                "device, so no refine_band can be shown to cover it; use "
                "interval_precision=None")
        if interval_precision is not None and exact_boundaries is None:
            # an explicit reduced-precision request implies the f64
            # certification it is only sound under
            exact_boundaries = True
        exact_boundaries = bool(exact_boundaries)

        parameter_set = np.asarray(parameter_set, dtype=float)
        if self.num_contexts > 0:
            ctx = np.zeros((parameter_set.shape[0], self.num_contexts))
            self.inputs = np.hstack((parameter_set, ctx))
            self.parameter_set = self.inputs[:, : -self.num_contexts]
        else:
            self.inputs = parameter_set
            self.parameter_set = parameter_set

        self.lipschitz = lipschitz
        if self.lipschitz is not None:
            if not isinstance(self.lipschitz, list):
                self.lipschitz = [self.lipschitz] * len(self.gps)
            self.lipschitz = np.atleast_1d(
                np.asarray(self.lipschitz, dtype=float).squeeze())
        self._use_lipschitz = self.lipschitz is not None

        N = self.inputs.shape[0]
        num_gps = len(self.gps)
        # Host mirrors of the device results are materialized lazily:
        # Q alone is 16 MB at a 1e6-point grid, and pulling it every
        # iteration would dominate wall-clock.
        self._dev = None
        self._host_cache = {
            "Q": np.zeros((N, 2 * num_gps)),
            "S": np.zeros(N, dtype=bool),
            "M": np.zeros(N, dtype=bool),
            "G": np.zeros(N, dtype=bool),
        }

        self._expander_chunk = min(int(expander_chunk), N)
        self._grid_device = None   # lazily shipped device copy of inputs
        self._grid_dirty = True


        # Boundary certification: recompute the few near-threshold
        # candidates in host float64 and override their safe bits, so
        # safe-set DECISIONS are f64-exact even when the grid pass
        # runs in float32.
        self._exact_boundaries = bool(exact_boundaries)
        self._boundary_band = float(boundary_band)
        if boundary_k is None:
            boundary_k = 1024
        self._boundary_k = min(int(boundary_k), N)
        # Where the f64 knife-edge oracle runs. 'host' is the bitwise
        # reference (predict_f64 on the host f64 factors) but costs,
        # per iteration WITH flips, a packed-buffer round trip + host
        # predict + correction dispatch + second round trip. 'device'
        # evaluates the same f64 factors on the GPU in native float64
        # (safe_opt_core.device_oracle) and classifies once after the
        # verdicts exist, so the certified path pulls ONE diagnostics
        # buffer like the plain step. 'auto': 'device' on the GPU,
        # 'host' on the CPU (tests keep bitwise reference semantics).
        if oracle not in ("auto", "host", "device"):
            raise ValueError("oracle must be 'auto', 'host' or 'device', "
                             f"got {oracle!r}")
        has_dev_oracle = all(hasattr(g, "device_oracle_state")
                             for g in self.gps)
        if oracle == "auto":
            oracle = ("device"
                      if config.platform() == "gpu" and has_dev_oracle
                      else "host")
        elif oracle == "device" and not has_dev_oracle:
            raise ValueError(
                "oracle='device' requires models exposing "
                "device_oracle_state (GPRegression, SparseGPRegression)")
        self._oracle = oracle
        # Reduced-precision certified mode: run the full-grid interval
        # pass at a reduced matmul precision ('default' or 'high'),
        # restore full precision on the decision-critical rows
        # in-program (safe_opt_core._refine_Q), and let the (widened)
        # f64 certification band absorb the rest. Only meaningful with
        # exact_boundaries=True.
        self._interval_precision = interval_precision
        if refine_k is None:
            # auto: restore the selection head wide enough to cover the
            # reduced-precision noise band around each decision
            # boundary (docstring: ~1600 rows sat within 5e-3 of a head
            # boundary at the cap512 bench config, and the shared
            # top-(band_k + rk) budget absorbs them). The head folds
            # into the one unified top_k, so size for slack, not
            # thrift.
            refine_k = 2048 if interval_precision is not None else 0
        elif refine_k == 0 and interval_precision is not None:
            import logging
            logging.warning(
                "interval_precision with refine_k=0: safe-set decisions "
                "stay f64-certified, but golden-trajectory parity is "
                "voided — near-tie query selections may differ from the "
                "full-precision trajectory (see the SafeOpt docstring)")
        self._refine_k = min(int(refine_k), N)
        self._refine_band = float(refine_band)
        self._refine_band_k = min(int(refine_band_k), N)
        if interval_precision is not None and not self._exact_boundaries:
            raise ValueError(
                "interval_precision requires exact_boundaries=True: "
                "reduced-precision intervals are only safe under f64 "
                "boundary certification")
        if (interval_precision is not None
                and self._refine_band < self._boundary_band):
            # the f64 triage runs over the refined subset, which is
            # selected by the refine band: a narrower refine band would
            # silently hide true in-band rows from the oracle
            raise ValueError(
                f"refine_band ({self._refine_band}) must be >= "
                f"boundary_band ({self._boundary_band}) so the refined "
                "subset covers every possible f64-band row")
        if interval_precision is not None:
            # Soundness needs refine_band >= boundary_band + the
            # reduced-precision interval error ceiling: a band whose
            # slack over the f64 band is below the noise lets a
            # knife-edge row escape BOTH the refinement and the oracle;
            # the ceilings are the retired chip's
            # (_REDUCED_PRECISION_NOISE_CEILING).
            ceiling = _REDUCED_PRECISION_NOISE_CEILING.get(
                interval_precision, 7.3e-3)
            if self._refine_band - self._boundary_band < ceiling:
                import logging
                logging.warning(
                    "interval_precision=%r: refine_band (%g) minus "
                    "boundary_band (%g) is below the measured "
                    "reduced-precision noise ceiling (%g); a knife-edge "
                    "row can escape both the refinement and the f64 "
                    "oracle — widen refine_band to at least "
                    "boundary_band + %g", interval_precision,
                    self._refine_band, self._boundary_band, ceiling,
                    ceiling)
        if self._exact_boundaries:
            for g in self.gps:
                if not hasattr(g, "predict_f64"):
                    raise ValueError(
                        "exact_boundaries requires models with a float64 "
                        "host oracle (predict_f64): GPRegression and "
                        f"SparseGPRegression qualify, {type(g).__name__} "
                        "does not")

        # certified-path telemetry (filled by _certified_step)
        self._band_overflow = False
        self._band_population = 0
        self._certified_corrections = 0
        self._refine_band_population = 0
        self._refine_band_overflow = False

        from ..utils.observability import StatsRecorder
        self.stats = StatsRecorder()

    # -- properties mirrored from the reference ------------------------------

    @property
    def use_lipschitz(self) -> bool:
        """Whether the expander test uses the Lipschitz constant."""
        return self._use_lipschitz

    @use_lipschitz.setter
    def use_lipschitz(self, value: bool):
        if value and self.lipschitz is None:
            raise ValueError("Lipschitz constant not defined")
        self._use_lipschitz = bool(value)

    @property
    def parameter_set(self):
        """Discrete parameter candidates (context columns excluded)."""
        return self._parameter_set

    @parameter_set.setter
    def parameter_set(self, parameter_set):
        self._parameter_set = parameter_set
        self.bounds = list(zip(np.min(parameter_set, axis=0),
                               np.max(parameter_set, axis=0)))
        self.num_samples = [len(np.unique(parameter_set[:, i]))
                            for i in range(parameter_set.shape[1])]

    @property
    def context_fixed_inputs(self):
        """Fixed-input pairs pinning the current context (for plotting)."""
        n = self.gp.input_dim - 1
        nc = self.num_contexts
        if nc > 0:
            contexts = self.inputs[0, -nc:]
            return list(zip(range(n, n - nc, -1), contexts))

    @property
    def context(self):
        """Current context columns of the candidate grid."""
        if self.num_contexts:
            return self.inputs[0, -self.num_contexts:]

    @context.setter
    def context(self, context):
        if self.num_contexts:
            if context is None:
                raise ValueError("Need to provide value for context.")
            self.inputs[:, -self.num_contexts:] = context
            self._grid_dirty = True

    # -- lazy host mirrors of device results ---------------------------------

    def _mirror(self, name: str) -> np.ndarray:
        v = self._host_cache[name]
        if v is None:
            v = getattr(self._dev, name)
        if not isinstance(v, np.ndarray):
            v = np.asarray(v)          # device pull happens HERE, lazily
        self._host_cache[name] = v
        return v

    def _set_mirror(self, name: str, value) -> None:
        # Store as-is: a device array is not pulled until first access.
        self._host_cache[name] = value

    Q = property(lambda self: self._mirror("Q"),
                 lambda self, v: self._set_mirror("Q", v),
                 doc="(N, 2G) confidence intervals [l0, u0, l1, u1, ...]"
                     " (lazy host mirror of the device result).")
    S = property(lambda self: self._mirror("S"),
                 lambda self, v: self._set_mirror("S", v),
                 doc="(N,) certified-safe mask (lazy host mirror).")
    M = property(lambda self: self._mirror("M"),
                 lambda self, v: self._set_mirror("M", v),
                 doc="(N,) potential-maximizer mask (lazy host mirror).")
    G = property(lambda self: self._mirror("G"),
                 lambda self, v: self._set_mirror("G", v),
                 doc="(N,) potential-expander mask (lazy host mirror).")

    # -- device plumbing ------------------------------------------------------

    def _grid(self) -> jnp.ndarray:
        if self._grid_dirty or self._grid_device is None:
            self._grid_device = jnp.asarray(self.inputs,
                                            dtype=default_dtype())
            self._grid_dirty = False
        return self._grid_device

    def _model_args(self):
        kernels = tuple(g.kern for g in self.gps)
        states = tuple(g.state for g in self.gps)
        return kernels, states

    def _threshold_array(self) -> np.ndarray:
        th = np.asarray(self.threshold, dtype=float)
        return np.broadcast_to(th, (len(self.gps),))

    def _step_consts(self) -> dict:
        """Iteration-invariant step operands, device-resident.

        Each ``jnp.asarray`` of fresh host data is a blocking host->
        device transfer; re-shipping fmin/scaling/threshold/bands/
        lipschitz on every ``optimize()`` adds one per operand. Ship
        them once and key the cache on the current host values so direct
        attribute mutation (``opt.fmin = ...``) still takes effect;
        the only per-iteration operand left is beta(t). Mirrors the
        swarm's ``_device_consts`` (swarm_opt.py).
        """
        dtype = default_dtype()
        key = (tuple(np.atleast_1d(np.asarray(self.fmin,
                                              dtype=float)).tolist()),
               tuple(np.atleast_1d(np.asarray(self.scaling,
                                              dtype=float)).tolist()),
               tuple(self._threshold_array().tolist()),
               None if self.lipschitz is None else
               tuple(np.atleast_1d(np.asarray(self.lipschitz,
                                              dtype=float)).tolist()),
               float(self._boundary_band), float(self._refine_band),
               str(dtype))
        if getattr(self, "_consts_key", None) != key:
            self._consts_key = key
            self._consts = dict(
                fmin=jnp.asarray(self.fmin, dtype),
                scaling=jnp.asarray(self.scaling, dtype),
                threshold=jnp.asarray(self._threshold_array(), dtype),
                lipschitz=(None if self.lipschitz is None
                           else jnp.asarray(self.lipschitz, dtype)),
                boundary_band=jnp.asarray(self._boundary_band, dtype),
                refine_band=jnp.asarray(self._refine_band, dtype))
        return self._consts

    def _certified_step(self, kernels, states, ucb: bool):
        """Optimistic certified iteration (one dispatch in the common case).

        Pass 1 (device, ``certified_scan``): the COMPLETE fused step
        plus triage of the <=k candidates whose scaled safety margin is
        inside the ambiguity band, pulled as one packed buffer. If the
        band is empty, or the host float64 oracle confirms every f32
        in-band verdict, pass 1 is the certified result — zero extra
        dispatches. Only when a verdict actually flips does pass 2
        (``safeopt_step_from_Q``) redo classification/expander/
        selection with the certified bits scattered in.

        Returns ``(StepResult, diag or None)`` — ``diag`` is the
        already-pulled [has_safe, next_idx, |S|, |M|, anyG] when pass 1
        stands, saving ``optimize()`` its own pull.
        """
        import logging

        if self._oracle == "device":
            return self._certified_step_device(kernels, states, ucb)

        dtype = default_dtype()
        k = self._boundary_k
        consts = self._step_consts()
        result, packed = certified_scan(
            kernels, states, self._grid(),
            consts["fmin"],
            jnp.asarray(self.beta(self.t), dtype),
            consts["scaling"],
            consts["threshold"],
            consts["boundary_band"],
            consts["lipschitz"],
            refine_band=consts["refine_band"],
            k=k, refine_k=self._refine_k,
            refine_band_k=(self._refine_band_k
                           if self._interval_precision is not None else 0),
            ucb=ucb, use_lipschitz=self._use_lipschitz,
            chunk=self._expander_chunk,
            interval_precision=self._interval_precision)
        packed = np.asarray(packed)              # the ONE host pull
        diag = packed[:5]
        total = int(packed[5])
        refine_pop = int(packed[6])
        idx = packed[7:7 + k]
        within = packed[7 + k:7 + 2 * k].astype(bool)
        s_f32 = packed[7 + 2 * k:7 + 3 * k].astype(bool)
        if total > k:
            logging.warning(
                "exact_boundaries: %d candidates inside the ambiguity "
                "band exceed the triage budget k=%d; only the k closest "
                "to a threshold were certified", total, k)
        self._band_overflow = total > k
        self._refine_band_population = refine_pop
        # the selection budget is shared across every boundary's band
        # (safety + the rk trajectory-identity head) — see _refine_Q's
        # uniform overflow contract
        refine_budget = self._refine_band_k + self._refine_k
        self._refine_band_overflow = refine_pop > refine_budget
        if self._refine_band_overflow:
            logging.warning(
                "interval_precision: %d rows inside the refinement band "
                "exceed the refine budget %d (refine_band_k + refine_k); "
                "un-refined near-boundary rows keep reduced-precision "
                "noise", refine_pop, refine_budget)

        sel = np.flatnonzero(within)
        self._band_population = int(sel.size)
        if sel.size == 0:
            self._certified_corrections = 0
            return result, diag

        beta = float(self.beta(self.t))
        pts = self.inputs[idx[sel]]
        safe64 = np.ones(sel.size, dtype=bool)
        for i, g in enumerate(self.gps):
            if self.fmin[i] == -np.inf:
                continue
            mu, var = g.predict_f64(pts)
            l64 = mu - beta * np.sqrt(var)
            safe64 &= l64 > self.fmin[i]

        flips = int(np.count_nonzero(safe64 != s_f32[sel]))
        self._certified_corrections = flips
        if flips == 0:
            # every f32 verdict confirmed: pass 1 IS the certified step
            return result, diag

        fix_idx = np.where(within, idx, -1).astype(np.int32)
        fix_bits = np.zeros(k, dtype=bool)
        fix_bits[sel] = safe64
        corrected = safeopt_step_from_Q(
            kernels, states, self._grid(), result.Q,
            jnp.asarray(fix_idx), jnp.asarray(fix_bits),
            consts["fmin"],
            jnp.asarray(beta, dtype),
            consts["scaling"],
            consts["threshold"],
            consts["lipschitz"],
            ucb=ucb, use_lipschitz=self._use_lipschitz,
            chunk=self._expander_chunk)
        return corrected, None

    def _certified_step_device(self, kernels, states, ucb: bool):
        """Certified iteration, settled entirely on device.

        Three chained dispatches, ZERO intermediate host pulls:
        ``interval_scan`` (f32 intervals + refinement + band triage,
        NO classification), ``device_oracle`` (float64 verdicts for
        the <=k band rows against each model's ``OracleState`` — the
        same f64 factors the host oracle uses), and
        ``certified_finish`` (classify/expander/select ONCE with the
        settled bits). The host blocks only on the final 9-int
        diagnostics buffer — the same single pull the plain step pays —
        so certification costs the oracle's small f64 compute instead
        of the host protocol's extra round trips + redundant
        re-classification.
        """
        import logging

        import jax as _jax

        dtype = default_dtype()
        k = self._boundary_k
        consts = self._step_consts()
        beta32 = jnp.asarray(self.beta(self.t), dtype)
        Q, packed_t = interval_scan(
            kernels, states, self._grid(), consts["fmin"], beta32,
            consts["scaling"], consts["boundary_band"],
            refine_band=consts["refine_band"], k=k,
            refine_k=self._refine_k,
            refine_band_k=(self._refine_band_k
                           if self._interval_precision is not None else 0),
            interval_precision=self._interval_precision)

        ostates, kinds = [], []
        for g in self.gps:
            st, kind = g.device_oracle_state()
            ostates.append(st)
            kinds.append(kind)
        constrained = tuple(bool(np.isfinite(f))
                            for f in np.atleast_1d(self.fmin))
        with _jax.enable_x64(True):
            fmin64 = jnp.asarray(np.atleast_1d(
                np.asarray(self.fmin, dtype=np.float64)))
            beta64 = jnp.asarray(float(self.beta(self.t)), jnp.float64)
            fix_idx, fix_bits, flips, n_within = device_oracle(
                kernels, tuple(ostates), self._grid(), Q, packed_t,
                fmin64, beta64, kinds=tuple(kinds),
                constrained=constrained, k=k)

        settled, diag9 = certified_finish(
            kernels, states, self._grid(), Q, packed_t, fix_idx,
            fix_bits, flips, n_within, consts["fmin"], beta32,
            consts["scaling"], consts["threshold"], consts["lipschitz"],
            ucb=ucb, use_lipschitz=self._use_lipschitz,
            chunk=self._expander_chunk)

        # the diag9 buffer stays ON DEVICE: the caller (optimize() via
        # its PendingStep, sync or async) pulls it once and feeds it
        # back through _absorb_certified_diag9 for telemetry
        return settled, diag9

    def _absorb_certified_diag9(self, d: np.ndarray) -> None:
        """Record the device-oracle pipeline's telemetry from its
        pulled 9-int diagnostics buffer (warnings + IterationStats
        fields)."""
        import logging

        k = self._boundary_k
        flips_h, total = int(d[5]), int(d[6])
        refine_pop, n_within_h = int(d[7]), int(d[8])
        if total > k:
            logging.warning(
                "exact_boundaries: %d candidates inside the ambiguity "
                "band exceed the triage budget k=%d; only the k closest "
                "to a threshold were certified", total, k)
        self._band_overflow = total > k
        self._refine_band_population = refine_pop
        refine_budget = self._refine_band_k + self._refine_k
        self._refine_band_overflow = refine_pop > refine_budget
        if self._refine_band_overflow:
            logging.warning(
                "interval_precision: %d rows inside the refinement band "
                "exceed the refine budget %d (refine_band_k + refine_k); "
                "un-refined near-boundary rows keep reduced-precision "
                "noise", refine_pop, refine_budget)
        self._band_population = n_within_h
        self._certified_corrections = flips_h

    def _run_step(self, context=_KEEP_CONTEXT, ucb: bool = False):
        """Execute the fused device step and mirror results host-side.

        Returns ``(StepResult, diag or None)``; ``diag`` is the pulled
        [has_safe, next_idx, |S|, |M|, anyG] when the step already paid
        that pull (certified path), sparing the caller a round trip.
        """
        if context is not _KEEP_CONTEXT:
            self.context = context
        kernels, states = self._model_args()
        dtype = default_dtype()
        diag = None
        if self._exact_boundaries:
            result, diag = self._certified_step(kernels, states, ucb)
        else:
            consts = self._step_consts()
            result = safeopt_step(
                kernels, states, self._grid(),
                consts["fmin"],
                jnp.asarray(self.beta(self.t), dtype),
                consts["scaling"],
                consts["threshold"],
                consts["lipschitz"],
                ucb=ucb, use_lipschitz=self._use_lipschitz,
                chunk=self._expander_chunk)
        if ucb and self._dev is not None:
            # ucb never recomputes M/G (reference leaves them stale,
            # gp_opt.py:670-675); pin any unmaterialized mirrors to the
            # *previous* device result before it is replaced, or a later
            # read would resolve against the new all-zero masks.
            self._host_cache["M"] = self._mirror("M")
            self._host_cache["G"] = self._mirror("G")
        self._dev = result
        self._host_cache["Q"] = None
        self._host_cache["S"] = None
        if not ucb:
            self._host_cache["M"] = None
            self._host_cache["G"] = None
        return result, diag

    # -- reference API -------------------------------------------------------

    def update_confidence_intervals(self, context=None) -> None:
        """Recompute Q from the current GP posteriors.

        Like the reference (gp_opt.py:453-476) this refreshes only the
        intervals: S/M/G keep their previous values until
        ``compute_safe_set`` / ``compute_sets`` run.
        """
        S_old = self.S
        M_old, G_old = self.M, self.G
        self._run_step(context=context, ucb=True)
        self._host_cache["S"] = S_old
        self._host_cache["M"] = M_old
        self._host_cache["G"] = G_old

    def compute_safe_set(self) -> None:
        """Recompute only the safe set from current Q."""
        self.S = np.all(self.Q[:, ::2] > self.fmin, axis=1)

    def compute_sets(self, full_sets: bool = False) -> None:
        """Recompute S, M and G from the current GP posteriors.

        ``full_sets=True`` evaluates the expander predicate for every
        safe point (plotting only), reference gp_opt.py:527-555.
        """
        kernels, states = self._model_args()
        dtype = default_dtype()
        if full_sets:
            consts = self._step_consts()
            result = full_expander_sets(
                kernels, states, self._grid(),
                consts["fmin"],
                jnp.asarray(self.beta(self.t), dtype),
                consts["scaling"],
                consts["lipschitz"],
                use_lipschitz=self._use_lipschitz,
                chunk=self._expander_chunk)
        else:
            result, _ = self._run_step(ucb=False)
        self._dev = result
        for name in ("Q", "S", "M", "G"):
            self._host_cache[name] = None

    def get_new_query_point(self, ucb: bool = False) -> np.ndarray:
        """Next evaluation point from the current S/M/G/Q state."""
        if not np.any(self.S):
            raise EnvironmentError("There are no safe points to evaluate.")
        if ucb:
            value = np.where(self.S, self.Q[:, 1], -np.inf)
        else:
            l = self.Q[:, ::2]
            u = self.Q[:, 1::2]
            MG = self.M | self.G
            value = np.where(MG, np.max((u - l) / self.scaling, axis=1),
                             -np.inf)
        x = self.inputs[int(np.argmax(value)), :]
        if self.num_contexts:
            return x[: -self.num_contexts]
        return x

    def optimize(self, context=None, ucb: bool = False) -> np.ndarray:
        """Run one SafeOpt iteration and return the next query point."""
        return self.optimize_async(context=context, ucb=ucb).result()

    def optimize_async(self, context=None, ucb: bool = False, after=None):
        """Dispatch one SafeOpt iteration WITHOUT blocking on its
        diagnostics pull.

        Returns a :class:`PendingSafeOptStep`; ``result()`` blocks on
        the single diagnostics buffer, records the iteration stats,
        and returns the next query point. Unlike the swarm's
        ``optimize_async``, no device-state chaining is needed —
        the grid step's only inter-iteration dependence is the GP
        data, which enters via ``add_new_data_point`` on the host —
        so consecutive dispatches pipeline naturally and
        ``algorithms/pipeline.run_lagged_campaign`` overlaps the
        result pull (and the plant) with the next iteration's device
        compute for lag-1 campaigns. ``after`` is accepted for API
        symmetry with :class:`SafeOptSwarm` and ignored. The
        host-oracle certified path (``oracle='host'``) synchronizes
        internally on its packed-band pull; the plain and
        device-oracle paths are fully asynchronous. Finalize pendings
        in dispatch order (stats and telemetry commit at
        ``result()``).
        """
        import time

        del after
        start = time.perf_counter()
        result, diag = self._run_step(context=context, ucb=ucb)
        return PendingSafeOptStep(self, result, diag, start)

    def _finish_step(self, result, diag, start) -> np.ndarray:
        """Pull the diagnostics, record stats, return the query point
        (the tail of a blocking ``optimize()``)."""
        import time

        from ..utils.observability import IterationStats

        if diag is None:
            # every host-needed scalar rides ONE packed int32 buffer —
            # a single device->host round trip instead of five
            diag = np.asarray(result.diag)
        else:
            diag = np.asarray(diag)              # no-op if already host
        if diag.shape[0] >= 9:
            # device-oracle certified pipeline: telemetry rides the
            # same buffer
            self._absorb_certified_diag9(diag)
            diag = diag[:5]
        has_safe, idx, safe_count, maximizer_count, expander_found = diag
        if not bool(has_safe):
            raise EnvironmentError("There are no safe points to evaluate.")
        idx = int(idx)
        self.stats.record(IterationStats(
            t=self.t, duration_s=time.perf_counter() - start,
            safe_count=int(safe_count),
            maximizer_count=int(maximizer_count),
            expander_found=bool(expander_found),
            next_index=idx, beta=float(self.beta(self.t)),
            band_population=int(self._band_population),
            certified_corrections=int(self._certified_corrections),
            band_overflow=bool(self._band_overflow
                               or self._refine_band_overflow)))
        x = self.inputs[idx, :]
        if self.num_contexts:
            return x[: -self.num_contexts]
        return x

    def get_maximum(self, context=None):
        """Current safe best estimate: argmax of the objective lower bound.

        Returns ``(x, lower_bound)`` or ``None`` when no candidate is
        certified safe (reference gp_opt.py:677-712).
        """
        self.context = context
        kernels, states = self._model_args()
        dtype = default_dtype()
        idx, lb, has_safe, Q, S, diag = safe_maximum(
            kernels, states, self._grid(),
            self._step_consts()["fmin"],
            jnp.asarray(self.beta(self.t), dtype))
        # Q/S are stored as device arrays and pulled only if accessed;
        # the scalars ride the packed diag buffer — ONE round trip
        # (same packed-pull pattern as optimize()). idx-as-float is
        # exact below 2^24 rows in f32; fall back to a second pull on
        # gigantic grids.
        self._set_mirror("Q", Q)
        self._set_mirror("S", S)
        if self.inputs.shape[0] < 2 ** 24 or Q.dtype != jnp.float32:
            d = np.asarray(diag)
            idx, lb, has_safe = int(d[0]), float(d[1]), bool(d[2])
        else:
            idx, lb, has_safe = jax.device_get((idx, lb, has_safe))
            idx, lb, has_safe = int(idx), float(lb), bool(has_safe)
        if not has_safe:
            return None
        x = self.inputs[idx, : -self.num_contexts or None]
        return x, lb
