"""Sparse (inducing-point) GP regression with the same device interface.

Exact GP inference costs O(n^2) per candidate once factored; for long
BO campaigns (thousands of observations) the per-iteration grid cost
grows with the data. The deterministic-training-conditional (DTC /
subset-of-regressors) approximation bounds it by m inducing points:

    Sigma  = (K_ZZ + K_ZX K_XZ / s2)^-1
    mu(z)  = k_zZ alpha,              alpha = Sigma K_ZX y / s2
    var(z) = k(z,z) - k_zZ (K_ZZ^-1 - Sigma) k_Zz

The key trick: ``B = K_ZZ^-1 - Sigma`` is PSD, so with ``B = R^T R``
and ``w = R^-T alpha`` the posterior takes exactly the whitened form
the fused device pipeline consumes —

    V = R @ k(Z, grid);  mu = V^T w;  var = kdiag - colsum(V^2)

— i.e. a ``GPState`` whose "training inputs" are the m inducing points
and whose "triangular inverse" is the pseudo-factor R. Every consumer
(the fused step's interval pass, the expander's rank-1 conditioning,
multi-chip sharding, SafeOpt/SafeOptSwarm) runs unchanged on it. The expander's
virtual-observation update becomes the conditioning of the DTC
posterior process (a principled approximation; exact when Z = X).

All m x m / m x n factor math runs on the host in float64, like the
exact engine (see host_math.py). New capability — the reference (and
GPy as consumed by it) is exact-only.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
import scipy.linalg

from ..config import default_dtype
from .host_math import np_kdiag, np_kernel
from .kernels import Kernel, RBF
from .regression import GPState, _next_capacity

__all__ = ["SparseGPRegression"]


class SparseGPRegression:
    """DTC sparse GP with the `GPRegression` surface.

    Parameters
    ----------
    X, Y : arrays
        Training data (n can be large; cost is O(m^2 n)).
    kernel : Kernel, optional (default RBF)
    noise_var : float
    inducing : int or array (m, d)
        Number of inducing points (selected as a uniform subset of X,
        topped up with jittered copies if n < m) or their locations.
    refit_every : int
        Incremental rank-1 updates between full rebuilds.
    jitter : float
        Diagonal added to ``K_ZZ``. The pseudo-factor's magnitude
        grows with ``K_ZZ``'s condition number, and the DEVICE grid
        pass runs in float32 — a factor with entries in the thousands
        carries interval noise that flips knife-edge safe decisions
        (host-f64 ``predict`` is unaffected). Dense inducing sets
        (m large relative to the lengthscale coverage of the domain)
        may need a larger jitter; a warning fires when the factor
        scale threatens f32 decision fidelity.
    conservative : float
        Safety factor ``c`` on a calibrated posterior-variance floor
        (default 0 = plain DTC). DTC's dangerous failure mode for safe
        BO is OPTIMISTIC drift: near the safety boundary, a small DTC
        mean error in a data-dense region (where the posterior
        variance is tiny) flips an exact-GP-unsafe point to
        DTC-safe. The Nystrom residual is useless there — it is
        already inside the DTC variance (``var_dtc >= r`` always) and
        vanishes exactly where the danger lives. What works is a small
        CONSTANT latent-variance floor sized to the model's own
        mean-convergence error: at every full (re)build the model
        measures ``delta = max_i |mu_m(X_i) - mu_2m(X_i)|`` against a
        doubled-inducing DTC and reports ``var + (c * delta)^2`` —
        lower confidence bounds can only drop, so knife-edge
        optimistic flips are suppressed at the cost of a slightly
        conservative safe set (measured in BENCH_r04
        ``sparse_m_sweep``: optimistic drift 0 at ``c = 1`` on the
        bench configuration, with the step speedup intact). The mean
        is untouched. Implemented as a ``White`` summand on the
        effective kernel (``self.kern``; cross-covariances are
        unaffected, only ``Kdiag`` gains the floor), while the
        data-model kernel stays at ``self.kern_base`` for
        hyperopt/LML. Calibration costs one extra O((2m)^2 n) build
        per full refit and is skipped at ``c = 0``.
    calibration : 'max' or float in (0, 1]
        Statistic of the per-training-point mean-convergence error
        ``|mu_m(X_i) - mu_2m(X_i)|`` the floor is sized to. ``'max'``
        is the worst case — sound but an outlier statistic: one
        sparse-data-region training point with a large (and therefore
        high-variance, already-guarded) error inflates the floor
        everywhere, forfeiting large tracts of the exact safe set as
        conservative drift (47% of the exact safe set at m=64/c=1 on
        the bench configuration). A float q uses the q-quantile
        instead (e.g. ``0.99``), trimming those outliers; the bench
        (m x c x statistic) sweep picks the shipped recommendation by
        *optimistic drift == 0 first, then minimal conservative
        drift* (bench.py ``sparse_m_sweep``).
    """

    def __init__(self, X, Y, kernel: Optional[Kernel] = None,
                 noise_var: float = 1.0, inducing=16,
                 refit_every: int = 512, jitter: float = 1e-8,
                 conservative: float = 0.0, calibration="max"):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        if kernel is None:
            kernel = RBF(X.shape[1])
        self._conservative = float(conservative)
        if self._conservative < 0.0:
            raise ValueError("conservative inflation factor must be >= 0")
        if calibration != "max":
            calibration = float(calibration)
            if not 0.0 < calibration <= 1.0:
                raise ValueError(
                    "calibration must be 'max' or a quantile in (0, 1], "
                    f"got {calibration!r}")
        self._calibration = calibration
        self._floor = 0.0
        self.kern = kernel          # property setter: stores kern_base
        self.noise_var = float(noise_var)

        if np.isscalar(inducing):
            m = int(inducing)
            idx = np.linspace(0, X.shape[0] - 1, min(m, X.shape[0]),
                              dtype=int)
            Z = X[idx]
            if Z.shape[0] < m:   # top up with jittered copies
                rng = np.random.default_rng(0)
                extra = Z[rng.integers(0, Z.shape[0], m - Z.shape[0])]
                Z = np.vstack([Z, extra + 1e-3 * rng.normal(
                    size=extra.shape)])
        else:
            Z = np.atleast_2d(np.asarray(inducing, dtype=np.float64))
        self.Z = Z
        self._m = Z.shape[0]
        self._cap = _next_capacity(self._m)
        # Incremental hygiene: rank-1 updates of A accumulate only
        # rounding-level drift in f64, but a periodic full rebuild
        # keeps long campaigns bit-honest.
        self._refit_every = int(refit_every)
        self._jitter = float(jitter)
        self._pending = 0

        self._X = X
        self._Y = Y
        self._refit()

    # -- kernel views -------------------------------------------------------
    #
    # The DATA MODEL (information state A/b, marginal likelihood,
    # hyperparameter fitting) always uses ``kern_base``. The POSTERIOR
    # consumers (device state, predict*, posterior samples) use
    # ``kern`` — identical to the base unless ``conservative > 0``, in
    # which case it is the base scaled by ``s = 1 + c^2`` (a Product
    # with a constant Bias factor) and the pseudo-factor/weights are
    # rescaled so that mu is unchanged and var gains ``c^2 * r(x)``.

    @property
    def kern(self) -> Kernel:
        """Kernel the posterior consumers see (a ``White``-floor sum
        when ``conservative > 0``)."""
        return self._kern_eff

    @kern.setter
    def kern(self, kernel: Kernel) -> None:
        self._kern_base = kernel
        if self._conservative and self._floor > 0.0:
            from .kernels import White
            self._kern_eff = kernel + White(kernel.input_dim,
                                            variance=self._floor,
                                            name="safety_floor")
        else:
            self._kern_eff = kernel

    def _calibrate_floor(self) -> None:
        """Size the conservative variance floor to the model's own
        mean-convergence error: ``delta = max_i |mu_m(X_i) -
        mu_2m(X_i)|`` against a doubled-inducing DTC on the SAME data,
        ``floor = (c * delta)^2``. One extra O((2m)^2 n) build; the
        danger it guards against — knife-edge optimistic flips from
        DTC mean error in data-dense regions — scales with exactly
        this quantity."""
        self._floor = 0.0
        self.kern = self._kern_base        # plain view for the probe
        if not self._conservative or self._X.shape[0] <= self._m:
            return
        m2 = min(2 * self._m, self._X.shape[0])
        ref = SparseGPRegression(self._X, self._Y, self._kern_base,
                                 noise_var=self.noise_var, inducing=m2,
                                 jitter=self._jitter)
        mu_m, _ = self.predict_f64(self._X)
        mu_2m, _ = ref.predict_f64(self._X)
        err = np.abs(mu_m - mu_2m)
        if self._calibration == "max":
            delta = float(np.max(err))
        else:
            delta = float(np.quantile(err, self._calibration))
        self._floor = (self._conservative * delta) ** 2
        self.kern = self._kern_base        # rebuild the floored view

    @property
    def kern_base(self) -> Kernel:
        """The data-model kernel (hyperopt/LML target; == ``kern``
        unless ``conservative > 0``)."""
        return self._kern_base

    @property
    def conservative(self) -> float:
        """Safety inflation factor c (0 = plain DTC)."""
        return self._conservative

    @property
    def calibration(self):
        """Floor calibration statistic: 'max' or a quantile in (0, 1]."""
        return self._calibration

    # -- factor construction (host float64) --------------------------------

    def _refit(self) -> None:
        """Full O(m^2 n) rebuild of the DTC information state.

        Maintained incrementally thereafter: ``A = K_ZZ + K_ZX K_XZ /
        s2`` and ``b = K_ZX y`` are SUMS over observations, so an
        append/remove is a rank-1 update (``_apply_rank1``) and only
        the O(m^3) posterior tail reruns per point — the per-iteration
        model update of a long campaign no longer touches all n
        observations (VERDICT r2 weak #6).
        """
        Z, X, Y = self.Z, self._X, self._Y
        m = Z.shape[0]
        s2 = self.noise_var

        self._Kzz = np_kernel(self._kern_base, Z) + self._jitter * np.eye(m)
        self._Kzz_cho = scipy.linalg.cho_factor(self._Kzz, lower=True)
        Kzx = np_kernel(self._kern_base, Z, X)
        self._A = self._Kzz + (Kzx @ Kzx.T) / s2
        self._b = Kzx @ Y[:, 0]
        self._pending = 0
        self._recompute_posterior()
        self._calibrate_floor()

    def _apply_rank1(self, x: np.ndarray, y: float, sign: float) -> None:
        """O(m^2) information update for one observation (+1 append,
        -1 remove); exact up to float non-associativity because A and b
        are plain sums of per-observation terms."""
        kzx = np_kernel(self._kern_base, self.Z, x.reshape(1, -1))[:, 0]
        self._A += sign * np.outer(kzx, kzx) / self.noise_var
        self._b += sign * kzx * y
        self._pending += 1
        if self._pending >= self._refit_every:
            self._refit()
        else:
            self._recompute_posterior()

    def _recompute_posterior(self) -> None:
        """O(m^3) tail: whitened pseudo-factor state from (A, b)."""
        m = self._m
        A_cho = scipy.linalg.cho_factor(self._A, lower=True)
        alpha = scipy.linalg.cho_solve(A_cho, self._b) / self.noise_var
        sigma = scipy.linalg.cho_solve(A_cho, np.eye(m))
        kzz_inv = scipy.linalg.cho_solve(self._Kzz_cho, np.eye(m))

        B = kzz_inv - sigma
        # B is PSD up to rounding; factor its symmetrized, floored form.
        B = 0.5 * (B + B.T)
        evals, evecs = np.linalg.eigh(B)
        evals = np.maximum(evals, 0.0)
        R0 = (evecs * np.sqrt(evals)) @ evecs.T       # symmetric sqrt
        # The GPState contract requires a LOWER-TRIANGULAR pseudo-factor
        # (Linv, like the exact model's inverse Cholesky factor). Any
        # R with R^T R = B preserves the posterior (var = kdiag -
        # k^T B k), so take the QL decomposition of the symmetric root:
        # R0 = Q L  =>  L^T L = R0^T R0 = B, with L lower-triangular.
        # (QL via flipped QR: P (P R0 P) P with P the index reversal.)
        r_flip = np.linalg.qr(R0[::-1, ::-1])[1]
        R = r_flip[::-1, ::-1]                        # lower-triangular
        scale = float(np.abs(R).max())
        if scale > 1e4 and not getattr(self, "_factor_scale_warned", False):
            # once per model: this runs on EVERY incremental append, and
            # the interpolated scale defeats the warning registry's
            # message dedup — a long campaign would emit thousands
            self._factor_scale_warned = True
            import warnings
            warnings.warn(
                f"sparse pseudo-factor max entry {scale:.3g}: K_ZZ is "
                "ill-conditioned enough that float32 device intervals "
                "will carry material noise (host-f64 predict is "
                "unaffected). Raise `jitter` or reduce the inducing "
                "density.", RuntimeWarning, stacklevel=3)
        # w solves R^T w = alpha in the least-squares sense (R may be
        # singular when Sigma -> Kzz^-1, i.e. no data): mu = k^T alpha
        # must be preserved exactly, so keep alpha and solve via pinv.
        w = np.linalg.pinv(R.T, rcond=1e-12) @ alpha

        cap = self._cap
        Xp = np.zeros((cap, self.Z.shape[1]))
        Xp[:m] = self.Z
        Rp = np.eye(cap)
        Rp[:m, :m] = R
        wp = np.zeros(cap)
        wp[:m] = w
        Yp = np.zeros((cap, 1))

        self._alpha = alpha
        self._R = R                     # host f64 pseudo-factor (m, m)
        self._oracle_cache = None       # f64 device mirror now stale
        dtype = default_dtype()
        self._state = GPState(
            X=jnp.asarray(Xp, dtype), Y=jnp.asarray(Yp, dtype),
            count=jnp.asarray(m, jnp.int32),
            L=jnp.asarray(Rp, dtype), Linv=jnp.asarray(Rp, dtype),
            w=jnp.asarray(wp, dtype),
            noise_var=jnp.asarray(self.noise_var, dtype))

    # -- GPRegression-compatible surface ------------------------------------

    @property
    def state(self) -> GPState:
        """Pseudo-factor GPState (inducing rows) for the device path."""
        return self._state

    @property
    def num_data(self) -> int:
        """Observation count n (can far exceed the inducing count)."""
        return self._X.shape[0]

    @property
    def num_inducing(self) -> int:
        """Inducing-point count m (bounds per-iteration cost)."""
        return self._m

    @property
    def X(self):
        """Training inputs (host float64, all n rows)."""
        return self._X

    @property
    def Y(self):
        """Training targets (host float64, all n rows)."""
        return self._Y

    # already host numpy; aliases keep the GPRegression surface uniform
    X_host = X
    Y_host = Y

    @property
    def input_dim(self) -> int:
        """Input dimensionality d."""
        return self._X.shape[1]

    def predict_noiseless(self, Xq):
        """DTC latent posterior (mean, var), each (q, 1) for q query rows.

        Host float64 throughout: the pseudo-factor is the f64 ``_R``,
        not the (session-dtype) device state's — in a float32 session
        the two differ and this method's exactness contract
        "host-f64 predict is always exact for the model") depends on
        the f64 one.
        """
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        kz = np_kernel(self.kern, self.Z, Xq)             # (m, q)
        mu = kz.T @ self._alpha
        V = self._R @ kz
        var = np_kdiag(self.kern, Xq) - np.sum(V * V, axis=0)
        return mu[:, None], np.maximum(var, 0.0)[:, None]

    _raw_predict = predict_noiseless

    def device_oracle_state(self):
        """``(OracleState, 'sparse')`` — float64 device mirror of the
        DTC host oracle (``predict_f64``: ``mu = k^T alpha``,
        ``V = R k``), for on-device knife-edge certification. Exact
        FOR THE DTC MODEL, like the host oracle."""
        if getattr(self, "_oracle_cache", None) is None:
            import jax

            from .regression import OracleState
            m, cap = self._m, self._cap
            with jax.enable_x64(True):
                Xp = np.zeros((cap, self.Z.shape[1]))
                Xp[:m] = self.Z
                Fp = np.eye(cap)
                Fp[:m, :m] = self._R
                ap = np.zeros(cap)
                ap[:m] = self._alpha
                self._oracle_cache = OracleState(
                    X=jnp.asarray(Xp, jnp.float64),
                    F=jnp.asarray(Fp, jnp.float64),
                    w=jnp.zeros((cap,), jnp.float64),
                    alpha=jnp.asarray(ap, jnp.float64),
                    count=jnp.asarray(m, jnp.int32))
        return self._oracle_cache, "sparse"

    def predict_f64(self, Xq):
        """Float64 DTC latent posterior (mu, var), each 1-D of length q
        (the number of query rows — not the inducing count ``m``).

        The exactness oracle consumed by boundary certification
        (``SafeOpt(exact_boundaries=True)``).  "Exact" here means exact
        FOR THE DTC MODEL: the certified decision is the one the host
        f64 sparse posterior makes, so the float32 noise of the device
        pseudo-factor (see ``SafeOpt``'s ``boundary_band``) never flips
        a knife-edge safe bit — approximation error vs the exact GP is a
        separate, m-controlled quantity.
        """
        mu, var = self.predict_noiseless(Xq)
        return mu.ravel(), var.ravel()

    def predict(self, Xq, include_likelihood: bool = True):
        """DTC posterior (mean, var); variance includes the
        observation noise unless ``include_likelihood=False`` (GPy
        ``gp.predict`` semantics)."""
        mu, var = self.predict_noiseless(Xq)
        if include_likelihood:
            var = var + self.noise_var
        return mu, var

    def log_likelihood(self) -> float:
        """DTC log marginal likelihood at the current hyperparameters
        (host float64, Woodbury identity — see
        hyperopt.sparse_log_marginal_likelihood)."""
        import jax

        from .hyperopt import sparse_log_marginal_likelihood

        with jax.enable_x64(True):
            return float(sparse_log_marginal_likelihood(
                self._kern_base, self._X, self._Y, self.Z,
                self.noise_var))

    def posterior_samples_f(self, Xq, size: int = 1, key=None):
        """Joint latent samples from the DTC posterior process at
        ``Xq`` (GPy ``posterior_samples_f`` shape (q, 1, size) for q
        query rows);
        float64 host covariance through the pseudo-factor R."""
        import jax
        import numpy as _np

        Xq = _np.atleast_2d(_np.asarray(Xq, dtype=_np.float64))
        kz = np_kernel(self.kern, self.Z, Xq)          # (m, q)
        mu = kz.T @ self._alpha
        V = self._R @ kz
        cov = (np_kernel(self.kern, Xq) - V.T @ V
               + 1e-10 * _np.eye(Xq.shape[0]))
        evals, evecs = _np.linalg.eigh(0.5 * (cov + cov.T))
        root = evecs * _np.sqrt(_np.maximum(evals, 0.0))
        if key is None:
            key = jax.random.key(0)
        eps = _np.asarray(jax.random.normal(key,
                                            (cov.shape[0], int(size))),
                          dtype=_np.float64)
        draws = mu[:, None] + root @ eps
        return draws[:, None, :]

    def append_data(self, x, y) -> None:
        """O(m^2 + m^3) incremental append (no pass over the n rows)."""
        x = np.asarray(x, dtype=np.float64).reshape(1, -1)
        self._X = np.vstack([self._X, x])
        self._Y = np.vstack([self._Y, [[float(y)]]])
        self._apply_rank1(x[0], float(y), +1.0)

    def pop_data(self) -> None:
        """O(m^2 + m^3) incremental remove-last (exact rank-1 downdate:
        the subtracted outer product is bit-identical to the added one)."""
        x = self._X[-1]
        y = float(self._Y[-1, 0])
        self._X = self._X[:-1]
        self._Y = self._Y[:-1]
        self._apply_rank1(x, y, -1.0)

    def set_XY(self, X, Y) -> None:
        """Replace the training set; pure appends/truncates of the
        current data ride the incremental rank-1 path (mirroring
        GPRegression.set_XY), anything else is a full rebuild."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        n_old = self._X.shape[0]
        n_new = X.shape[0]
        if X.shape[1] == self._X.shape[1]:
            if (n_new > n_old
                    and np.array_equal(X[:n_old], self._X)
                    and np.array_equal(Y[:n_old], self._Y)):
                for i in range(n_old, n_new):
                    self.append_data(X[i], Y[i, 0])
                return
            if (n_new < n_old
                    and np.array_equal(X, self._X[:n_new])
                    and np.array_equal(Y, self._Y[:n_new])):
                for _ in range(n_old - n_new):
                    self.pop_data()
                return
        self._X = X.copy()
        self._Y = Y.copy()
        self._refit()

    def refit(self) -> None:
        """Full O(m^2 n) rebuild (numerical hygiene escape hatch)."""
        self._refit()

    def optimize_hyperparameters(self, steps: int = 200,
                                 learning_rate: float = 0.05,
                                 optimize_noise: bool = True,
                                 restarts: int = 0,
                                 seed: int = 0,
                                 optimize_inducing: bool = False
                                 ) -> float:
        """Fit kernel hyperparameters (and optionally the noise) by
        maximizing the DTC marginal likelihood (O(m^2 n) per gradient
        step via hyperopt.sparse_log_marginal_likelihood), with the
        same log-space Adam + vmapped-restarts machinery as the exact
        engine. ``optimize_inducing=True`` additionally moves the
        inducing locations Z along the LML gradient (GPy's sparse
        ``optimize()`` treats Z as a model parameter); restarts
        perturb only the hyperparameters. Returns the best LML.
        """
        from .hyperopt import (fit_hyperparameters,
                               sparse_log_marginal_likelihood)

        X, Y, Z = self._X, self._Y, self.Z

        if optimize_inducing:
            def lml_fn_z(kern, nv, Zv):
                return sparse_log_marginal_likelihood(kern, X, Y, Zv, nv)

            kern, noise, Z_new, lml = fit_hyperparameters(
                self._kern_base, X, Y, self.noise_var, steps=steps,
                learning_rate=learning_rate,
                optimize_noise=optimize_noise, restarts=restarts,
                seed=seed, lml_fn=lml_fn_z, inducing=Z)
            self.Z = np.atleast_2d(np.asarray(Z_new, dtype=np.float64))
        else:
            def lml_fn(kern, nv):
                return sparse_log_marginal_likelihood(kern, X, Y, Z, nv)

            kern, noise, lml = fit_hyperparameters(
                self._kern_base, X, Y, self.noise_var, steps=steps,
                learning_rate=learning_rate,
                optimize_noise=optimize_noise, restarts=restarts,
                seed=seed, lml_fn=lml_fn)
        self.kern = kern
        self.noise_var = float(noise)
        self._refit()
        return lml

    def optimize(self, max_iters: int = 200,
                 optimize_inducing: bool = True,
                 **_gpy_compat) -> float:
        """GPy-compatible spelling of sparse model fitting.

        Like GPy's sparse ``optimize()``, the inducing locations move
        by default (Z is a model parameter there; only ``Z.fix()``
        freezes it) — pass ``optimize_inducing=False`` for the
        frozen-Z fit.
        """
        return self.optimize_hyperparameters(
            steps=max_iters, optimize_inducing=optimize_inducing)

    def optimize_restarts(self, num_restarts: int = 5,
                          max_iters: int = 200, seed: int = 0,
                          optimize_inducing: bool = True,
                          **_gpy_compat) -> float:
        """GPy-compatible multi-start fitting (best finite LML wins);
        inducing locations move by default, as in GPy (restarts
        perturb only the hyperparameters)."""
        return self.optimize_hyperparameters(
            steps=max_iters, restarts=num_restarts, seed=seed,
            optimize_inducing=optimize_inducing)

    def __repr__(self):
        return (f"SparseGPRegression(n={self.num_data}, "
                f"m={self.num_inducing}, kern={self.kern!r})")
