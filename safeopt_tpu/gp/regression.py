"""Accelerator-native exact GP regression (the in-repo replacement for GPy).

The reference delegates all GP inference to the external GPy library;
the exact API surface it consumes is small and closed (SURVEY.md
section 2.8): ``GPRegression(X, Y, kernel, noise_var)``, ``gp.X``,
``gp.Y``, ``gp.set_XY``, ``gp.predict_noiseless``, ``gp._raw_predict``,
``gp.input_dim`` and ``gp.kern``. This module implements that contract
as a pure-functional JAX core plus a thin stateful wrapper.

Design (Accelerator-first):

* **Padded fixed-shape buffers.** Training data lives in ``(capacity,
  d)`` buffers with an active-row ``count``, so every jitted function
  compiles once per capacity instead of once per data size.

* **Masked Cholesky.** The factor ``L`` is the Cholesky of a matrix that
  equals ``K + sigma^2 I`` on the active block and the identity on
  padded rows/cols. Because that matrix is block diagonal, the factor of
  the padded system is exactly ``blockdiag(chol(K_active + s2 I), I)`` —
  padded rows never contaminate active results as long as query
  cross-covariances are masked to zero on padded rows.

* **Append is a Cholesky *extension*, not a refit.** The reference's
  data access pattern is append-one / remove-last via ``set_XY``
  (/root/reference/safeopt/gp_opt.py:227-228,267) which triggers a full
  GPy refit each time. Appending a row to a Cholesky factor is the exact
  O(n^2) bordering step ``c = L^{-1} k_new``, ``dd = sqrt(k(x,x) + s2 -
  c.c)``; removing the last row is a truncation. No downdates are ever
  needed, so the fast path is exact (it is literally the last step of a
  blocked factorization).

* **Explicit triangular inverse.** ``Linv = L^{-1}`` is maintained so
  large-batch posteriors are pure matmuls: ``V = Linv @ Kxz``,
  ``mu = V^T w``, ``var = kdiag - sum(V^2)`` with whitened targets
  ``w = L^{-1} y``. ``Linv`` also has an exact O(n^2) bordering update.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import default_dtype, with_matmul_precision
from .kernels import Kernel, RBF

__all__ = ["GPState", "GPRegression", "gp_fit", "gp_append", "gp_pop",
           "gp_predict", "predict_from_factors"]


class GPState(NamedTuple):
    """Immutable GP posterior state (a pytree of fixed-shape arrays)."""

    X: jnp.ndarray        # (cap, d) padded training inputs
    Y: jnp.ndarray        # (cap, 1) padded training targets
    count: jnp.ndarray    # () int32 — number of active rows
    L: jnp.ndarray        # (cap, cap) masked lower Cholesky factor
    Linv: jnp.ndarray     # (cap, cap) lower-triangular inverse of L
    w: jnp.ndarray        # (cap,) whitened targets L^{-1} y (masked)
    noise_var: jnp.ndarray  # () observation noise variance

    @property
    def capacity(self) -> int:
        """Padded buffer size (compilation-stable row count)."""
        return self.X.shape[0]

    @property
    def input_dim(self) -> int:
        """Input dimensionality d."""
        return self.X.shape[1]


class OracleState(NamedTuple):
    """Float64 device mirror of a model's HOST exactness oracle.

    Carries exactly the f64 factors ``predict_f64`` uses, so the
    device can settle knife-edge safe-set decisions at full precision
    without a host round trip (``safe_opt_core.device_oracle``):
    operands are bit-identical to the host oracle's, only the
    accumulation order differs (XLA f64 emulation vs BLAS), so
    decisions agree except on ~1e-15-relative knife edges (asserted on
    hardware by bench.py ``cap512_device_oracle_match``). Create the
    arrays under ``jax.enable_x64(True)`` — a float32 session would
    silently downcast them otherwise.
    """

    X: jnp.ndarray        # (cap, d) f64 data rows (inducing rows: sparse)
    F: jnp.ndarray        # (cap, cap) f64 factor; V = F @ k(X, q)
    w: jnp.ndarray        # (cap,) f64 whitened weights (exact: mu = V^T w)
    alpha: jnp.ndarray    # (cap,) f64 direct weights (sparse: mu = k^T a)
    count: jnp.ndarray    # () int32 active rows

    @property
    def capacity(self) -> int:
        """Padded buffer size."""
        return self.X.shape[0]


def _row_mask(cap: int, count: jnp.ndarray, dtype) -> jnp.ndarray:
    return (jnp.arange(cap) < count).astype(dtype)


@jax.jit
@with_matmul_precision
def gp_fit(kernel: Kernel, X: jnp.ndarray, Y: jnp.ndarray,
           count: jnp.ndarray, noise_var: jnp.ndarray) -> GPState:
    """Factorize from scratch over padded buffers.

    ``X`` is (cap, d), ``Y`` is (cap, 1); rows at index >= count are
    ignored (the masked gram is the identity there).
    """
    cap = X.shape[0]
    dtype = X.dtype
    mask = _row_mask(cap, count, dtype)
    mm = mask[:, None] * mask[None, :]

    K = kernel.K(X)
    eye = jnp.eye(cap, dtype=dtype)
    # Active block: K + noise * I. Padded block: identity.
    Kmasked = K * mm + eye * jnp.where(
        jnp.arange(cap) < count, noise_var, 1.0
    )
    L = jnp.linalg.cholesky(Kmasked)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    w = Linv @ (Y[:, 0] * mask)
    return GPState(X=X, Y=Y, count=jnp.asarray(count, jnp.int32), L=L,
                   Linv=Linv, w=w, noise_var=jnp.asarray(noise_var, dtype))


@jax.jit
@with_matmul_precision
def gp_append(kernel: Kernel, state: GPState, x: jnp.ndarray,
              y: jnp.ndarray) -> GPState:
    """Exact O(n^2) Cholesky bordering append of one observation.

    Equivalent to the reference's append-via-``set_XY`` full refit
    (/root/reference/safeopt/gp_opt.py:227-228) but without the O(n^3)
    recompute.
    """
    cap = state.capacity
    dtype = state.X.dtype
    pos = state.count
    mask = _row_mask(cap, pos, dtype)
    x = jnp.asarray(x, dtype).reshape(1, -1)
    y = jnp.asarray(y, dtype).reshape(())

    kvec = kernel.K(state.X, x)[:, 0] * mask          # (cap,)
    kxx = kernel.Kdiag(x)[0]
    c = state.Linv @ kvec                              # (cap,) zero beyond pos
    dd2 = kxx + state.noise_var - jnp.dot(c, c)
    dd = jnp.sqrt(jnp.maximum(dd2, 1e-30))

    onehot = (jnp.arange(cap) == pos).astype(dtype)

    # New factor row: [c^T, dd] at index pos (c is zero at/after pos).
    Lrow = c + dd * onehot
    L = jax.lax.dynamic_update_index_in_dim(state.L, Lrow, pos, axis=0)

    # Bordered inverse: row = -(c^T Linv)/dd, diagonal 1/dd.
    linv_row = -(state.Linv.T @ c) / dd + (1.0 / dd) * onehot
    Linv = jax.lax.dynamic_update_index_in_dim(state.Linv, linv_row, pos,
                                               axis=0)

    mu_x = jnp.dot(c, state.w)
    w = state.w + ((y - mu_x) / dd) * onehot

    X = jax.lax.dynamic_update_index_in_dim(state.X, x[0], pos, axis=0)
    Y = jax.lax.dynamic_update_index_in_dim(
        state.Y, y.reshape(1), pos, axis=0)
    return GPState(X=X, Y=Y, count=pos + 1, L=L, Linv=Linv, w=w,
                   noise_var=state.noise_var)


@jax.jit
def gp_pop(state: GPState) -> GPState:
    """Remove the last observation (exact: truncate the factor).

    The leading principal block of a Cholesky factor is the factor of
    the leading principal submatrix, so removal is a count decrement
    plus restoring the vacated row to the padded-identity convention.
    """
    cap = state.capacity
    dtype = state.X.dtype
    pos = state.count - 1
    onehot_row = (jnp.arange(cap) == pos).astype(dtype)
    L = jax.lax.dynamic_update_index_in_dim(state.L, onehot_row, pos, axis=0)
    Linv = jax.lax.dynamic_update_index_in_dim(state.Linv, onehot_row, pos,
                                               axis=0)
    w = state.w * (1.0 - onehot_row)
    return GPState(X=state.X, Y=state.Y, count=pos, L=L, Linv=Linv, w=w,
                   noise_var=state.noise_var)


def predict_from_factors(kernel: Kernel, X: jnp.ndarray, mask: jnp.ndarray,
                         Linv: jnp.ndarray, w: jnp.ndarray,
                         Xq: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Latent posterior (mu, var) at ``Xq`` given whitened factors.

    Pure matmul formulation :
    ``V = Linv @ (k(X, Xq) * mask)``; ``mu = V^T w``;
    ``var = kdiag(Xq) - sum_i V_i^2``. Matches GPy's
    ``predict_noiseless`` semantics: no likelihood noise in ``var``
    (/root/reference/safeopt/gp_opt.py:469).
    """
    kvec = kernel.K(X, Xq) * mask[:, None]            # (cap, m)
    V = Linv @ kvec                                    # (cap, m)
    mu = V.T @ w                                       # (m,)
    var = kernel.Kdiag(Xq) - jnp.sum(V * V, axis=0)
    return mu, jnp.maximum(var, 0.0)


@jax.jit
@with_matmul_precision
def gp_predict(kernel: Kernel, state: GPState,
               Xq: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Latent (noiseless) posterior mean/variance at query batch Xq."""
    mask = _row_mask(state.capacity, state.count, state.X.dtype)
    return predict_from_factors(kernel, state.X, mask, state.Linv, state.w,
                                jnp.atleast_2d(Xq))


@jax.jit
def _device_row_update(state: GPState, i, x_row, y_row, l_row, linv_row,
                       w_val, new_count) -> GPState:
    """Scatter one bordered-update row into the device state.

    One tiny dispatch + ~KB of transfers instead of re-shipping the
    O(cap^2) factors per observation (GPRegression._sync_row)."""
    return GPState(
        X=jax.lax.dynamic_update_index_in_dim(state.X, x_row, i, 0),
        Y=jax.lax.dynamic_update_index_in_dim(state.Y, y_row, i, 0),
        count=new_count,
        L=jax.lax.dynamic_update_index_in_dim(state.L, l_row, i, 0),
        Linv=jax.lax.dynamic_update_index_in_dim(state.Linv, linv_row,
                                                 i, 0),
        w=state.w.at[i].set(w_val),
        noise_var=state.noise_var)


@jax.jit
def _oracle_row_update(cache, i, x_row, linv_row, w_val, new_count):
    """Row-scatter for the float64 oracle mirror (same contract as
    ``_device_row_update``; alpha is the sparse-model slot and stays
    zero for the exact engine)."""
    return OracleState(
        X=jax.lax.dynamic_update_index_in_dim(cache.X, x_row, i, 0),
        F=jax.lax.dynamic_update_index_in_dim(cache.F, linv_row, i, 0),
        w=cache.w.at[i].set(w_val),
        alpha=cache.alpha,
        count=new_count)


def _next_capacity(n: int, minimum: int = 64) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class GPRegression:
    """Exact GP regression with a GPy-compatible surface.

    Drop-in for the subset of ``GPy.models.GPRegression`` the reference
    consumes (SURVEY.md section 2.8). The heavy math lives in the jitted
    pure functions above; this wrapper only manages capacity growth and
    fast-path detection for ``set_XY``.

    Parameters
    ----------
    X : array (n, d)
        Initial training inputs.
    Y : array (n, 1)
        Initial training targets.
    kernel : Kernel, optional
        Covariance kernel; defaults to ``RBF(d)`` like GPy.
    noise_var : float
        Gaussian observation noise variance (GPy default 1.0).
    capacity : int, optional
        Initial padded buffer size; grows automatically (x2 refit).
    """

    def __init__(self, X, Y, kernel: Optional[Kernel] = None,
                 noise_var: float = 1.0, capacity: Optional[int] = None):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        if Y.shape[1] != 1:
            raise ValueError("Y must have exactly one column")
        if kernel is None:
            kernel = RBF(X.shape[1])
        self.kern = kernel
        n, d = X.shape
        cap = capacity if capacity is not None else _next_capacity(n + 1)

        # Float64 island: the O(n^2) factor state is maintained on the
        # host in f64 (see host_math.py) — an f32 Cholesky of an
        # ill-conditioned gram silently destroys the posterior. The
        # device state is a cast copy feeding the O(N) grid work.
        from .host_math import HostFactor
        self._host = HostFactor(self.kern, cap, d, float(noise_var))
        self._host.set_data(X, Y)
        self._state = self._device_state()

    # -- construction helpers --------------------------------------------
    def _device_state(self) -> GPState:
        # copy=True: the host factor mutates X/L/Linv/w IN PLACE on
        # every append/pop, and on CPU backends a dtype-matching
        # ``jnp.asarray`` aliases the numpy memory zero-copy — an
        # in-flight async dispatch (pipelined campaigns,
        # algorithms/pipeline.py) would then read half-mutated factors
        # (observed: flaky trajectory divergence, round 5). The copy
        # severs the alias; on accelerators the dtype cast copied
        # anyway, so this costs nothing there.
        dtype = default_dtype()
        h = self._host
        self._oracle_cache = None        # f64 mirror is now stale
        return GPState(
            X=jnp.array(h.X, dtype, copy=True),
            Y=jnp.array(h.Y, dtype, copy=True),
            count=jnp.asarray(int(h.count), jnp.int32),
            L=jnp.array(h.L, dtype, copy=True),
            Linv=jnp.array(h.Linv, dtype, copy=True),
            w=jnp.array(h.w, dtype, copy=True),
            noise_var=jnp.asarray(float(h.noise_var), dtype),
        )

    def _sync_row(self, pos: int) -> None:
        """Propagate ONE bordered-update row to the device mirrors.

        A Cholesky border (append) or truncation (pop) changes exactly
        row ``pos`` of L/Linv plus X/Y/w entries; re-shipping the full
        O(cap^2) factors per observation moves ~2 MB per iteration at
        cap=512. Ship the one row and
        scatter it in on device — BIT-identical to a full rebuild
        because untouched device rows were cast from the same
        (unchanged) host values. Rows are copied out of the host
        factor before shipping (never alias its in-place-mutated
        memory; see _device_state). The f64 oracle mirror gets the
        same treatment when it exists; otherwise it stays lazily
        rebuilt.
        """
        h = self._host
        dtype = default_dtype()
        st = self._state
        i = jnp.asarray(pos, jnp.int32)
        self._state = _device_row_update(
            st, i,
            jnp.asarray(np.array(h.X[pos]), dtype),
            jnp.asarray(np.array(h.Y[pos]), dtype),
            jnp.asarray(np.array(h.L[pos]), dtype),
            jnp.asarray(np.array(h.Linv[pos]), dtype),
            jnp.asarray(float(h.w[pos]), dtype),
            jnp.asarray(int(h.count), jnp.int32))
        cache = getattr(self, "_oracle_cache", None)
        if cache is not None:
            with jax.enable_x64(True):
                self._oracle_cache = _oracle_row_update(
                    cache, i,
                    jnp.asarray(np.array(h.X[pos]), jnp.float64),
                    jnp.asarray(np.array(h.Linv[pos]), jnp.float64),
                    jnp.asarray(float(h.w[pos]), jnp.float64),
                    jnp.asarray(int(h.count), jnp.int32))

    def device_oracle_state(self):
        """``(OracleState, 'exact')`` — the float64 device mirror of
        this model's host oracle (``predict_f64``), for on-device
        knife-edge certification (``SafeOpt(oracle='device')``).
        Same operands as the host oracle (the f64 factor), shipped
        lazily, re-shipped in full only after a REBUILD — per-
        observation updates scatter one row (``_sync_row``)."""
        if getattr(self, "_oracle_cache", None) is None:
            h = self._host
            with jax.enable_x64(True):
                self._oracle_cache = OracleState(
                    X=jnp.array(h.X, jnp.float64, copy=True),
                    F=jnp.array(h.Linv, jnp.float64, copy=True),
                    w=jnp.array(h.w, jnp.float64, copy=True),
                    alpha=jnp.zeros((h.X.shape[0],), jnp.float64),
                    count=jnp.asarray(int(h.count), jnp.int32))
        return self._oracle_cache, "exact"

    # -- GPy API surface ---------------------------------------------------
    @property
    def state(self) -> GPState:
        """Device posterior state pytree feeding the jitted pipeline."""
        return self._state

    @property
    def num_data(self) -> int:
        """Active observation count (host-side: reading the device
        scalar would cost a full round trip per access on remote
        accelerators)."""
        return int(self._host.count)

    @property
    def X(self) -> jnp.ndarray:
        """Training inputs (device array, GPy ``gp.X``)."""
        return self._state.X[: self.num_data]

    @property
    def Y(self) -> jnp.ndarray:
        """Training targets (device array, GPy ``gp.Y``)."""
        return self._state.Y[: self.num_data]

    @property
    def X_host(self) -> np.ndarray:
        """Training inputs as host float64 (no device round trip)."""
        return self._host.X[: self.num_data]

    @property
    def Y_host(self) -> np.ndarray:
        """Training targets as host float64 (no device round trip)."""
        return self._host.Y[: self.num_data]

    @property
    def input_dim(self) -> int:
        """Input dimensionality d (GPy ``gp.input_dim``)."""
        return self._state.input_dim

    @property
    def noise_var(self) -> float:
        """Gaussian observation-noise variance."""
        return float(self._state.noise_var)

    def predict_noiseless(self, Xq) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Latent posterior (mean, var), each (m, 1) — GPy convention."""
        mu, var = gp_predict(self.kern, self._state, jnp.atleast_2d(Xq))
        return mu[:, None], var[:, None]

    # GPy's plotting path uses the private ``_raw_predict``
    # (/root/reference/safeopt/utilities.py:203,282,355) which for a
    # Gaussian likelihood equals predict_noiseless.
    _raw_predict = predict_noiseless

    def predict(self, Xq, include_likelihood: bool = True
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Posterior (mean, var) at Xq, GPy ``gp.predict`` semantics:
        the variance INCLUDES the observation-noise variance (set
        ``include_likelihood=False`` for the latent posterior).

        Beyond the reference's consumed surface (it only calls
        ``predict_noiseless``, gp_opt.py:469); provided for GPy users
        who predict observations rather than latent values.
        """
        mu, var = self.predict_noiseless(Xq)
        if include_likelihood:
            var = var + self._state.noise_var
        return mu, var

    def predict_f64(self, Xq) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 latent posterior (mu, var), each 1-D of length m.

        The exactness oracle consumed by boundary certification
        (``SafeOpt(exact_boundaries=True)``): any model exposing this
        method can have its near-threshold safe-set decisions
        recomputed at full precision.  For the exact model this is the
        host f64 factor's prediction.
        """
        return self._host.predict(Xq)

    def log_likelihood(self) -> float:
        """Exact log marginal likelihood at the current
        hyperparameters (GPy ``gp.log_likelihood()``), computed on the
        host float64 island.
        """
        from .hyperopt import log_marginal_likelihood

        n = self.num_data
        with jax.enable_x64(True):
            return float(log_marginal_likelihood(
                self.kern, jnp.asarray(self._host.X[:n]),
                jnp.asarray(self._host.Y[:n]),
                jnp.asarray(float(self.noise_var), jnp.float64)))

    def posterior_samples_f(self, Xq, size: int = 1, key=None
                            ) -> np.ndarray:
        """Draw joint samples of the LATENT function at ``Xq`` —
        GPy ``gp.posterior_samples_f`` (shape (m, 1, size)).

        The full posterior covariance is assembled and factored on the
        host in float64 (an f32 factorization of a near-singular
        posterior covariance NaNs out — same invariant as the training
        factor); explicit ``key`` for reproducibility, seeded default.
        """
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        mu, _ = self._host.predict(Xq)
        cov = self._host.posterior_cov(Xq)
        cov = 0.5 * (cov + cov.T) + 1e-10 * np.eye(cov.shape[0])
        # eigh handles the (common) near-singular posterior covariance
        # where Cholesky would fail on a tiny negative eigenvalue
        evals, evecs = np.linalg.eigh(cov)
        root = evecs * np.sqrt(np.maximum(evals, 0.0))
        if key is None:
            key = jax.random.key(0)
        eps = np.asarray(jax.random.normal(
            key, (cov.shape[0], int(size)), dtype=jnp.float64
            if jax.config.jax_enable_x64 else jnp.float32),
            dtype=np.float64)
        draws = mu[:, None] + root @ eps
        return draws[:, None, :]                       # (m, 1, size)

    def append_data(self, x, y) -> None:
        """Fast path: append one observation (O(n^2) exact update;
        the device mirrors receive only the one changed row)."""
        if self.num_data + 1 > self._host.capacity:
            self._host = self._host.grown(self._host.capacity * 2)
            self._host.append(np.asarray(x, dtype=np.float64), float(y))
            self._state = self._device_state()   # capacity changed
            return
        pos = int(self._host.count)
        self._host.append(np.asarray(x, dtype=np.float64), float(y))
        self._sync_row(pos)

    def pop_data(self) -> None:
        """Fast path: drop the most recent observation (exact; the
        device mirrors receive only the one restored padding row)."""
        self._host.pop()
        self._sync_row(int(self._host.count))

    def set_XY(self, X, Y) -> None:
        """Replace the training set (GPy semantics).

        Detects the reference's two access patterns — append rows
        (/root/reference/safeopt/gp_opt.py:227-228) and drop-last
        (/root/reference/safeopt/gp_opt.py:267,275) — and uses the exact
        incremental updates for *any* pure-append / pure-truncate delta
        (k bordering steps are O(k n^2), which beats the O(n^3) refit
        for every k < n); anything else is a full refit, logged at
        debug level so silent slow paths are diagnosable.
        """
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        Y = np.asarray(Y, dtype=np.float64).reshape(X.shape[0], -1)
        n_old = self.num_data
        n_new = X.shape[0]

        if X.shape[1] == self.input_dim:
            X_cur = self._host.X[:n_old]
            Y_cur = self._host.Y[:n_old]
            if (n_new > n_old
                    and np.array_equal(X[:n_old], X_cur)
                    and np.array_equal(Y[:n_old], Y_cur)):
                for i in range(n_old, n_new):
                    self.append_data(X[i], Y[i, 0])
                return
            if (n_new < n_old
                    and np.array_equal(X, X_cur[:n_new])
                    and np.array_equal(Y, Y_cur[:n_new])):
                for _ in range(n_old - n_new):
                    self.pop_data()
                return

        import logging
        logging.getLogger(__name__).debug(
            "set_XY: data is not a pure append/truncate of the current "
            "set (%d -> %d rows); full O(n^3) refit", n_old, n_new)

        cap = self._host.capacity
        if n_new + 1 > cap or X.shape[1] != self.input_dim:
            cap = _next_capacity(n_new + 1)
            from .host_math import HostFactor
            self._host = HostFactor(self.kern, cap, X.shape[1],
                                    self.noise_var)
        self._host.set_data(X, Y)
        self._state = self._device_state()

    def optimize_hyperparameters(self, steps: int = 200,
                                 learning_rate: float = 0.05,
                                 optimize_noise: bool = True,
                                 restarts: int = 0,
                                 seed: int = 0) -> float:
        """Fit kernel hyperparameters (and optionally the noise) by
        maximizing the exact log marginal likelihood (Adam in log
        space; see gp/hyperopt.py). GPy exposes this as
        ``gp.optimize()``; the reference never calls it, so this is
        new capability, not parity surface.

        ``restarts`` adds that many additional runs from log-space-
        perturbed starting points (all vmapped into one compiled
        program) and keeps the best finite fit — the standard defense
        against multimodal LML surfaces (GPy's ``optimize_restarts``).

        Returns the best log marginal likelihood.
        """
        from .hyperopt import fit_hyperparameters

        n = self.num_data
        kern, noise, lml = fit_hyperparameters(
            self.kern, self._host.X[:n], self._host.Y[:n],
            self.noise_var, steps=steps, learning_rate=learning_rate,
            optimize_noise=optimize_noise, restarts=restarts, seed=seed)
        self.kern = kern
        self._host.kernel = kern
        self._host.noise_var = noise
        from .host_math import _native_kind
        self._host._native_kind = _native_kind(kern)
        self.refit()
        return lml

    def optimize(self, max_iters: int = 200, **_gpy_compat) -> float:
        """GPy-compatible spelling of hyperparameter fitting.

        GPy models expose ``gp.optimize(max_iters=...)``; users
        migrating notebooks that call it land here (extra GPy-only
        kwargs such as ``optimizer=`` or ``messages=`` are accepted
        and ignored). Returns the final log marginal likelihood.
        """
        return self.optimize_hyperparameters(steps=max_iters)

    def optimize_restarts(self, num_restarts: int = 5,
                          max_iters: int = 200, seed: int = 0,
                          **_gpy_compat) -> float:
        """GPy-compatible multi-start hyperparameter fitting.

        Mirrors ``GPy.core.GP.optimize_restarts(num_restarts=...)``:
        one run from the current hyperparameters plus ``num_restarts``
        perturbed starts, best finite LML wins. Returns that LML.
        """
        return self.optimize_hyperparameters(
            steps=max_iters, restarts=num_restarts, seed=seed)

    def refit(self) -> None:
        """Refactorize from scratch (numerical hygiene escape hatch)."""
        self._host.set_data(self._host.X[: self.num_data].copy(),
                            self._host.Y[: self.num_data].copy())
        self._state = self._device_state()

    def __repr__(self):
        return (f"GPRegression(n={self.num_data}, d={self.input_dim}, "
                f"noise_var={self.noise_var}, kern={self.kern!r})")
