"""Float64 host-side factor math (the "f64 island").

GP posteriors over huge candidate grids are numerically benign in f32
*given an accurate factor*: the triangular-inverse matvecs amplify
errors by at most ~kappa(L) ~ sqrt(kappa(K)). Computing the CHOLESKY
ITSELF in f32 is not benign — gram matrices with small observation
noise reach kappa(K) ~ 1e7+, where f32 factorization loses every digit
or hits negative pivots (NaN), silently emptying the safe set.

The factor is O(n^2) state over n <= a few hundred observations, so the
design computes it on the host in NumPy/SciPy float64
(microseconds) and ships the small f32-cast factors to the device; all
O(N) grid work stays on the device. This mirrors the reference's
effective precision (GPy is float64 LAPACK) at zero device cost.

Used by ``GPRegression``; the pure-JAX device functions in
``regression.py`` remain available for fully-fused in-jit updates
(e.g. multi-chip training steps).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg

from .kernels import (Bias, Cosine, Exponential, Kernel, Linear,
                      Matern32, Matern52, MLP, Poly, Product, RatQuad,
                      RBF, StdPeriodic, Sum, White)

__all__ = ["np_kernel", "np_kdiag", "HostFactor"]


def _native_kind(kernel: Kernel):
    """Native gram kind when the C++ engine covers this kernel."""
    if isinstance(kernel, RBF) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "rbf"
    if isinstance(kernel, Matern32) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "matern32"
    if isinstance(kernel, Matern52) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "matern52"
    if isinstance(kernel, Exponential) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "exponential"
    if isinstance(kernel, RatQuad) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "ratquad"
    if isinstance(kernel, StdPeriodic) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "stdperiodic"
    if isinstance(kernel, Linear) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "linear"
    if isinstance(kernel, Cosine) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "cosine"
    if isinstance(kernel, Poly) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "poly"
    if isinstance(kernel, MLP) and kernel.active_dims == tuple(
            range(kernel.input_dim)):
        return "mlp"
    return None


def np_kernel(kernel: Kernel, X: np.ndarray,
              X2: Optional[np.ndarray] = None) -> np.ndarray:
    """Evaluate a kernel gram in NumPy float64 (host mirror of
    ``kernels.Kernel.K``)."""
    if isinstance(kernel, Product):
        return np_kernel(kernel.k1, X, X2) * np_kernel(kernel.k2, X, X2)
    if isinstance(kernel, Sum):
        return np_kernel(kernel.k1, X, X2) + np_kernel(kernel.k2, X, X2)
    if isinstance(kernel, White):
        n = np.atleast_2d(X).shape[0]
        if X2 is None:
            return float(kernel.variance) * np.eye(n)
        return np.zeros((n, np.atleast_2d(X2).shape[0]))
    if isinstance(kernel, Bias):
        n = np.atleast_2d(X).shape[0]
        m = n if X2 is None else np.atleast_2d(X2).shape[0]
        return float(kernel.variance) * np.ones((n, m))
    if isinstance(kernel, StdPeriodic):
        dims = list(kernel.active_dims)
        Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
        Za = (Xa if X2 is None
              else np.atleast_2d(np.asarray(X2, dtype=np.float64))[:, dims])
        period = np.broadcast_to(np.asarray(kernel.period, np.float64),
                                 (kernel.input_dim,))
        ls = np.broadcast_to(np.asarray(kernel.lengthscale, np.float64),
                             (kernel.input_dim,))
        s2 = np.zeros((Xa.shape[0], Za.shape[0]))
        for j in range(kernel.input_dim):
            base = np.pi * (Xa[:, j][:, None] - Za[:, j][None, :]) \
                / period[j]
            s2 += (np.sin(base) / ls[j]) ** 2
        return float(kernel.variance) * np.exp(-0.5 * s2)
    if isinstance(kernel, Linear):
        dims = list(kernel.active_dims)
        Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
        Za = (Xa if X2 is None
              else np.atleast_2d(np.asarray(X2, dtype=np.float64))[:, dims])
        v = np.asarray(kernel.variances, dtype=np.float64)
        return (Xa * v) @ Za.T
    if isinstance(kernel, Poly):
        dims = list(kernel.active_dims)
        Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
        Za = (Xa if X2 is None
              else np.atleast_2d(np.asarray(X2, dtype=np.float64))[:, dims])
        return float(kernel.variance) * (
            float(kernel.scale) * (Xa @ Za.T)
            + float(kernel.bias)) ** kernel.order
    if isinstance(kernel, MLP):
        dims = list(kernel.active_dims)
        Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
        Za = (Xa if X2 is None
              else np.atleast_2d(np.asarray(X2, dtype=np.float64))[:, dims])
        w = np.asarray(kernel.weight_variance, dtype=np.float64)
        b = float(kernel.bias_variance)
        xd = np.sqrt(np.sum(Xa * Xa * w, axis=1) + b + 1.0)
        zd = np.sqrt(np.sum(Za * Za * w, axis=1) + b + 1.0)
        cos = ((Xa * w) @ Za.T + b) / xd[:, None] / zd[None, :]
        cos = np.clip(cos, -1.0, 1.0)
        return float(kernel.variance) * (2.0 / np.pi) * np.arcsin(cos)
    if not isinstance(kernel, (RBF, Matern32, Matern52, Exponential,
                               RatQuad, Cosine)):
        raise TypeError(f"no host implementation for {type(kernel).__name__}")

    ls = np.asarray(kernel.lengthscale, dtype=np.float64)
    var = float(kernel.variance)
    dims = list(kernel.active_dims)
    Xs = np.asarray(X, dtype=np.float64)[:, dims] / ls
    Zs = Xs if X2 is None else np.asarray(X2, dtype=np.float64)[:, dims] / ls

    xn = np.sum(Xs * Xs, axis=1)[:, None]
    zn = np.sum(Zs * Zs, axis=1)[None, :]
    r2 = np.maximum(xn + zn - 2.0 * (Xs @ Zs.T), 0.0)

    if isinstance(kernel, RBF):
        return var * np.exp(-0.5 * r2)
    if isinstance(kernel, RatQuad):
        return var * (1.0 + 0.5 * r2) ** (-float(kernel.power))
    r = np.sqrt(r2)
    if isinstance(kernel, Cosine):
        return var * np.cos(r)
    if isinstance(kernel, Exponential):
        return var * np.exp(-r)
    if isinstance(kernel, Matern52):
        s5r = np.sqrt(5.0) * r
        return var * (1.0 + s5r + (5.0 / 3.0) * r2) * np.exp(-s5r)
    s3r = np.sqrt(3.0) * r
    return var * (1.0 + s3r) * np.exp(-s3r)


def np_kdiag(kernel: Kernel, X: np.ndarray) -> np.ndarray:
    """Prior variance diagonal in float64."""
    if isinstance(kernel, Product):
        return np_kdiag(kernel.k1, X) * np_kdiag(kernel.k2, X)
    if isinstance(kernel, Sum):
        return np_kdiag(kernel.k1, X) + np_kdiag(kernel.k2, X)
    if isinstance(kernel, Linear):
        dims = list(kernel.active_dims)
        Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
        v = np.asarray(kernel.variances, dtype=np.float64)
        return np.sum(Xa * Xa * v, axis=1)
    if isinstance(kernel, Poly):
        dims = list(kernel.active_dims)
        Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
        dot = np.sum(Xa * Xa, axis=1)
        return float(kernel.variance) * (
            float(kernel.scale) * dot + float(kernel.bias)) ** kernel.order
    if isinstance(kernel, MLP):
        dims = list(kernel.active_dims)
        Xa = np.atleast_2d(np.asarray(X, dtype=np.float64))[:, dims]
        w = np.asarray(kernel.weight_variance, dtype=np.float64)
        p = np.sum(Xa * Xa * w, axis=1) + float(kernel.bias_variance)
        return (float(kernel.variance) * (2.0 / np.pi)
                * np.arcsin(p / (p + 1.0)))
    return float(kernel.variance) * np.ones(np.atleast_2d(X).shape[0])


class HostFactor:
    """Float64 padded Cholesky factor state with exact incremental ops.

    Maintains the same invariants as the device ``GPState`` (identity
    rows beyond ``count``) so the f32 casts drop straight into the
    jitted pipeline.
    """

    def __init__(self, kernel: Kernel, capacity: int, input_dim: int,
                 noise_var: float):
        self.kernel = kernel
        self.noise_var = float(noise_var)
        self.count = 0
        self.X = np.zeros((capacity, input_dim))
        self.Y = np.zeros((capacity, 1))
        self.L = np.eye(capacity)
        self.Linv = np.eye(capacity)
        self.w = np.zeros(capacity)

        # Native C++ engine (csrc/host_factor.cpp) when it compiled on
        # this host and the kernel has a native gram; SciPy otherwise.
        from .. import native
        self._native_kind = _native_kind(kernel)
        self._use_native = native.available()
        self._native = native if self._use_native else None

    def _native_gram(self, X: np.ndarray, Z: np.ndarray) -> np.ndarray:
        kern = self.kernel
        if self._native_kind == "linear":
            # the per-dim weights ride the length-d slot; var is unused
            return self._native.gram("linear", X, Z,
                                     np.asarray(kern.variances), 1.0)
        if self._native_kind == "poly":
            return self._native.gram(
                "poly", X, Z, np.ones(kern.input_dim),
                float(kern.variance), power=kern.order,
                scale=float(kern.scale), bias=float(kern.bias))
        if self._native_kind == "mlp":
            # per-dim weight variances ride the length-d slot
            return self._native.gram(
                "mlp", X, Z, np.asarray(kern.weight_variance),
                float(kern.variance), bias=float(kern.bias_variance))
        extras = {}
        if self._native_kind == "ratquad":
            extras["power"] = float(np.asarray(kern.power))
        elif self._native_kind == "stdperiodic":
            extras["period"] = np.asarray(kern.period, dtype=np.float64)
        return self._native.gram(self._native_kind, X, Z,
                                 np.asarray(kern.lengthscale),
                                 float(kern.variance), **extras)

    def _gram(self, X: np.ndarray, Z: np.ndarray) -> np.ndarray:
        if self._use_native and self._native_kind is not None:
            return self._native_gram(X, Z)
        return np_kernel(self.kernel, X, Z)

    def _gram_sym(self, X: np.ndarray) -> np.ndarray:
        """Training gram K(X, X) with *single-set* semantics.

        Distinct from ``_gram(X, X)`` for White components, whose GPy
        semantics put ``variance`` on the diagonal of a single-set gram
        but return 0 across two sets (kernels.White).
        """
        if self._use_native and self._native_kind is not None:
            return self._native_gram(X, X)
        return np_kernel(self.kernel, X)

    @property
    def capacity(self) -> int:
        """Padded buffer size of the factor state."""
        return self.X.shape[0]

    def set_data(self, X: np.ndarray, Y: np.ndarray) -> None:
        """Full refactorization from scratch (float64 LAPACK)."""
        n = X.shape[0]
        cap = self.capacity
        if n > cap:
            raise ValueError(f"{n} rows exceed capacity {cap}")
        self.X[:] = 0.0
        self.Y[:] = 0.0
        self.X[:n] = X
        self.Y[:n] = np.asarray(Y).reshape(n, 1)
        self.count = n

        self.L = np.eye(cap)
        self.Linv = np.eye(cap)
        self.w = np.zeros(cap)
        if n == 0:
            return
        K = self._gram_sym(self.X[:n]) + self.noise_var * np.eye(n)
        if self._use_native:
            self.L[:n, :n] = K
            self._native.cholesky_lower(self.L, n)
            self._native.tri_inverse_lower(self.L, n, self.Linv)
        else:
            L = scipy.linalg.cholesky(K, lower=True)
            self.L[:n, :n] = L
            self.Linv[:n, :n] = scipy.linalg.solve_triangular(
                L, np.eye(n), lower=True)
        self.w[:n] = self.Linv[:n, :n] @ self.Y[:n, 0]

    def append(self, x: np.ndarray, y: float) -> None:
        """Exact O(n^2) Cholesky bordering (float64)."""
        pos = self.count
        if pos + 1 > self.capacity:
            raise ValueError("capacity exceeded")
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        kvec = (self._gram(self.X[:pos], x[None, :])[:, 0]
                if pos else np.zeros(0))
        kxx = np_kdiag(self.kernel, x[None, :])[0]

        if self._use_native:
            self._native.border_append(self.L, self.Linv, self.w, pos,
                                       kvec, kxx + self.noise_var,
                                       float(y))
        else:
            c = self.Linv[:pos, :pos] @ kvec
            dd2 = kxx + self.noise_var - c @ c
            dd = np.sqrt(max(dd2, 1e-300))
            self.L[pos, :pos] = c
            self.L[pos, pos] = dd
            self.Linv[pos, :pos] = -(self.Linv[:pos, :pos].T @ c) / dd
            self.Linv[pos, pos] = 1.0 / dd
            mu_x = c @ self.w[:pos]
            self.w[pos] = (float(y) - mu_x) / dd
        self.X[pos] = x
        self.Y[pos, 0] = float(y)
        self.count = pos + 1

    def pop(self) -> None:
        """Drop the last observation (truncation; exact)."""
        if self.count == 0:
            raise ValueError("no data to remove")
        pos = self.count - 1
        self.L[pos, :] = 0.0
        self.L[pos, pos] = 1.0
        self.Linv[pos, :] = 0.0
        self.Linv[pos, pos] = 1.0
        self.w[pos] = 0.0
        self.X[pos] = 0.0
        self.Y[pos] = 0.0
        self.count = pos

    def predict(self, Xq: np.ndarray):
        """Float64 latent posterior (mu, var) at query rows.

        The exactness oracle for boundary certification
        (algorithms/safe_opt.py exact_boundaries): recomputes the
        handful of near-threshold candidates at full precision —
        O(m n^2) for m query rows, microseconds at BO scales.
        """
        n = self.count
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        kdiag = np_kdiag(self.kernel, Xq)
        if n == 0:
            return np.zeros(Xq.shape[0]), kdiag
        kvec = self._gram(self.X[:n], Xq)            # (n, m)
        V = self.Linv[:n, :n] @ kvec
        mu = V.T @ self.w[:n]
        var = kdiag - np.sum(V * V, axis=0)
        return mu, np.maximum(var, 0.0)

    def posterior_cov(self, Xq: np.ndarray) -> np.ndarray:
        """Float64 full latent posterior covariance at query rows.

        ``K(Xq, Xq) - V^T V`` with ``V = L^{-1} K(X, Xq)`` —
        O(n^2 m + n m^2) for m query rows; used by posterior function
        sampling (``GPRegression.posterior_samples_f``).
        """
        n = self.count
        Xq = np.atleast_2d(np.asarray(Xq, dtype=np.float64))
        Kqq = np_kernel(self.kernel, Xq)
        if n == 0:
            return Kqq
        kvec = self._gram(self.X[:n], Xq)
        V = self.Linv[:n, :n] @ kvec
        return Kqq - V.T @ V

    def grown(self, new_capacity: int) -> "HostFactor":
        """Copy into a larger buffer (refactorizes for exactness)."""
        out = HostFactor(self.kernel, new_capacity, self.X.shape[1],
                         self.noise_var)
        out.set_data(self.X[: self.count].copy(),
                     self.Y[: self.count].copy())
        return out
