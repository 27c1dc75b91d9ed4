"""Covariance kernels for the in-repo GP engine.

Implements the closed set of kernel features the reference consumes from
GPy (see /root/reference/safeopt/gp_opt.py:83,847,1093 and
/root/reference/safeopt/utilities.py:89,135): stationary RBF and
Matern-3/2 kernels with scalar or ARD lengthscales, ``active_dims``
column slicing, product composition (``k1 * k2``), ``K(X, X2)``,
``Kdiag(X)`` and ``copy()`` — plus the adjacent GPy surface real users
reach for: Matern-5/2, Exponential (Matern-1/2), Bias and White
kernels, and sum composition (``k1 + k2``).

Kernels are registered JAX pytrees: hyperparameters (variance,
lengthscale) are traced leaves, while structure (input_dim, ARD flag,
active_dims) is static aux data — so a kernel can be passed straight
into ``jit``-compiled functions and the compilation caches on structure
only.

Gram construction is expressed so XLA maps the inner product onto a
matmul: scaled squared distances via ``|x|^2 + |z|^2 - 2 x.z^T`` where the
cross term is a single matmul over the (batch, dim) operands.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import default_dtype

__all__ = ["Kernel", "RBF", "Matern32", "Matern52", "Exponential",
           "RatQuad", "Cosine", "StdPeriodic", "Linear", "Poly", "MLP",
           "Bias", "White", "Product", "Sum"]


def _as_active_dims(active_dims, input_dim: int) -> Tuple[int, ...]:
    if active_dims is None:
        return tuple(range(input_dim))
    dims = tuple(int(d) for d in active_dims)
    if len(dims) != input_dim:
        raise ValueError(
            "active_dims must have length input_dim "
            f"({len(dims)} != {input_dim})"
        )
    return dims


def _slice_active(X: jnp.ndarray, active_dims: Tuple[int, ...]) -> jnp.ndarray:
    X = jnp.atleast_2d(X)
    if X.shape[1] == len(active_dims) and active_dims == tuple(
        range(len(active_dims))
    ):
        return X
    return X[:, list(active_dims)]


class Kernel:
    """Base class for covariance kernels (GPy ``kern`` API surface)."""

    #: number of input dimensions this kernel operates on
    input_dim: int
    #: columns of the full input this kernel reads
    active_dims: Tuple[int, ...]

    def K(self, X, X2=None) -> jnp.ndarray:
        """Cross-covariance matrix k(X, X2); X2=None means k(X, X)."""
        raise NotImplementedError

    def Kdiag(self, X) -> jnp.ndarray:
        """Diagonal of k(X, X) — the prior variance at each input."""
        raise NotImplementedError

    def copy(self) -> "Kernel":
        """Deep copy via the pytree protocol (GPy ``kern.copy()``)."""
        leaves, treedef = jax.tree_util.tree_flatten(self)
        return jax.tree_util.tree_unflatten(treedef,
                                            [l.copy() for l in leaves])

    def __mul__(self, other: "Kernel") -> "Product":
        return Product(self, other)

    def __add__(self, other: "Kernel") -> "Sum":
        return Sum(self, other)


class _Stationary(Kernel):
    """Shared machinery for stationary kernels k(x, z) = f(r).

    ``r^2`` is the lengthscale-scaled squared Euclidean distance over the
    kernel's active dims.
    """

    def __init__(self, input_dim, variance=1.0, lengthscale=None, ARD=False,
                 active_dims=None, name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD = bool(ARD)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else type(self).__name__.lower()

        dtype = default_dtype()
        self.variance = jnp.asarray(variance, dtype=dtype).reshape(())
        if lengthscale is None:
            lengthscale = jnp.ones(self.input_dim) if self.ARD else 1.0
        lengthscale = jnp.asarray(lengthscale, dtype=dtype)
        if self.ARD:
            self.lengthscale = jnp.broadcast_to(
                lengthscale.reshape(-1), (self.input_dim,)
            )
        else:
            self.lengthscale = lengthscale.reshape(())

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        """Pytree protocol: (traced hyperparameters, static aux)."""
        children = (self.variance, self.lengthscale)
        aux = (self.input_dim, self.ARD, self.active_dims, self.name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        """Pytree protocol: rebuild from (aux, traced leaves)."""
        obj = object.__new__(cls)
        obj.input_dim, obj.ARD, obj.active_dims, obj.name = aux
        obj.variance, obj.lengthscale = children
        return obj

    # -- gram construction ------------------------------------------------
    def _scaled(self, X: jnp.ndarray) -> jnp.ndarray:
        return _slice_active(X, self.active_dims) / self.lengthscale

    def _r2(self, X, X2=None) -> jnp.ndarray:
        Xs = self._scaled(X)
        Zs = Xs if X2 is None else self._scaled(X2)
        # |x|^2 + |z|^2 - 2 x.z^T : the cross term is one matmul.
        xn = jnp.sum(Xs * Xs, axis=1, keepdims=True)
        zn = jnp.sum(Zs * Zs, axis=1, keepdims=True)
        cross = Xs @ Zs.T
        r2 = xn + zn.T - 2.0 * cross
        return jnp.maximum(r2, 0.0)

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def K(self, X, X2=None) -> jnp.ndarray:
        return self._K_of_r2(self._r2(X, X2))

    def Kdiag(self, X) -> jnp.ndarray:
        X = jnp.atleast_2d(X)
        return jnp.full((X.shape[0],), 1.0, dtype=self.variance.dtype) * (
            self.variance
        )

    def __repr__(self):
        return (
            f"{type(self).__name__}(input_dim={self.input_dim}, "
            f"variance={self.variance}, lengthscale={self.lengthscale}, "
            f"ARD={self.ARD}, active_dims={self.active_dims})"
        )


@jax.tree_util.register_pytree_node_class
class RBF(_Stationary):
    """Squared-exponential kernel: k(r) = variance * exp(-r^2 / 2).

    Matches GPy.kern.RBF as used by the reference notebooks and tests
    (/root/reference/safeopt/tests/test_gps.py:18).
    """

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        return self.variance * jnp.exp(-0.5 * r2)


@jax.tree_util.register_pytree_node_class
class Matern32(_Stationary):
    """Matern-3/2: k(r) = variance * (1 + sqrt(3) r) * exp(-sqrt(3) r).

    Matches GPy.kern.Matern32 as used in
    /root/reference/safeopt/tests/test_gps.py:19.
    """

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        r = jnp.sqrt(r2 + 1e-36)  # guarded sqrt: grad-safe at r = 0
        s3r = jnp.sqrt(jnp.asarray(3.0, r.dtype)) * r
        return self.variance * (1.0 + s3r) * jnp.exp(-s3r)


@jax.tree_util.register_pytree_node_class
class Matern52(_Stationary):
    """Matern-5/2: k(r) = variance * (1 + sqrt(5) r + 5 r^2 / 3)
    * exp(-sqrt(5) r).

    New capability beyond the reference's consumed surface (SURVEY.md
    section 2.8 lists RBF / Matern-3/2), provided because it is the
    other stationary kernel GPy users reach for; participates in ARD,
    active_dims, products, hyperparameter fitting and the host f64
    island like the other stationary kernels.
    """

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        r = jnp.sqrt(r2 + 1e-36)  # guarded sqrt: grad-safe at r = 0
        s5r = jnp.sqrt(jnp.asarray(5.0, r.dtype)) * r
        return self.variance * (1.0 + s5r + (5.0 / 3.0) * r2) \
            * jnp.exp(-s5r)


@jax.tree_util.register_pytree_node_class
class Exponential(_Stationary):
    """Exponential (Matern-1/2 / Ornstein-Uhlenbeck):
    k(r) = variance * exp(-r).

    Beyond the reference's consumed surface (SURVEY.md section 2.8);
    matches GPy.kern.Exponential. Participates in ARD, active_dims,
    sums/products, hyperparameter fitting and the host f64 island like
    the other stationary kernels.
    """

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        r = jnp.sqrt(r2 + 1e-36)  # guarded sqrt: grad-safe at r = 0
        return self.variance * jnp.exp(-r)


@jax.tree_util.register_pytree_node_class
class RatQuad(_Stationary):
    """Rational quadratic: k(r) = variance * (1 + r^2/2)^(-power).

    Matches GPy.kern.RatQuad (a scale mixture of RBFs; ``power`` is
    the mixture concentration). Beyond the reference's consumed
    surface. ``power`` is a traced pytree leaf like the other
    hyperparameters, so hyperopt fits it.
    """

    def __init__(self, input_dim, variance=1.0, lengthscale=None,
                 power=2.0, ARD=False, active_dims=None,
                 name: Optional[str] = None):
        super().__init__(input_dim, variance=variance,
                         lengthscale=lengthscale, ARD=ARD,
                         active_dims=active_dims, name=name or "ratquad")
        self.power = jnp.asarray(power, dtype=self.variance.dtype
                                 ).reshape(())

    def tree_flatten(self):
        """Pytree protocol: power is a traced leaf like the others."""
        children = (self.variance, self.lengthscale, self.power)
        aux = (self.input_dim, self.ARD, self.active_dims, self.name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        """Pytree protocol: rebuild from (aux, traced leaves)."""
        obj = object.__new__(cls)
        obj.input_dim, obj.ARD, obj.active_dims, obj.name = aux
        obj.variance, obj.lengthscale, obj.power = children
        return obj

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        return self.variance * (1.0 + 0.5 * r2) ** (-self.power)


@jax.tree_util.register_pytree_node_class
class Cosine(_Stationary):
    """Cosine kernel: k(r) = variance * cos(r) (GPy.kern.Cosine).

    Beyond the reference's consumed surface; GPy's pure-oscillation
    stationary kernel (a point spectral mass at 1/lengthscale —
    useful for signals with one known dominant frequency; for
    periodic-plus-decay structure prefer ``Cosine * RBF`` or
    ``StdPeriodic``). Participates in active_dims, sums/products,
    hyperparameter fitting, the host f64 island and the native C++
    engine like the other stationary kernels.

    Restricted to ``input_dim == 1``: ``cos(|x - z|)`` is a valid
    (positive-semidefinite) covariance only in 1-D — in higher
    dimensions its gram has negative eigenvalues and the factorization
    fails or, worse, near-PSD cases silently distort the posterior
    (GPy constructs such kernels without complaint; this engine
    refuses). Use it on one column via ``active_dims`` and compose
    with products for multi-dimensional inputs.
    """

    def __init__(self, input_dim, variance=1.0, lengthscale=None,
                 ARD=False, active_dims=None,
                 name: Optional[str] = None):
        if int(input_dim) != 1:
            raise ValueError(
                "Cosine is a valid covariance only in 1-D (its gram is "
                "indefinite for input_dim >= 2); apply it to one column "
                "via active_dims and compose with products instead")
        super().__init__(input_dim, variance=variance,
                         lengthscale=lengthscale, ARD=ARD,
                         active_dims=active_dims, name=name or "cosine")

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        r = jnp.sqrt(r2 + 1e-36)  # guarded sqrt: grad-safe at r = 0
        return self.variance * jnp.cos(r)


@jax.tree_util.register_pytree_node_class
class StdPeriodic(Kernel):
    """Standard periodic kernel (GPy.kern.StdPeriodic convention):

        k(x, z) = variance * exp(-0.5 * sum_j (sin(pi (x_j - z_j) /
                  period_j) / lengthscale_j)^2)

    Beyond the reference's consumed surface; the GPy kernel users
    reach for on periodic systems (rotating machinery, daily/seasonal
    effects). ``ARD1`` makes ``period`` per-dimension, ``ARD2`` the
    ``lengthscale`` (GPy's flags). All three hyperparameters are
    traced pytree leaves, so hyperopt fits them (period in log space
    like the rest). Stationary in x - z but not a function of
    Euclidean distance; the per-dimension difference
    accumulation below never materializes an (N, M, d) tensor.
    """

    def __init__(self, input_dim, variance=1.0, period=None,
                 lengthscale=None, ARD1=False, ARD2=False,
                 active_dims=None, name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD1 = bool(ARD1)
        self.ARD2 = bool(ARD2)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "std_periodic"

        dtype = default_dtype()
        self.variance = jnp.asarray(variance, dtype=dtype).reshape(())
        if period is None:
            period = jnp.ones(self.input_dim) if self.ARD1 else 2.0 * jnp.pi
        period = jnp.asarray(period, dtype=dtype)
        self.period = (jnp.broadcast_to(period.reshape(-1),
                                        (self.input_dim,))
                       if self.ARD1 else period.reshape(()))
        if lengthscale is None:
            lengthscale = jnp.ones(self.input_dim) if self.ARD2 else 1.0
        lengthscale = jnp.asarray(lengthscale, dtype=dtype)
        self.lengthscale = (jnp.broadcast_to(lengthscale.reshape(-1),
                                             (self.input_dim,))
                            if self.ARD2 else lengthscale.reshape(()))

    def tree_flatten(self):
        """Pytree protocol: period is a traced leaf like the others."""
        children = (self.variance, self.period, self.lengthscale)
        aux = (self.input_dim, self.ARD1, self.ARD2, self.active_dims,
               self.name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        """Pytree protocol: rebuild from (aux, traced leaves)."""
        obj = object.__new__(cls)
        (obj.input_dim, obj.ARD1, obj.ARD2, obj.active_dims,
         obj.name) = aux
        obj.variance, obj.period, obj.lengthscale = children
        return obj

    def K(self, X, X2=None) -> jnp.ndarray:
        Xa = _slice_active(jnp.atleast_2d(X), self.active_dims)
        Za = Xa if X2 is None else _slice_active(jnp.atleast_2d(X2),
                                                 self.active_dims)
        period = jnp.broadcast_to(self.period, (self.input_dim,))
        ls = jnp.broadcast_to(self.lengthscale, (self.input_dim,))
        s2 = jnp.zeros((Xa.shape[0], Za.shape[0]), Xa.dtype)
        for j in range(self.input_dim):
            base = jnp.pi * (Xa[:, j][:, None]
                             - Za[:, j][None, :]) / period[j]
            s2 = s2 + (jnp.sin(base) / ls[j]) ** 2
        return self.variance * jnp.exp(-0.5 * s2)

    def Kdiag(self, X) -> jnp.ndarray:
        X = jnp.atleast_2d(X)
        return jnp.full((X.shape[0],), 1.0,
                        dtype=self.variance.dtype) * self.variance

    def __repr__(self):
        return (f"StdPeriodic(input_dim={self.input_dim}, "
                f"variance={self.variance}, period={self.period}, "
                f"lengthscale={self.lengthscale}, ARD1={self.ARD1}, "
                f"ARD2={self.ARD2}, active_dims={self.active_dims})")


@jax.tree_util.register_pytree_node_class
class Linear(Kernel):
    """Linear (dot-product) kernel (GPy.kern.Linear convention):

        k(x, z) = sum_j variances_j * x_j * z_j

    Beyond the reference's consumed surface; the GPy kernel for global
    trends, typically summed with a stationary kernel and a Bias.
    ``ARD`` makes ``variances`` per-dimension (GPy's plural spelling is
    kept). ``variances`` is a traced pytree leaf, so hyperopt fits it
    in log space like every other hyperparameter. Non-stationary, so
    it runs on the exact XLA path; the cross term is one matmul.

    Note its prior variance ``Kdiag(x) = sum_j variances_j x_j^2``
    vanishes at the origin: ``scaling='auto'`` (prior std at the
    origin) is rejected for GPs whose kernel is Linear-only — pass
    explicit ``scaling`` or sum with a Bias/stationary part.
    """

    def __init__(self, input_dim, variances=1.0, ARD=False,
                 active_dims=None, name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD = bool(ARD)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "linear"

        dtype = default_dtype()
        variances = jnp.asarray(variances, dtype=dtype)
        if self.ARD:
            self.variances = jnp.broadcast_to(
                variances.reshape(-1), (self.input_dim,))
        else:
            self.variances = variances.reshape(())

    def tree_flatten(self):
        """Pytree protocol: (traced hyperparameters, static aux)."""
        children = (self.variances,)
        aux = (self.input_dim, self.ARD, self.active_dims, self.name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        """Pytree protocol: rebuild from (aux, traced leaves)."""
        obj = object.__new__(cls)
        obj.input_dim, obj.ARD, obj.active_dims, obj.name = aux
        (obj.variances,) = children
        return obj

    def K(self, X, X2=None) -> jnp.ndarray:
        Xa = _slice_active(jnp.atleast_2d(X), self.active_dims)
        Za = Xa if X2 is None else _slice_active(jnp.atleast_2d(X2),
                                                 self.active_dims)
        return (Xa * self.variances) @ Za.T

    def Kdiag(self, X) -> jnp.ndarray:
        Xa = _slice_active(jnp.atleast_2d(X), self.active_dims)
        return jnp.sum(Xa * Xa * self.variances, axis=1)

    def __repr__(self):
        return (f"Linear(input_dim={self.input_dim}, "
                f"variances={self.variances}, ARD={self.ARD}, "
                f"active_dims={self.active_dims})")


@jax.tree_util.register_pytree_node_class
class Poly(Kernel):
    """Polynomial kernel (GPy.kern.Poly convention):

        k(x, z) = variance * (scale * x.z^T + bias)^order

    Beyond the reference's consumed surface; the GPy kernel for
    polynomial trends. ``variance``, ``scale`` and ``bias`` are traced
    pytree leaves fitted in log space by hyperopt; ``order`` is static
    structure (it changes the function class, and GPy likewise never
    optimizes it). Non-stationary; the inner product is one matmul.

    Like Linear, its prior variance at the origin is ``variance *
    bias^order`` — ``scaling='auto'`` therefore requires ``bias > 0``.
    """

    def __init__(self, input_dim, variance=1.0, scale=1.0, bias=1.0,
                 order=3.0, active_dims=None,
                 name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.order = float(order)
        # a fractional order NaNs the gram wherever scale*x.z + bias
        # < 0 (x**2.5 of a negative), and the NaN rows silently
        # classify unsafe on the device — reject at construction
        if self.order < 1 or self.order != round(self.order):
            raise ValueError(
                f"Poly order must be a positive integer (got {order}): "
                "fractional powers of a negative dot-product are NaN")
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "poly"

        dtype = default_dtype()
        self.variance = jnp.asarray(variance, dtype=dtype).reshape(())
        self.scale = jnp.asarray(scale, dtype=dtype).reshape(())
        self.bias = jnp.asarray(bias, dtype=dtype).reshape(())

    def tree_flatten(self):
        """Pytree protocol: order is static aux (function class)."""
        children = (self.variance, self.scale, self.bias)
        aux = (self.input_dim, self.order, self.active_dims, self.name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        """Pytree protocol: rebuild from (aux, traced leaves)."""
        obj = object.__new__(cls)
        obj.input_dim, obj.order, obj.active_dims, obj.name = aux
        obj.variance, obj.scale, obj.bias = children
        return obj

    def K(self, X, X2=None) -> jnp.ndarray:
        Xa = _slice_active(jnp.atleast_2d(X), self.active_dims)
        Za = Xa if X2 is None else _slice_active(jnp.atleast_2d(X2),
                                                 self.active_dims)
        return self.variance * (self.scale * (Xa @ Za.T)
                                + self.bias) ** self.order

    def Kdiag(self, X) -> jnp.ndarray:
        Xa = _slice_active(jnp.atleast_2d(X), self.active_dims)
        dot = jnp.sum(Xa * Xa, axis=1)
        return self.variance * (self.scale * dot + self.bias) ** self.order

    def __repr__(self):
        return (f"Poly(input_dim={self.input_dim}, "
                f"variance={self.variance}, scale={self.scale}, "
                f"bias={self.bias}, order={self.order}, "
                f"active_dims={self.active_dims})")


@jax.tree_util.register_pytree_node_class
class MLP(Kernel):
    """MLP (arcsine / neural-network) kernel (GPy.kern.MLP convention):

        k(x, z) = variance * (2/pi) * asin( (w x.z^T + b) /
                  sqrt((w |x|^2 + b + 1)(w |z|^2 + b + 1)) )

    with ``w = weight_variance`` (per-dimension under ``ARD``) and
    ``b = bias_variance`` — the covariance of an infinitely wide
    one-hidden-layer erf network (Williams 1998). Beyond the
    reference's consumed surface. All three hyperparameters are traced
    pytree leaves fitted in log space. Non-stationary, so it runs on
    the exact XLA path; the weighted inner products are matmuls.
    """

    def __init__(self, input_dim, variance=1.0, weight_variance=1.0,
                 bias_variance=1.0, ARD=False, active_dims=None,
                 name: Optional[str] = None):
        self.input_dim = int(input_dim)
        self.ARD = bool(ARD)
        self.active_dims = _as_active_dims(active_dims, self.input_dim)
        self.name = name if name is not None else "mlp"

        dtype = default_dtype()
        self.variance = jnp.asarray(variance, dtype=dtype).reshape(())
        wv = jnp.asarray(weight_variance, dtype=dtype)
        if self.ARD:
            self.weight_variance = jnp.broadcast_to(
                wv.reshape(-1), (self.input_dim,))
        else:
            self.weight_variance = wv.reshape(())
        self.bias_variance = jnp.asarray(bias_variance,
                                         dtype=dtype).reshape(())

    def tree_flatten(self):
        """Pytree protocol: (traced hyperparameters, static aux)."""
        children = (self.variance, self.weight_variance,
                    self.bias_variance)
        aux = (self.input_dim, self.ARD, self.active_dims, self.name)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        """Pytree protocol: rebuild from (aux, traced leaves)."""
        obj = object.__new__(cls)
        obj.input_dim, obj.ARD, obj.active_dims, obj.name = aux
        (obj.variance, obj.weight_variance,
         obj.bias_variance) = children
        return obj

    def _wprod(self, X, X2=None) -> jnp.ndarray:
        if X2 is None:
            return (jnp.sum(X * X * self.weight_variance, axis=1)
                    + self.bias_variance)
        return (X * self.weight_variance) @ X2.T + self.bias_variance

    def K(self, X, X2=None) -> jnp.ndarray:
        Xa = _slice_active(jnp.atleast_2d(X), self.active_dims)
        Za = Xa if X2 is None else _slice_active(jnp.atleast_2d(X2),
                                                 self.active_dims)
        xd = jnp.sqrt(self._wprod(Xa) + 1.0)
        zd = xd if X2 is None else jnp.sqrt(self._wprod(Za) + 1.0)
        cos = self._wprod(Xa, Za) / xd[:, None] / zd[None, :]
        # clip: float round-off can push coincident points past +-1
        cos = jnp.clip(cos, -1.0, 1.0)
        two_over_pi = 2.0 / jnp.pi
        return self.variance * two_over_pi * jnp.arcsin(cos)

    def Kdiag(self, X) -> jnp.ndarray:
        Xa = _slice_active(jnp.atleast_2d(X), self.active_dims)
        p = self._wprod(Xa)
        two_over_pi = 2.0 / jnp.pi
        return self.variance * two_over_pi * jnp.arcsin(p / (p + 1.0))

    def __repr__(self):
        return (f"MLP(input_dim={self.input_dim}, "
                f"variance={self.variance}, "
                f"weight_variance={self.weight_variance}, "
                f"bias_variance={self.bias_variance}, ARD={self.ARD}, "
                f"active_dims={self.active_dims})")


@jax.tree_util.register_pytree_node_class
class Bias(_Stationary):
    """Constant kernel: k(x, z) = variance everywhere (GPy.kern.Bias).

    Typically summed with a stationary kernel to model a constant
    offset. Trivially stationary, so it rides every fused path.
    """

    def __init__(self, input_dim, variance=1.0, active_dims=None,
                 name: Optional[str] = None):
        super().__init__(input_dim, variance=variance, active_dims=active_dims,
                         name=name or "bias")

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:
        return jnp.broadcast_to(self.variance, r2.shape)


@jax.tree_util.register_pytree_node_class
class White(_Stationary):
    """White-noise kernel (GPy.kern.White).

    GPy semantics: ``K(X) = variance * I`` on a single input set and
    ``K(X, X2) = 0`` across two sets — white noise is uncorrelated
    between any two (even coincident) distinct points, so it only adds
    prior variance on the diagonal. Summed into a kernel it acts like
    extra observation noise that also appears in ``Kdiag``.
    """

    def __init__(self, input_dim, variance=1.0, active_dims=None,
                 name: Optional[str] = None):
        super().__init__(input_dim, variance=variance, active_dims=active_dims,
                         name=name or "white")

    def K(self, X, X2=None) -> jnp.ndarray:
        X = jnp.atleast_2d(X)
        if X2 is None:
            return self.variance * jnp.eye(X.shape[0], dtype=X.dtype)
        X2 = jnp.atleast_2d(X2)
        return jnp.zeros((X.shape[0], X2.shape[0]), dtype=X.dtype)

    def _K_of_r2(self, r2: jnp.ndarray) -> jnp.ndarray:  # pragma: no cover
        raise NotImplementedError("White overrides K directly")


class _Composite(Kernel):
    """Shared machinery for two-part compositions (Product / Sum)."""

    def __init__(self, k1: Kernel, k2: Kernel):
        self.k1 = k1
        self.k2 = k2

    @property
    def parts(self) -> Sequence[Kernel]:
        return (self.k1, self.k2)

    @property
    def input_dim(self) -> int:
        # Effective dimensionality: one past the largest active dim used.
        return max(max(self.k1.active_dims), max(self.k2.active_dims)) + 1

    @property
    def active_dims(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.k1.active_dims)
                            | set(self.k2.active_dims)))

    def tree_flatten(self):
        """Pytree protocol: both parts are child pytrees."""
        return (self.k1, self.k2), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        """Pytree protocol: rebuild from the two part kernels."""
        obj = object.__new__(cls)
        obj.k1, obj.k2 = children
        return obj

    def __repr__(self):
        return f"{type(self).__name__}({self.k1!r}, {self.k2!r})"


@jax.tree_util.register_pytree_node_class
class Product(_Composite):
    """Product composition ``k1 * k2``.

    The reference uses this for contextual optimization:
    ``RBF(active_dims=[0]) * RBF(active_dims=[1])``
    (context_example notebook; see SURVEY.md section 2.9).
    """

    def K(self, X, X2=None) -> jnp.ndarray:
        return self.k1.K(X, X2) * self.k2.K(X, X2)

    def Kdiag(self, X) -> jnp.ndarray:
        return self.k1.Kdiag(X) * self.k2.Kdiag(X)


@jax.tree_util.register_pytree_node_class
class Sum(_Composite):
    """Sum composition ``k1 + k2`` (GPy ``kern + kern``).

    Beyond the reference's consumed surface; the standard GPy idiom for
    offset (+ Bias), jitter (+ White) and multi-scale (+ RBF) models.
    """

    def K(self, X, X2=None) -> jnp.ndarray:
        return self.k1.K(X, X2) + self.k2.K(X, X2)

    def Kdiag(self, X) -> jnp.ndarray:
        return self.k1.Kdiag(X) + self.k2.Kdiag(X)
