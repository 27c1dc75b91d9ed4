"""GP-prior test-function sampling.

Accelerator-native counterpart of the reference's test-problem generator
(/root/reference/safeopt/utilities.py:57-143): draw one sample path of
a GP prior on a grid and return a callable that evaluates the
RKHS-interpolant (or linear interpolant) of that draw, with optional
mean function and Gaussian observation noise.

Differences from the reference (by design):
- Explicit ``jax.random`` keys instead of the global NumPy RNG — the
  reference seeds nothing anywhere (SURVEY.md section 3.5), so there is
  no stream to match; determinism is a new capability.
- The returned closure evaluates through the jitted kernel gram path.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import JITTER, default_dtype
from ..gp.kernels import Kernel
from .grids import linearly_spaced_combinations

__all__ = ["sample_gp_function"]


def sample_gp_function(kernel: Kernel, bounds, noise_var: float,
                       num_samples, interpolation: str = "kernel",
                       mean_function: Optional[Callable] = None,
                       key: Optional[jax.Array] = None) -> Callable:
    """Sample one function from a GP prior over a grid.

    Parameters
    ----------
    kernel : Kernel
        Prior covariance.
    bounds : list of (min, max) pairs
    noise_var : float
        Observation-noise variance applied when the returned function is
        called with ``noise=True``.
    num_samples : int or list of ints
        Grid resolution per dimension.
    interpolation : 'kernel' | 'linear'
        'kernel' evaluates the RKHS mean interpolant through the prior
        covariance (reference: utilities.py:119-143); 'linear' uses
        simplex interpolation on the grid (utilities.py:93-117).
    mean_function : callable, optional
        Added to the sample path.
    key : jax.random key, optional
        Source of randomness for the path draw and observation noise.
        Defaults to ``jax.random.key(0)``.

    Returns
    -------
    function : callable ``f(x, noise=True, key=None)``
        Evaluates the sampled function at 2-D inputs ``x``; returns an
        (m, 1) array. Each noisy call without an explicit key advances
        an internal subkey deterministically.
    """
    if key is None:
        key = jax.random.key(0)
    key, draw_key = jax.random.split(key)

    dtype = default_dtype()
    inputs_np = linearly_spaced_combinations(bounds, num_samples)
    inputs = jnp.asarray(inputs_np, dtype=dtype)
    n = inputs.shape[0]

    # Float64 island: the prior gram over a dense grid is severely
    # ill-conditioned (jitter 1e-6, reference utilities.py:89), so the
    # draw's Cholesky runs on the host in f64 — an f32 factorization
    # returns NaN and poisons every downstream evaluation. The grid is
    # setup-time state; evaluation stays on device.
    import scipy.linalg

    from ..gp.host_math import np_kernel

    cov = np_kernel(kernel, inputs_np) + JITTER * np.eye(n)
    chol_np = scipy.linalg.cholesky(cov, lower=True)
    # The prior draw is part of the f64 host island: generate the
    # standard normal in float64 regardless of the session x64 flag
    # (an f32 draw would truncate the path's mantissa before it ever
    # touches the f64 Cholesky; reference draw is f64 numpy,
    # utilities.py:90).
    with jax.enable_x64(True):
        normal = np.asarray(
            jax.random.normal(draw_key, (n,), dtype=jnp.float64))
    output_np = chol_np @ normal
    output = jnp.asarray(output_np, dtype=dtype)

    noise_scale = jnp.sqrt(jnp.asarray(noise_var, dtype=dtype))

    def _noise(x, noise, key_arg, call_counter=[0]):
        if not noise:
            return 0.0
        if key_arg is None:
            # Deterministic per-call subkey: fold the call index into
            # the base key (explicit threading, no mutable key state —
            # call i always sees the same stream regardless of what
            # happened in between).
            sub = jax.random.fold_in(key, call_counter[0])
            call_counter[0] += 1
        else:
            sub = key_arg
        return noise_scale * jax.random.normal(sub, (x.shape[0], 1),
                                               dtype=dtype)

    if interpolation == "kernel":
        alpha = jnp.asarray(
            scipy.linalg.cho_solve((chol_np, True), output_np), dtype=dtype)

        def evaluate_rkhs(x, noise: bool = True, key: Optional[jax.Array]
                          = None):
            x = jnp.atleast_2d(jnp.asarray(x, dtype=dtype))
            y = (kernel.K(x, inputs) @ alpha)[:, None]
            if mean_function is not None:
                y = y + mean_function(x)
            return y + _noise(x, noise, key)

        return evaluate_rkhs

    elif interpolation == "linear":
        # Host-side simplex interpolation (test utility, not a hot path).
        import scipy.interpolate

        def evaluate_linear(x, noise: bool = True, key: Optional[jax.Array]
                            = None):
            x = jnp.atleast_2d(jnp.asarray(x, dtype=dtype))
            y = scipy.interpolate.griddata(inputs_np, output_np,
                                           np.asarray(x), method="linear")
            y = jnp.atleast_2d(jnp.asarray(y, dtype=dtype).squeeze()).T
            if mean_function is not None:
                y = y + mean_function(x)
            return y + _noise(x, noise, key)

        return evaluate_linear

    raise ValueError(f"unknown interpolation mode: {interpolation!r}")
