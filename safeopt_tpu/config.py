"""Global configuration for safeopt_tpu.

The library is dtype-polymorphic: on the GPU the default compute dtype
is float32, while golden/parity tests run on CPU with
``jax.config.update('jax_enable_x64', True)`` for float64 exactness.

Reference parity: befelix/SafeOpt runs GPy in float64 throughout; the
decisions that matter (safe-set membership, expander/maximizer argmax)
are interval comparisons, validated against an in-repo float64 NumPy
reference implementation in ``tests/reference_impl.py``.

This module is also the one place that decides which platform the
program runs on (:func:`platform`) and where the persistent compile
cache lives (:func:`enable_compile_cache`).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

__all__ = ["default_dtype", "JITTER", "MATMUL_PRECISION",
           "with_matmul_precision", "platform", "enable_compile_cache"]

# Jitter added to prior covariance in sample_gp_function
# (reference: utilities.py:89 adds 1e-6 * I).
JITTER = 1e-6

# An f32 matmul on the GPU runs in TF32 (about three decimal digits)
# unless a precision is asked for; safe-set membership is an interval
# comparison, so every decision-path matmul runs at 'highest', which
# XLA:GPU and the Triton kernels lower to exact IEEE float32. No effect
# on the CPU.
MATMUL_PRECISION = "highest"

_PLATFORMS = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu"}


def platform() -> str:
    """The backend the program runs on: ``'gpu'`` or ``'cpu'``.

    Every choice that depends on the machine (kernel dispatch, interpret
    mode, precision policy, oracle placement) reads this one function.
    Any other backend raises: the program has no path for it.
    """
    backend = jax.default_backend()
    try:
        return _PLATFORMS[backend]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX backend {backend!r}: safeopt_tpu runs on an "
            "NVIDIA GPU or on the CPU") from None


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here. Otherwise the cache lives in
    ``<repo>/.jax_cache`` (ignored by git), a fixed path so that a
    rerun from the same checkout hits it.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[1] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def default_dtype() -> jnp.dtype:
    """Return the default floating dtype (f64 when x64 is enabled)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def with_matmul_precision(fn):
    """Trace-time wrapper pinning matmul precision for a jitted body."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(MATMUL_PRECISION):
            return fn(*args, **kwargs)

    return wrapped
