"""The fused step's grid interval pass against the float64 oracle.

``safe_opt_core._confidence_intervals`` computes every GP's
``l, u = mu -+ beta * sigma`` over the candidate grid, either keeping
``V = Linv @ K(X, grid)`` for the expander or, above a device-memory
bound, chunked over the grid. Both forms must equal the host float64
posterior for every kernel family, capacity and input dimension.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

import safeopt_tpu.algorithms.safe_opt_core as core
from safeopt_tpu.config import default_dtype
from safeopt_tpu.gp import (Bias, Cosine, Exponential, GPRegression, Linear,
                            MLP, Matern32, Matern52, Poly, RBF, White)
from safeopt_tpu.utils import linearly_spaced_combinations


def _kernels():
    return [
        ("rbf", lambda: RBF(2, variance=2.0, lengthscale=0.8)),
        ("rbf_ard", lambda: RBF(2, variance=1.5, lengthscale=[0.5, 1.5],
                                ARD=True)),
        ("matern32", lambda: Matern32(2, variance=3.0, lengthscale=1.2)),
        ("matern52", lambda: Matern52(2, variance=1.5, lengthscale=0.9)),
        ("exponential", lambda: Exponential(2, variance=1.2,
                                            lengthscale=0.7)),
        ("cosine", lambda: Cosine(1, variance=1.3, lengthscale=1.7,
                                  active_dims=[0])
         * RBF(1, lengthscale=2.0, active_dims=[1])),
        # the reference's contextual kernel (context_example notebook)
        ("context", lambda: RBF(1, variance=2.0, lengthscale=0.7,
                                active_dims=[0])
         * RBF(1, variance=1.0, lengthscale=1.3, active_dims=[1])),
        ("product_mixed", lambda: Matern32(2, variance=1.5,
                                           lengthscale=[0.9, 1.8], ARD=True)
         * RBF(1, variance=0.8, lengthscale=0.5, active_dims=[1])),
        ("active_subset", lambda: RBF(1, variance=2.0, lengthscale=0.6,
                                      active_dims=[1])),
        ("sum_bias", lambda: RBF(2, variance=1.5) + Bias(2, variance=0.3)),
        ("sum_white", lambda: RBF(2, variance=1.5) + White(2,
                                                           variance=0.01)),
        ("linear", lambda: Linear(2, variances=[0.5, 1.5], ARD=True)),
        ("poly", lambda: Poly(2, variance=0.5, order=2)),
        ("mlp", lambda: MLP(2, variance=1.0)),
    ]


def _intervals(kern, state, grid, beta=2.0):
    Q = core._confidence_intervals(
        (kern,), (state,), jnp.asarray(grid, state.X.dtype),
        jnp.asarray(beta, state.X.dtype))[0]
    return np.asarray(Q[:, 0]), np.asarray(Q[:, 1])


def _f64(gp, grid, beta=2.0):
    mu, var = gp.predict_f64(grid)
    sd = np.sqrt(var)
    return mu - beta * sd, mu + beta * sd


@pytest.mark.parametrize("name,make", _kernels(),
                         ids=[n for n, _ in _kernels()])
def test_interval_pass_matches_host_f64(name, make):
    kern = make()
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, size=(11, 2))
    Y = rng.normal(size=(11, 1))
    gp = GPRegression(X, Y, kern, noise_var=0.01)
    grid = rng.uniform(-3, 3, size=(300, 2))
    l, u = _intervals(kern, gp.state, grid)
    l64, u64 = _f64(gp, grid)
    assert_allclose(l, l64, rtol=1e-8, atol=1e-9)
    assert_allclose(u, u64, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("capacity,d,n_obs", [
    (16, 1, 10), (64, 2, 50), (100, 2, 90), (128, 3, 120), (64, 4, 40),
    (512, 2, 500)])
def test_interval_pass_capacities_and_dims(capacity, d, n_obs):
    """Capacities from 16 to 512 (including one that is not a power of
    two), partly filled buffers, and input dims 1 to 4."""
    rng = np.random.default_rng(capacity + d)
    X = rng.uniform(-3, 3, size=(n_obs, d))
    Y = np.sin(X).sum(axis=1, keepdims=True)
    kern = RBF(d, variance=2.0, lengthscale=1.2)
    gp = GPRegression(X, Y, kern, noise_var=0.05 ** 2, capacity=capacity)
    assert gp.state.capacity == capacity
    grid = rng.uniform(-4, 4, size=(257, d))
    l, u = _intervals(kern, gp.state, grid)
    l64, u64 = _f64(gp, grid)
    assert_allclose(l, l64, rtol=1e-7, atol=1e-8)
    assert_allclose(u, u64, rtol=1e-7, atol=1e-8)


def _chunk_problem(make):
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, size=(30, 2))
    Y = (np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    gp = GPRegression(X, Y, make(), noise_var=1e-3, capacity=64)
    grid = jnp.asarray(
        linearly_spaced_combinations([(-2., 2.), (-2., 2.)], 30),
        default_dtype())
    dtype = default_dtype()
    args = ((gp.kern,), (gp.state,), grid,
            jnp.asarray([0.2], dtype), jnp.asarray(2.0, dtype),
            jnp.asarray([1.0], dtype), jnp.asarray([0.0], dtype))
    return args


@pytest.mark.parametrize("make", [
    lambda: RBF(2),
    lambda: RBF(1, active_dims=[0]) * RBF(1, active_dims=[1]),
    lambda: Matern52(2) + Bias(2, variance=0.2)],
    ids=["rbf", "context", "sum"])
def test_chunked_posterior_matches_unchunked(monkeypatch, make):
    """With the V-size limit forced tiny, the chunked interval pass (and
    the expander's chunked cross terms) reproduce the unchunked
    decisions exactly: the memory bound cannot change results."""
    args = _chunk_problem(make)
    ref = core.safeopt_step(*args, chunk=8)
    monkeypatch.setattr(core, "_V_BYTES_LIMIT", 1)
    monkeypatch.setattr(core, "_CHUNK_ROWS", 128)
    core.safeopt_step._clear_cache()
    try:
        chunked = core.safeopt_step(*args, chunk=8)
    finally:
        core.safeopt_step._clear_cache()
    assert_allclose(np.asarray(chunked.Q), np.asarray(ref.Q), rtol=1e-10,
                    atol=1e-12)
    np.testing.assert_array_equal(np.asarray(chunked.S), np.asarray(ref.S))
    np.testing.assert_array_equal(np.asarray(chunked.G), np.asarray(ref.G))
    assert int(chunked.next_idx) == int(ref.next_idx)


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_v_limit_follows_device_memory(monkeypatch):
    monkeypatch.setattr(core.jax, "local_devices",
                        lambda: [_Device({"bytes_limit": 64 << 30})])
    assert core._v_bytes_limit() == int((64 << 30)
                                        * core._V_MEMORY_FRACTION)


@pytest.mark.parametrize("stats", [None, {}], ids=["none", "empty"])
def test_v_limit_falls_back_without_stats(monkeypatch, stats):
    """The CPU backend reports no memory limit: the fixed bound holds."""
    monkeypatch.setattr(core.jax, "local_devices", lambda: [_Device(stats)])
    assert core._v_bytes_limit() == core._V_BYTES_LIMIT
