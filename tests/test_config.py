"""The one-place platform decision, the compile cache, and precision.

``config.platform`` is the only function that decides which machine the
program runs on; ``config.enable_compile_cache`` the only place that
sets the persistent cache. Every decision-path program must trace its
matmuls at ``config.MATMUL_PRECISION`` ('highest'): on the GPU an f32
dot without it runs in TF32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safeopt_tpu import config, linearly_spaced_combinations
from safeopt_tpu.gp import GPRegression, Matern32, RBF


@pytest.mark.parametrize("backend,expected", [
    ("cpu", "cpu"), ("gpu", "gpu"), ("cuda", "gpu")])
def test_platform_maps_backends(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert config.platform() == expected


@pytest.mark.parametrize("backend", ["rocm", "METAL", "interpreter"])
def test_platform_rejects_other_backends(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        config.platform()


def test_platform_of_this_session():
    assert config.platform() == "cpu"


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.enable_compile_cache() == str(tmp_path)
    # nothing is set in code when the variable names the cache
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = config.enable_compile_cache()
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


# ---------------------------------------------------------------------------
# every dot of every decision-path program carries HIGHEST
# ---------------------------------------------------------------------------

def _problem():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(5, 2))
    gp_f = GPRegression(X, np.sum(X, axis=1, keepdims=True), RBF(2),
                        noise_var=0.01, capacity=16)
    gp_g = GPRegression(X, 1.0 - np.sum(X ** 2, axis=1, keepdims=True),
                        Matern32(2), noise_var=0.01, capacity=16)
    grid = jnp.asarray(linearly_spaced_combinations([(-1.0, 1.0)] * 2, 8))
    consts = (jnp.asarray([-np.inf, 0.0]), jnp.asarray(2.0),
              jnp.asarray([1.0, 1.0]), jnp.asarray([0.0, 0.0]))
    return (gp_f, gp_g), grid, consts


def _lower_safeopt_step():
    from safeopt_tpu.algorithms.safe_opt_core import safeopt_step

    gps, grid, c = _problem()
    return safeopt_step.lower(tuple(g.kern for g in gps),
                              tuple(g.state for g in gps), grid, *c,
                              chunk=8)


def _lower_certified_scan():
    from safeopt_tpu.algorithms.safe_opt_core import certified_scan

    gps, grid, c = _problem()
    return certified_scan.lower(tuple(g.kern for g in gps),
                                tuple(g.state for g in gps), grid, *c,
                                jnp.asarray(1e-3), k=8, chunk=8)


def _lower_interval_scan():
    from safeopt_tpu.algorithms.safe_opt_core import interval_scan

    gps, grid, c = _problem()
    return interval_scan.lower(tuple(g.kern for g in gps),
                               tuple(g.state for g in gps), grid, c[0],
                               c[1], c[2], jnp.asarray(1e-3), k=8)


def _lower_safe_maximum():
    from safeopt_tpu.algorithms.safe_opt_core import safe_maximum

    gps, grid, c = _problem()
    return safe_maximum.lower(tuple(g.kern for g in gps),
                              tuple(g.state for g in gps), grid, c[0], c[1])


def _lower_runner():
    from safeopt_tpu.algorithms.runner import run_safeopt_loop

    gps, grid, c = _problem()

    def f(x):
        return jnp.sum(x)

    return run_safeopt_loop.lower(
        tuple(g.kern for g in gps), tuple(g.state for g in gps), grid, *c,
        jax.random.key(0), objectives=(f, f), n_iter=2, chunk=8)


def _lower_swarm():
    from safeopt_tpu import SafeOptSwarm
    from safeopt_tpu.algorithms.swarm_opt_fused import fused_swarm_optimize

    gps, _, _ = _problem()
    opt = SafeOptSwarm(list(gps), fmin=[-np.inf, 0.0],
                       bounds=[(-1.0, 1.0)] * 2, swarm_size=8,
                       key=jax.random.key(0))
    args, kwargs = opt._fused_args()
    return fused_swarm_optimize.lower(*args, **kwargs)


def _lower_gp_update():
    from safeopt_tpu.gp.regression import gp_append

    gps, _, _ = _problem()
    g = gps[0]
    return gp_append.lower(g.kern, g.state, jnp.zeros(2), jnp.asarray(0.5))


@pytest.mark.parametrize("lower", [
    _lower_safeopt_step, _lower_certified_scan, _lower_interval_scan,
    _lower_safe_maximum, _lower_runner, _lower_swarm, _lower_gp_update],
    ids=["safeopt_step", "certified_scan", "interval_scan", "safe_maximum",
         "run_safeopt_loop", "fused_swarm", "gp_append"])
def test_every_dot_is_highest(lower):
    text = lower().as_text()
    dots = [line for line in text.splitlines() if "dot_general" in line]
    assert dots, "program has no matmul to check"
    loose = [line.strip() for line in dots if "HIGHEST" not in line]
    assert not loose, f"dots without HIGHEST precision: {loose[:3]}"
