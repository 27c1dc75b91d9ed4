"""Expander-walk chunk sweep at the flagship config (cap=64, n=50).

The expander while_loop is a share of the flagship step. Each walk round pays one full-grid pass (gram
cap x N per GP + rank-1 cross terms, ~chunk-weakly-dependent) — so if
the walk runs multiple rounds, a larger chunk trades a slightly
heavier round for fewer rounds with BIT-IDENTICAL results (the visit
order and first-success winner don't depend on the chunking).

Measures: walk round count at this config (host replica of the loop),
then the full step at chunk in {32, 64, 128, 256}.
"""

import _bootstrap  # noqa: F401
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from safeopt_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from safeopt_tpu import linearly_spaced_combinations
from safeopt_tpu.algorithms import safe_opt_core as core
from safeopt_tpu.gp import GPRegression, RBF

rng = np.random.default_rng(0)
n_obs, cap = 50, 64
grid_np = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 1000)
X = rng.uniform(-1.5, 1.5, size=(n_obs, 2))
Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
      + 0.05 * rng.normal(size=n_obs))[:, None]
Yg = (1.0 - 0.1 * np.sum(X ** 2, axis=1)
      + 0.05 * rng.normal(size=n_obs))[:, None]
gp_f = GPRegression(X, Yf, RBF(2, variance=2.0, lengthscale=1.0),
                    noise_var=0.05 ** 2, capacity=cap)
gp_g = GPRegression(X, Yg, RBF(2, variance=1.0, lengthscale=1.5),
                    noise_var=0.05 ** 2, capacity=cap)

kernels = (gp_f.kern, gp_g.kern)
states = (gp_f.state, gp_g.state)
dtype = states[0].X.dtype
grid_dev = jnp.asarray(grid_np, dtype)
fmin = jnp.asarray([0.2, 0.5], dtype)
scaling = jnp.asarray([np.sqrt(2.0), 1.0], dtype)
threshold = jnp.asarray([0.0, 0.0], dtype)
N = grid_dev.shape[0]
BETA = jnp.asarray(2.0, dtype)


def walk_rounds(chunk):
    """Host replica of the walk: visit candidates in reference order,
    evaluate the chunk predicate eagerly, count rounds to first hit."""
    from safeopt_tpu.config import MATMUL_PRECISION
    with jax.default_matmul_precision(MATMUL_PRECISION):
        valid = jnp.ones((N,), bool)
        Q, mus, sigmas, Vs = core._confidence_intervals(
            kernels, states, grid_dev, BETA)
        S, M, cand, width, has_safe = core._classify(
            Q, fmin, scaling, threshold, BETA, valid)
        unsafe = valid & ~S
        order = np.lexsort((-np.arange(N), -np.asarray(width)))
        order = order[np.asarray(cand)[order]]
        rounds = 0
        for p in range(0, min(order.shape[0], 64 * chunk), chunk):
            gidx = jnp.asarray(order[p:p + chunk], jnp.int32)
            if gidx.shape[0] < chunk:
                gidx = jnp.pad(gidx, (0, chunk - gidx.shape[0]))
            vmask = jnp.arange(chunk) < min(chunk, order.shape[0] - p)
            pred = core._chunk_expander_predicate(
                kernels, states, grid_dev, Q, unsafe, mus, sigmas, Vs,
                fmin, BETA, None, gidx, vmask)
            rounds += 1
            if bool(jnp.any(pred)):
                break
        return int(np.asarray(cand).sum()), rounds


def timed_step(chunk, reps):
    def body(i, carry):
        b, acc = carry
        r = core.safeopt_step(kernels, states, grid_dev * b, fmin, BETA,
                              scaling, threshold, chunk=chunk)
        tot = (r.next_idx.astype(jnp.float32)
               + r.safe_count.astype(jnp.float32) + jnp.max(r.Q))
        return b + (tot % 2) * 1e-12, acc + tot

    @jax.jit
    def prog(g0):
        return jax.lax.fori_loop(0, reps, body,
                                 (g0, jnp.zeros((), jnp.float32)))[1]

    one = jnp.asarray(1.0, dtype)
    float(prog(one))
    best = np.inf
    for k in range(3):
        g = one * (1 + 1e-9 * (k + 1))
        t0 = time.perf_counter()
        float(prog(g))
        best = min(best, time.perf_counter() - t0)
    return best


if __name__ == "__main__":
    print("device:", jax.devices()[0], flush=True)
    ncand, rounds = walk_rounds(32)
    print(f"candidates={ncand} rounds(chunk=32)={rounds}", flush=True)
    out = {"candidates": ncand, "rounds_chunk32": rounds}
    for chunk in (32, 64, 128, 256):
        t1 = timed_step(chunk, 1)
        t9 = timed_step(chunk, 9)
        ms = (t9 - t1) / 8 * 1e3
        print(f"chunk={chunk:4d}  {ms:7.3f} ms  "
              f"(t1={t1*1e3:6.1f} t9={t9*1e3:6.1f})", flush=True)
        out[f"step_chunk{chunk}_ms"] = round(ms, 3)
    print(json.dumps(out))
