"""Measure exact top-k strategies over a 1e6-point grid on the device.

The fused SafeOpt step runs full-grid ``lax.top_k`` selects (XLA may
lower one long row to a monolithic sort-based select). Candidate
replacement: a two-level *exact* hierarchy —
reshape the (padded) key row-major to (R, C), per-row ``top_k`` of k,
then one merge ``top_k`` of k over the R*k survivors.  Per-row calls
vectorize across rows and the merge input is tiny, so both
levels are cheap; exactness and tie order are preserved (see
safeopt_tpu/ops/topk.py).

Timing protocol (CLAUDE.md): repetition INSIDE one jit via
``lax.fori_loop`` with the operand perturbed from the carry, consume
with a reduction over values AND indices, pull one scalar, difference
reps=1 vs reps=9.
"""

import _bootstrap  # noqa: F401  (sys.path for checkout runs)
import time

import jax
import jax.numpy as jnp
import numpy as np

from safeopt_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

N = 1_000_000
K = 32


def flat_topk(key, k):
    return jax.lax.top_k(key, k)


def hier_topk(key, k, rows):
    n = key.shape[0]
    cols = -(-n // rows)
    pad = rows * cols - n
    keyp = jnp.pad(key, (0, pad), constant_values=-jnp.inf)
    km = min(k, cols)
    v1, i1 = jax.lax.top_k(keyp.reshape(rows, cols), km)   # (R, km)
    base = (jnp.arange(rows, dtype=jnp.int32) * cols)[:, None]
    flat_idx = (base + i1).reshape(-1)
    v2, j = jax.lax.top_k(v1.reshape(-1), k)
    return v2, jnp.take(flat_idx, j)


_BASE = None


def timed(fn, reps):
    """elapsed seconds for `reps` in-program iterations of fn.

    Every real dispatch gets a DISTINCT input: the runtime elides
    duplicate same-input dispatches entirely (CLAUDE.md), so timing a
    repeat call of prog(key0) measures nothing.
    """
    global _BASE
    if _BASE is None:
        _BASE = jnp.asarray(np.random.default_rng(0).normal(size=(N,)),
                            jnp.float32)

    @jax.jit
    def prog(key0):
        def body(i, carry):
            key, acc = carry
            v, idx = fn(key)
            acc = acc + jnp.max(v) + jnp.sum(idx % 7)
            # perturb the operand from the carry so nothing is elided
            key = key + (acc.astype(key.dtype) % 2) * 1e-12
            return key, acc
        _, acc = jax.lax.fori_loop(0, reps, body, (key0, jnp.float32(0)))
        return acc

    float(prog(_BASE))                          # warmup/compile
    best = np.inf
    for j in range(1, 4):
        key = _BASE * (1.0 + j * 1e-6)          # fresh input per timing
        jax.block_until_ready(key)
        t0 = time.perf_counter()
        float(prog(key))            # actual device->host scalar pull
        best = min(best, time.perf_counter() - t0)
    return best


def per_call_ms(name, fn):
    t1 = timed(fn, 1)
    t17 = timed(fn, 17)
    ms = (t17 - t1) / 16 * 1e3
    print(f"{name:24s} {ms:8.3f} ms   (t1={t1*1e3:7.2f}  t17={t17*1e3:7.2f})")
    return ms


def sort_full(key):
    v = jnp.sort(key)
    return v[-K:], jnp.zeros((K,), jnp.int32)


def argmax_only(key):
    i = jnp.argmax(key)
    return key[i][None], i[None].astype(jnp.int32)


if __name__ == "__main__":
    print("device:", jax.devices()[0])
    # calibration: a 1e6-row elementwise pass (read+write 4 MB each)
    per_call_ms("calib_exp", lambda k: (jnp.exp(k * 1e-3), jnp.zeros(
        (1,), jnp.int32)))
    per_call_ms("calib_argmax", argmax_only)
    per_call_ms("calib_sort_1e6", sort_full)
    per_call_ms("flat_k32", lambda k: flat_topk(k, K))
    for rows in (256, 1024, 4096):
        per_call_ms(f"hier_k32_r{rows}",
                    lambda k, r=rows: hier_topk(k, K, r))
    per_call_ms("flat_k128", lambda k: flat_topk(k, 128))
    per_call_ms("hier_k128_r1024", lambda k: hier_topk(k, 128, 1024))
    # flip variant used by _next_chunk (tie order)
    per_call_ms("hier_flip_k32_r1024",
                lambda k: hier_topk(jnp.flip(k), K, 1024))
