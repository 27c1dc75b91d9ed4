"""partial_top_k strategy sweep at large k over a 1e6-row key.

The refine selection needs top-(band_k + rk) = top-9216 of 1e6. The
hierarchy's default row pick (cols = max(2k, 256)) was tuned at k<=128;
at k ~ 1e3-1e4 the level-1 per-row selection approaches a full sort
and the survivor set only halves per level. This sweeps the
alternatives on hardware:

  mono    jax.lax.top_k (monolithic sort-based select)
  c2      hierarchy, cols ~ 2k (current default)
  c4/c8   hierarchy, cols ~ 4k / 8k (fewer survivors per level)
  sortcut full jnp.sort + slice (reference: what mono should beat)

Timing: CLAUDE.md protocol — reps inside one jit, carry-perturbed key,
scalar consumed, reps=1 vs reps=9 differenced.
"""

import _bootstrap  # noqa: F401
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from safeopt_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import bench  # noqa: E402

from safeopt_tpu.ops.topk import partial_top_k

N = 1_000_000


def variants(k):
    out = {"mono": lambda key: jax.lax.top_k(key, k)}
    for mult, name in ((2, "c2"), (4, "c4"), (8, "c8")):
        rows = max(1, N // max(mult * k, 256))
        out[name] = (lambda key, r=rows: partial_top_k(key, k, rows=r))
    return out


def timed(fn, key0):
    @jax.jit
    def prog(key, reps):
        def body(i, carry):
            kk, acc = carry
            v, idx = fn(kk)
            acc = acc + jnp.sum(v) + jnp.sum(idx).astype(jnp.float32)
            kk = kk + (acc % 2) * 1e-9
            return kk, acc
        return jax.lax.fori_loop(0, reps, body,
                                 (key, jnp.zeros((), jnp.float32)))[1]

    float(prog(key0, 1))
    t0 = time.perf_counter()
    float(prog(key0 * (1 + 1e-9), 1))
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(prog(key0 * (1 + 2e-9), 9))
    t9 = time.perf_counter() - t0
    return (t9 - t1) / 8 * 1e3


def main():
    bench._wait_for_backend()
    print("device:", jax.devices()[0], flush=True)
    rng = np.random.default_rng(0)
    key0 = jnp.asarray(rng.normal(size=N).astype(np.float32))
    ref_v, ref_i = jax.lax.top_k(key0, 9216)
    ref = (np.asarray(ref_v), np.asarray(ref_i))
    out = {}
    for k in (1024, 8192, 9216):
        for name, fn in variants(k).items():
            tag = f"k{k}_{name}"
            try:
                if k == 9216 and name != "mono":
                    v, i = fn(key0)
                    ok = bool(np.array_equal(np.asarray(v), ref[0])
                              and np.array_equal(np.asarray(i), ref[1]))
                    out[tag + "_exact"] = ok
                ms = timed(fn, key0)
                out[tag] = round(ms, 3)
                print(f"{tag:16s} {ms:8.3f} ms", flush=True)
            except Exception as e:  # pragma: no cover - probe
                out[tag] = f"fail: {type(e).__name__}"
                print(f"{tag:16s} FAILED {type(e).__name__}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
