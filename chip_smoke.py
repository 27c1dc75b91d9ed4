"""Smoke test: SafeOpt's main path on one NVIDIA GPU, checked end to end.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: sharded grid + fleet only

Phases (each raises on failure; there is no CPU fallback):

1. device      -- the backend must be the GPU; prints the card's name and
                  power limit, the JAX version and ``XLA_FLAGS``.
2. intervals   -- the grid interval pass at ``'highest'`` against the host
                  float64 posterior, at 1e6 rows, capacity 64 and 512,
                  RBF and the contextual product kernel, with its
                  in-program time.
3. flagship    -- two ``GPRegression`` (RBF, capacity 64, 50 obs) over a
                  1000 x 1000 grid, ``SafeOpt`` with default options, five
                  rounds of optimize -> plant -> add_new_data_point; every
                  round Q is compared with the host float64 posterior and
                  S/M/G with a float64 classification.
4. cap512      -- capacity 512 (500 obs): defaults take the plain path, the
                  device float64 oracle agrees with the host oracle, and
                  reduced precision is refused.
5. expander    -- the expander-stress configuration: chunks visited and
                  the time per chunk.
6. entry points-- 10-D SafeOptSwarm, run_safeopt_loop, a K=8 campaign
                  fleet, a sparse model step and a lag-1 campaign, each
                  against a reference.

The last line of standard output is one JSON object; everything else is
printed before it. The phase functions take their sizes as arguments so
the test suite can rehearse them on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# Scaled tolerance of float32 intervals against float64 truth. The f64
# certification protocol (SafeOpt boundary_band, default 1e-3) is sized
# on the assumption that float32 interval noise stays below that band,
# so the same bound is the pass/fail line here: a larger error would
# let a knife-edge decision escape certification.
Q_TOL = 1e-3
BOUNDARY_BAND = 1e-3
FMIN = (0.2, 0.5)
BETA = 2.0


def log(*args):
    """Print a progress line (flushed: the caller may only see the end)."""
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def build_gps(rng, n_obs, capacity, d=2, spread=1.5):
    """The benchmark's two RBF GPs: objective + one safety constraint."""
    from safeopt_tpu.gp import GPRegression, RBF

    X = rng.uniform(-spread, spread, size=(n_obs, d))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
          + 0.05 * rng.normal(size=n_obs))[:, None]
    Yg = (1.0 - 0.1 * np.sum(X ** 2, axis=1)
          + 0.05 * rng.normal(size=n_obs))[:, None]
    gp_f = GPRegression(X, Yf, RBF(d, variance=2.0, lengthscale=1.0),
                        noise_var=0.05 ** 2, capacity=capacity)
    gp_g = GPRegression(X, Yg, RBF(d, variance=1.0, lengthscale=1.5),
                        noise_var=0.05 ** 2, capacity=capacity)
    return gp_f, gp_g


def build_context_gps(rng, n_obs, capacity):
    """Two GPs with the reference's contextual kernel RBF(x) * RBF(ctx)."""
    from safeopt_tpu.gp import GPRegression, RBF

    gps = []
    for g in range(2):
        kern = (RBF(1, variance=2.0, lengthscale=1.0, active_dims=[0])
                * RBF(1, variance=1.0, lengthscale=1.5, active_dims=[1]))
        X = np.hstack([rng.uniform(-3.0, 3.0, size=(n_obs, 1)),
                       rng.uniform(-0.5, 0.5, size=(n_obs, 1))])
        Y = (2.0 - 0.5 * g) * np.exp(-0.5 * X[:, :1] ** 2)
        gps.append(GPRegression(X, Y, kern, noise_var=0.05 ** 2,
                                capacity=capacity))
    return gps


def plant(x):
    """Synthetic system measured at x: objective and constraint values."""
    x = np.asarray(x, dtype=float)
    r2 = float(np.sum(x ** 2))
    return np.array([2.0 * np.exp(-0.5 * r2), 1.0 - 0.1 * r2])


def grid_2d(n_side):
    """The benchmark's 2-D grid over [-5, 5]^2, ``n_side`` per axis."""
    from safeopt_tpu import linearly_spaced_combinations

    return linearly_spaced_combinations([(-5.0, 5.0)] * 2, n_side)


# ---------------------------------------------------------------------------
# references and measurement
# ---------------------------------------------------------------------------

def host_q(gps, points, beta, rows=65536):
    """(N, 2G) float64 intervals from each model's host oracle."""
    cols = []
    for g in gps:
        mu = np.empty(points.shape[0])
        var = np.empty(points.shape[0])
        for a in range(0, points.shape[0], rows):
            mu[a:a + rows], var[a:a + rows] = g.predict_f64(
                points[a:a + rows])
        sd = np.sqrt(np.maximum(var, 0.0))
        cols += [mu - beta * sd, mu + beta * sd]
    return np.stack(cols, axis=1)


def scaled_q_error(Q, Q64, scaling):
    """Max over rows of |Q - Q64| / scaling, per GP column pair."""
    s = np.repeat(np.asarray(scaling, float), 2)
    return float(np.max(np.abs(np.asarray(Q, np.float64) - Q64) / s))


def f64_step(gps, grid, fmin, scaling, threshold, chunk):
    """The fused step evaluated in float64 on the device.

    Uses each model's float64 oracle factors (the host factors), so it
    is the float64 classification S/M/G the float32 step is held to.
    """
    import jax
    import jax.numpy as jnp

    from safeopt_tpu.algorithms.safe_opt_core import safeopt_step
    from safeopt_tpu.gp.regression import GPState

    with jax.enable_x64(True):
        states = []
        for g in gps:
            o, _ = g.device_oracle_state()
            states.append(GPState(
                X=o.X, Y=jnp.zeros((o.capacity, 1), jnp.float64),
                count=o.count, L=o.F, Linv=o.F, w=o.w,
                noise_var=jnp.asarray(g.noise_var, jnp.float64)))
        kernels = tuple(jax.tree.map(
            lambda v: jnp.asarray(v, jnp.float64), g.kern) for g in gps)
        res = safeopt_step(
            kernels, tuple(states), jnp.asarray(grid, jnp.float64),
            jnp.asarray(fmin, jnp.float64), jnp.asarray(BETA, jnp.float64),
            jnp.asarray(scaling, jnp.float64),
            jnp.asarray(threshold, jnp.float64), chunk=chunk)
        return jax.device_get((res.Q, res.S, res.M, res.G, res.next_idx))


def check_decisions(S, M, G, Q64, ref, fmin, scaling, band):
    """Every S/M/G disagreement with float64 lies inside the band.

    S: a flipped row's scaled safety margin (float64) is below ``band``.
    M: a flipped row is an S flip or sits within ``band`` of the
    maximizer boundary ``u0 = best_l0``. G (one expander at most): a
    different pick is accepted only when S or M flipped somewhere or
    the two picks' scaled widths tie within ``band``.
    """
    Q_r, S_r, M_r, G_r, _ = ref
    fmin = np.asarray(fmin, float)
    scaling = np.asarray(scaling, float)
    l64, u64 = Q64[:, 0::2], Q64[:, 1::2]
    con = np.isfinite(fmin)
    margin = np.min(np.where(con, np.abs(l64 - fmin) / scaling, np.inf),
                    axis=1)
    s_flip = S != S_r
    bad_s = int(np.count_nonzero(s_flip & (margin >= band)))
    best_l0 = np.max(np.where(S_r, l64[:, 0], -np.inf))
    m_edge = np.abs(u64[:, 0] - best_l0) / scaling[0] < band
    m_flip = M != M_r
    bad_m = int(np.count_nonzero(m_flip & ~m_edge & ~s_flip))
    bad_g = 0
    if not np.array_equal(G, G_r):
        width = np.max((u64 - l64) / scaling, axis=1)
        w32 = width[G].max() if G.any() else -np.inf
        w64 = width[G_r].max() if G_r.any() else -np.inf
        tie = abs(w32 - w64) < band
        if not (tie or s_flip.any() or m_flip.any()):
            bad_g = 1
    counts = {"S_flips": int(s_flip.sum()), "M_flips": int(m_flip.sum()),
              "G_differs": bool(not np.array_equal(G, G_r)),
              "outside_band": bad_s + bad_m + bad_g}
    if counts["outside_band"]:
        raise AssertionError(f"decision flips outside the band: {counts}")
    return counts


def in_program_ms(fn, x0, reps=(1, 11), trials=3):
    """Device time of ``fn(x)`` by the in-program protocol.

    ``reps`` calls are chained inside one jit (each call's input is
    perturbed from the previous output, so nothing is elided), the
    whole output is consumed, a scalar is pulled, and the two counts
    are differenced: host dispatch and the pull cancel out.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(x, b, n):
        def body(i, carry):
            b, acc = carry
            tot = sum(jnp.max(o) for o in jax.tree.leaves(fn(x * b)))
            return b + (tot % 2) * 1e-12, acc + tot
        return jax.lax.fori_loop(0, n, body,
                                 (b, jnp.zeros((), b.dtype)))[1]

    one = jnp.asarray(1.0, x0.dtype)
    lo, hi = reps
    runs = {lo: [], hi: []}
    float(chained(x0, one, lo))
    float(chained(x0, one, hi))
    for t in range(trials):
        for n in (lo, hi):
            t0 = time.perf_counter()
            float(chained(x0, one * (1 + 1e-9 * (t + 1)), n))
            runs[n].append(time.perf_counter() - t0)
    return (min(runs[hi]) - min(runs[lo])) / (hi - lo) * 1e3


def blocking_ms(fn, reps):
    """Median host time of ``fn()`` (each call blocks on its result)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card() -> str:
    """``name, power.limit`` of the card(s) as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def phase_device(require_gpu=True):
    """The backend must be the GPU; print what it is."""
    import jax

    dev = jax.devices()[0]
    if require_gpu and dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {dev.platform!r})")
    smi = card()
    log(f"card: {smi}")
    log(f"jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"devices: {len(jax.devices())} x {dev.device_kind}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def phase_intervals(n_rows=10 ** 6, caps=(64, 512), check_rows=65536,
                    timing=True):
    """The grid interval pass (XLA, 'highest') vs host float64.

    1e6 rows, d=2, two GPs, capacity 64 and 512, RBF and the contextual
    product kernel; prints the in-program time of each pass.
    """
    import jax
    import jax.numpy as jnp

    from safeopt_tpu.algorithms.safe_opt_core import _confidence_intervals
    from safeopt_tpu.config import with_matmul_precision

    rng = np.random.default_rng(SEED)
    grid = rng.uniform(-5.0, 5.0, size=(n_rows, 2))
    sub = rng.choice(n_rows, size=min(check_rows, n_rows), replace=False)
    intervals = with_matmul_precision(_confidence_intervals)
    out = {}
    for cap in caps:
        n_obs = 50 if cap == 64 else cap - cap // 8
        configs = {"rbf": build_gps(np.random.default_rng(cap), n_obs, cap,
                                    spread=1.5 if cap <= 64 else 4.0),
                   "context": build_context_gps(
                       np.random.default_rng(cap + 1), n_obs, cap)}
        for name, gps in configs.items():
            kernels = tuple(g.kern for g in gps)
            states = tuple(g.state for g in gps)
            g_dev = jnp.asarray(grid, states[0].X.dtype)
            beta = jnp.asarray(BETA, g_dev.dtype)

            def q_of(g, kernels=kernels, states=states, beta=beta):
                return intervals(kernels, states, g, beta)[0]

            q = np.asarray(jax.jit(q_of)(g_dev))
            err = scaled_q_error(q[sub], host_q(gps, grid[sub], BETA),
                                 [np.sqrt(2.0), 1.0])
            key = f"cap{cap}_{name}"
            row = {"q_err": err}
            if not (np.isfinite(q).all() and err < Q_TOL):
                raise AssertionError(f"{key}: interval error {err} >= "
                                     f"{Q_TOL} (scaled, float32 'highest')")
            if timing:
                row["ms"] = in_program_ms(q_of, g_dev)
            out[key] = row
            log(f"intervals {key}: {json.dumps(row)}")
    return out


def _flagship_opts(n_side, cap, n_obs):
    from safeopt_tpu import SafeOpt

    gp_f, gp_g = build_gps(np.random.default_rng(SEED), n_obs, cap)
    grid = grid_2d(n_side)
    return SafeOpt([gp_f, gp_g], grid, fmin=list(FMIN)), [gp_f, gp_g], grid


def phase_flagship(n_side=1000, rounds=5, cap=64, n_obs=50, timing_reps=20):
    """Default SafeOpt rounds against float64, then blocking times."""
    import jax.numpy as jnp

    from safeopt_tpu.algorithms.safe_opt_core import safeopt_step

    opt, gps, grid = _flagship_opts(n_side, cap, n_obs)
    log(f"flagship: N={grid.shape[0]}, cap={cap}, oracle={opt._oracle}, "
        f"exact_boundaries={opt._exact_boundaries}")
    worst_q, flips, round_ms = 0.0, [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        x = opt.optimize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        Q64 = host_q(gps, grid, BETA)
        err = scaled_q_error(opt.Q, Q64, opt.scaling)
        if not err < Q_TOL:
            raise AssertionError(f"flagship round {r}: Q error {err} "
                                 f">= {Q_TOL}")
        worst_q = max(worst_q, err)
        ref = f64_step(gps, grid, FMIN, opt.scaling, [0.0, 0.0],
                       opt._expander_chunk)
        flips.append(check_decisions(opt.S, opt.M, opt.G, Q64, ref, FMIN,
                                     opt.scaling, BOUNDARY_BAND))
        opt.add_new_data_point(x, plant(x))
    out = {"q_err_max": worst_q, "flips": flips,
           "optimize_ms_rounds": round_ms}
    log(f"flagship: {json.dumps(out)}")

    kernels, states = opt._model_args()
    consts = opt._step_consts()
    args = (kernels, states, opt._grid(), consts["fmin"],
            jnp.asarray(BETA, opt._grid().dtype), consts["scaling"],
            consts["threshold"])
    compiled = safeopt_step.lower(*args,
                                  chunk=opt._expander_chunk).compile()
    log(f"flagship step memory_analysis: {compiled.memory_analysis()}")

    if timing_reps:
        out["optimize_ms"] = blocking_ms(opt.optimize, timing_reps)
        out["step_device_ms"] = in_program_ms(
            lambda g: safeopt_step(*args[:2], g, *args[3:],
                                   chunk=opt._expander_chunk),
            args[2])
        log(f"flagship: optimize() {out['optimize_ms']:.3f} ms (median of "
            f"{timing_reps}), device step {out['step_device_ms']:.3f} ms")
    return out


def phase_cap512(n_side=1000, cap=512, n_obs=500, check_rows=65536,
                 timing_reps=10):
    """Capacity 512: plain defaults, device oracle == host oracle."""
    from safeopt_tpu import SafeOpt

    def gps():
        rng = np.random.default_rng(SEED)
        return list(build_gps(rng, n_obs, cap, spread=4.0))

    grid = grid_2d(n_side)
    default = SafeOpt(gps(), grid, fmin=list(FMIN))
    if default._interval_precision is not None or default._exact_boundaries:
        raise AssertionError("cap512 defaults must take the plain path")
    try:
        SafeOpt(gps(), grid, fmin=list(FMIN), interval_precision="high")
    except ValueError as e:
        refused = str(e)
    else:
        from safeopt_tpu.config import platform
        if platform() == "gpu":
            raise AssertionError("interval_precision='high' was accepted "
                                 "on the GPU")
        refused = "(not refused: CPU backend)"

    x_d = default.optimize()
    rng = np.random.default_rng(SEED + 1)
    sub = rng.choice(grid.shape[0], size=min(check_rows, grid.shape[0]),
                     replace=False)
    q_err = scaled_q_error(default.Q[sub],
                           host_q(default.gps, grid[sub], BETA),
                           default.scaling)
    if not q_err < Q_TOL:
        raise AssertionError(f"cap512 Q error {q_err} >= {Q_TOL}")

    # boundary_k covers the whole band (about 1,400 rows here), so every
    # in-band verdict is certified by both oracles
    dev = SafeOpt(gps(), grid, fmin=list(FMIN), exact_boundaries=True,
                  oracle="device", boundary_k=4096)
    host = SafeOpt(gps(), grid, fmin=list(FMIN), exact_boundaries=True,
                   oracle="host", boundary_k=4096)
    x_dev, x_host = dev.optimize(), host.optimize()
    same = (np.array_equal(x_dev, x_host)
            and np.array_equal(dev.S, host.S)
            and np.array_equal(dev.M, host.M)
            and np.array_equal(dev.G, host.G))
    if not same:
        raise AssertionError("cap512: device oracle verdicts differ from "
                             "the host oracle's")
    out = {"q_err": q_err, "refused": refused, "oracle_match": True,
           "x_default": np.asarray(x_d).tolist(),
           "band_population": dev._band_population,
           "corrections": dev._certified_corrections}
    if timing_reps:
        out["optimize_ms_default"] = blocking_ms(default.optimize,
                                                 timing_reps)
        out["optimize_ms_device_oracle"] = blocking_ms(dev.optimize,
                                                       timing_reps)
    log(f"cap512: {json.dumps(out)}")
    return out


def expander_stress_config(n_side=128):
    """Walks many chunks: unsafe points exist but none can be expanded.

    The objective is unconstrained; the constraint GP has one
    observation at the origin and a cluster of low observations in one
    corner, ``fmin = -3``. The corner is unsafe; the wide prior region
    qualifies nearly every safe point as a candidate, and a virtual
    observation far from the corner cannot lift it, so the walk visits
    candidates in width order until it reaches the corner's neighbours.
    """
    from safeopt_tpu.gp import GPRegression, RBF

    rng = np.random.default_rng(1)
    X = rng.uniform(-4.0, 4.0, size=(50, 2))
    Yf = (2.0 * np.exp(-0.1 * np.sum(X ** 2, axis=1))
          + 0.02 * rng.normal(size=50))[:, None]
    gp_f = GPRegression(X, Yf, RBF(2, variance=2.0, lengthscale=1.0),
                        noise_var=0.05 ** 2, capacity=64)
    corner = -4.6 + 0.3 * rng.uniform(-1, 1, size=(8, 2))
    Xg = np.vstack([[[0.0, 0.0]], corner])
    Yg = np.vstack([[[0.0]], np.full((8, 1), -4.0)])
    gp_g = GPRegression(Xg, Yg, RBF(2, variance=1.0, lengthscale=1.0),
                        noise_var=0.05 ** 2, capacity=64)
    return (gp_f, gp_g), grid_2d(n_side), [-np.inf, -3.0]


def chunks_visited(Q, S, M, G, scaling, threshold, chunk):
    """Chunks the expander walk visited, from the step's own outputs."""
    l, u = Q[:, 0::2], Q[:, 1::2]
    width = u - l
    scaling = np.asarray(scaling, float)
    max_var = np.max(np.where(M, width[:, 0], -np.inf)) / scaling[0]
    cand = (S & ~M & (np.max(width / scaling, axis=1) > max_var)
            & np.any(width > threshold * BETA, axis=1))
    idx = np.flatnonzero(cand)
    key = np.max(width, axis=1)[idx]
    order = idx[np.lexsort((-idx, -key))]       # width desc, index desc
    if G.any():
        pos = int(np.flatnonzero(order == np.flatnonzero(G)[0])[0])
        return pos // chunk + 1, int(cand.sum())
    return -(-len(order) // chunk), int(cand.sum())


def phase_expander(n_side=128, chunk=32, timing=True):
    """Chunks the expander walk visits, and the device time per chunk.

    The time per chunk is the step's device time minus that of the same
    step without the walk (``ucb=True``), over the chunks visited.
    """
    import jax
    import jax.numpy as jnp

    from safeopt_tpu.algorithms.safe_opt_core import safeopt_step

    gps, grid, fmin = expander_stress_config(n_side)
    kernels = tuple(g.kern for g in gps)
    states = tuple(g.state for g in gps)
    dtype = states[0].X.dtype
    g_dev = jnp.asarray(grid, dtype)
    scaling = np.array([np.sqrt(2.0), 1.0])
    args = (jnp.asarray(fmin, dtype), jnp.asarray(BETA, dtype),
            jnp.asarray(scaling, dtype), jnp.asarray([0.0, 0.0], dtype))

    def step(g, ucb=False):
        return safeopt_step(kernels, states, g, *args, ucb=ucb, chunk=chunk)

    r = jax.device_get(step(g_dev))
    n_chunks, n_cand = chunks_visited(r.Q, r.S, r.M, r.G, scaling, 0.0,
                                      chunk)
    out = {"chunks": n_chunks, "candidates": n_cand,
           "unsafe": int((~r.S).sum()), "found": bool(r.G.any())}
    if n_chunks < 2:
        raise AssertionError(f"expander stress walked {n_chunks} chunk(s)")
    if timing:
        full = in_program_ms(step, g_dev)
        no_walk = in_program_ms(lambda g: step(g, ucb=True), g_dev)
        out.update(step_ms=full, no_walk_ms=no_walk,
                   ms_per_chunk=(full - no_walk) / n_chunks)
    log(f"expander: {json.dumps(out)}")
    return out


def phase_entry_points(swarm_iters=3, loop_side=1000, loop_iters=5,
                       fleet_k=8, sparse_n=2000, sparse_m=64,
                       sparse_side=1000, lag_iters=6):
    """The other entry points, a few iterations each, vs a reference."""
    import jax
    import jax.numpy as jnp

    from safeopt_tpu import SafeOpt, SafeOptSwarm, linearly_spaced_combinations
    from safeopt_tpu.algorithms.pipeline import run_lagged_campaign
    from safeopt_tpu.algorithms.runner import run_safeopt_loop
    from safeopt_tpu.gp import GPRegression, Matern32, RBF
    from safeopt_tpu.gp.sparse import SparseGPRegression
    from safeopt_tpu.parallel import (run_safeopt_campaigns,
                                      stack_campaign_states)

    out = {}

    # 10-D swarm: every query certified safe by the float64 host oracle.
    def swarm(seed=0):
        rng = np.random.default_rng(seed)
        d, n0 = 10, 5
        X = rng.uniform(-0.5, 0.5, size=(n0, d))
        Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
        Yg = (1.0 - 0.05 * np.sum(X ** 2, axis=1))[:, None]
        gps = [GPRegression(X, Yf, RBF(d, variance=2.0, lengthscale=2.0),
                            noise_var=0.01),
               GPRegression(X, Yg, Matern32(d, variance=1.0,
                                            lengthscale=3.0),
                            noise_var=0.01)]
        return SafeOptSwarm(gps, fmin=[-np.inf, 0.0],
                            bounds=[(-3.0, 3.0)] * d, swarm_size=20,
                            key=jax.random.key(seed))

    def swarm_plant(x):
        r2 = float(np.sum(np.asarray(x) ** 2))
        return np.array([2.0 * np.exp(-0.5 * r2), 1.0 - 0.05 * r2])

    opt = swarm()
    worst = np.inf
    for _ in range(swarm_iters):
        x = opt.optimize()
        mu, var = opt.gps[1].predict_f64(np.atleast_2d(x))
        worst = min(worst, float(mu[0] - opt.beta(opt.t) * np.sqrt(var[0])))
        opt.add_new_data_point(x, swarm_plant(x))
    if not worst > -BOUNDARY_BAND:
        raise AssertionError(f"swarm query not safe in float64: l={worst}")
    out["swarm_min_l64"] = worst

    # Lag-1 campaign: pipelined dispatch equals the blocking loop.
    xs_s, _ = run_lagged_campaign(swarm(1), swarm_plant, lag_iters,
                                  pipelined=False)
    xs_p, _ = run_lagged_campaign(swarm(1), swarm_plant, lag_iters,
                                  pipelined=True)
    if not np.array_equal(xs_s, xs_p):
        raise AssertionError("lagged campaign: pipelined != serial")
    out["lagged_match"] = True

    # On-device loop: the first query equals SafeOpt's; every query is
    # certified safe by a float64 model of the loop's own observations.
    gp_f, gp_g = build_gps(np.random.default_rng(SEED), 50, 64)
    grid = grid_2d(loop_side)
    dtype = gp_f.state.X.dtype

    def f_dev(x):
        return 2.0 * jnp.exp(-0.5 * jnp.sum(x * x))

    def g_dev(x):
        return 1.0 - 0.1 * jnp.sum(x * x)

    scaling = [np.sqrt(2.0), 1.0]
    res = run_safeopt_loop(
        (gp_f.kern, gp_g.kern), (gp_f.state, gp_g.state),
        jnp.asarray(grid, dtype), jnp.asarray(FMIN, dtype),
        jnp.asarray(BETA, dtype), jnp.asarray(scaling, dtype),
        jnp.asarray([0.0, 0.0], dtype), jax.random.key(0),
        objectives=(f_dev, g_dev), n_iter=loop_iters, noise_std=0.0,
        chunk=32)
    xs = np.asarray(res.xs)
    first = SafeOpt([gp_f, gp_g], grid, fmin=list(FMIN)).optimize()
    if not np.allclose(xs[0], first):
        raise AssertionError(f"loop first query {xs[0]} != {first}")
    Xo, Yo = gp_g.X_host.copy(), gp_g.Y_host.copy()
    for t in range(loop_iters):
        ref = GPRegression(Xo, Yo, gp_g.kern, noise_var=gp_g.noise_var,
                           capacity=64)
        mu, var = ref.predict_f64(xs[t:t + 1])
        l64 = float(mu[0] - BETA * np.sqrt(var[0]))
        if not l64 > FMIN[1] - BOUNDARY_BAND:
            raise AssertionError(f"loop query {t} unsafe in f64: {l64}")
        Xo = np.vstack([Xo, xs[t:t + 1]])
        Yo = np.vstack([Yo, [[plant(xs[t])[1]]]])
    out["loop_queries"] = loop_iters

    # Fleet of K campaigns in one program: each equals its solo run.
    kern = RBF(2, variance=2.0, lengthscale=1.2)
    small = np.asarray(linearly_spaced_combinations([(-2.0, 2.0)] * 2, 17))
    fleet_gps = []
    for k in range(fleet_k):
        x0 = np.random.default_rng(k).uniform(-0.3, 0.3, size=(1, 2))
        y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
        fleet_gps.append(GPRegression(x0, np.array([[y0]]), kern,
                                      noise_var=1e-4, capacity=16))
    fargs = (jnp.asarray(small, dtype), jnp.asarray([0.5], dtype),
             jnp.asarray(BETA, dtype), jnp.asarray([np.sqrt(2.0)], dtype),
             jnp.asarray([0.0], dtype))
    keys = jax.random.split(jax.random.key(7), fleet_k)
    fleet = run_safeopt_campaigns(
        (kern,), stack_campaign_states([(g.state,) for g in fleet_gps]),
        *fargs, keys, objectives=(f_dev,), n_iter=4, chunk=16)
    for k in range(fleet_k):
        solo = run_safeopt_loop((kern,), (fleet_gps[k].state,), *fargs,
                                keys[k], objectives=(f_dev,), n_iter=4,
                                chunk=16)
        if not np.array_equal(np.asarray(fleet.next_idx[k]),
                              np.asarray(solo.next_idx)):
            raise AssertionError(f"fleet campaign {k} != solo run")
    out["fleet_k"] = fleet_k

    # Sparse model: Q against its own float64 oracle, decisions in band.
    rng = np.random.default_rng(11)
    X = rng.uniform(-4.0, 4.0, size=(sparse_n, 2))
    Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
         + 0.05 * rng.normal(size=sparse_n))[:, None]
    sp = SparseGPRegression(X, Y, RBF(2, variance=2.0, lengthscale=1.0),
                            noise_var=0.05 ** 2, inducing=sparse_m)
    sgrid = grid_2d(sparse_side)
    sopt = SafeOpt(sp, sgrid, fmin=[0.2])
    sopt.optimize()
    sub = np.random.default_rng(3).choice(
        sgrid.shape[0], size=min(65536, sgrid.shape[0]), replace=False)
    q64 = host_q([sp], sgrid[sub], BETA)
    err = scaled_q_error(sopt.Q[sub], q64, [np.sqrt(2.0)])
    # The DTC pseudo-factor (max entry ~1e2 at this configuration)
    # amplifies float32 rounding in colsum(V^2), and sqrt amplifies it
    # again where the DTC variance is small: the same model in float32
    # on the CPU is 1.9e-3 (scaled) from float64. So the bound here is
    # ten times the exact model's.
    tol = 10 * Q_TOL
    if not err < tol:
        raise AssertionError(f"sparse Q error {err} >= {tol}")
    s_flip = sopt.S[sub] != np.all(q64[:, 0::2] > 0.2, axis=1)
    margin = np.abs(q64[:, 0] - 0.2) / np.sqrt(2.0)
    if np.any(s_flip & (margin >= tol)):
        raise AssertionError("sparse S flips outside the band")
    out["sparse_q_err"] = err
    log(f"entry points: {json.dumps(out)}")
    return out


def phase_four(n_rows=10 ** 7, cap=64, n_obs=50, fleet_per_card=8):
    """Four cards: a sharded 1e7-row grid and a 4 x 8 campaign fleet."""
    import jax
    import jax.numpy as jnp

    from safeopt_tpu import linearly_spaced_combinations
    from safeopt_tpu.algorithms.runner import run_safeopt_loop
    from safeopt_tpu.algorithms.safe_opt_core import safeopt_step
    from safeopt_tpu.gp import GPRegression, RBF
    from safeopt_tpu.parallel import (make_mesh, replicate,
                                      run_safeopt_campaigns, shard_grid,
                                      stack_campaign_states)

    n_dev = len(jax.devices())
    mesh = make_mesh(n_devices=n_dev)
    gp_f, gp_g = build_gps(np.random.default_rng(SEED), n_obs, cap)
    side = int(round(np.sqrt(n_rows)))
    grid = np.asarray(grid_2d(side))
    kernels = (gp_f.kern, gp_g.kern)
    states = (gp_f.state, gp_g.state)
    dtype = states[0].X.dtype
    consts = (jnp.asarray(FMIN, dtype), jnp.asarray(BETA, dtype),
              jnp.asarray([np.sqrt(2.0), 1.0], dtype),
              jnp.asarray([0.0, 0.0], dtype))

    one = jax.device_get(safeopt_step(kernels, states,
                                      jnp.asarray(grid, dtype), *consts,
                                      chunk=32))
    g_sh, pad = shard_grid(grid.astype(dtype), mesh)
    t0 = time.perf_counter()
    sh = safeopt_step(replicate(kernels, mesh), replicate(states, mesh),
                      g_sh, *replicate(consts, mesh),
                      num_valid=jnp.asarray(grid.shape[0], jnp.int32),
                      chunk=32)
    sh = jax.device_get(sh)
    n = grid.shape[0]
    mism = {k: int(np.count_nonzero(getattr(sh, k)[:n] != getattr(one, k)))
            for k in "SMG"}
    same_idx = int(sh.next_idx) == int(one.next_idx)
    log(f"four: grid {n} + {pad} pad over {n_dev} cards, mismatches "
        f"{mism}, next_idx {int(sh.next_idx)} vs {int(one.next_idx)}, "
        f"first call {time.perf_counter() - t0:.1f} s")
    if any(mism.values()) or not same_idx:
        raise AssertionError(f"sharded step != one-card step: {mism}")

    K = n_dev * fleet_per_card
    kern = RBF(2, variance=2.0, lengthscale=1.2)
    small = np.asarray(linearly_spaced_combinations([(-2.0, 2.0)] * 2, 17))
    fleet_gps = []
    for k in range(K):
        x0 = np.random.default_rng(k).uniform(-0.3, 0.3, size=(1, 2))
        y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
        fleet_gps.append(GPRegression(x0, np.array([[y0]]), kern,
                                      noise_var=1e-4, capacity=16))

    def f_dev(x):
        return 2.0 * jnp.exp(-0.5 * jnp.sum(x * x))

    fargs = (jnp.asarray(small, dtype), jnp.asarray([0.5], dtype),
             jnp.asarray(BETA, dtype), jnp.asarray([np.sqrt(2.0)], dtype),
             jnp.asarray([0.0], dtype))
    keys = jax.random.split(jax.random.key(7), K)
    fleet = run_safeopt_campaigns(
        (kern,), stack_campaign_states([(g.state,) for g in fleet_gps]),
        *fargs, keys, objectives=(f_dev,), n_iter=4, mesh=mesh, chunk=16)
    bad = []
    for k in range(K):
        solo = run_safeopt_loop((kern,), (fleet_gps[k].state,), *fargs,
                                keys[k], objectives=(f_dev,), n_iter=4,
                                chunk=16)
        if not np.array_equal(np.asarray(fleet.next_idx[k]),
                              np.asarray(solo.next_idx)):
            bad.append(k)
    log(f"four: fleet of {K} campaigns over {n_dev} cards, "
        f"{K - len(bad)} equal their solo runs")
    if bad:
        raise AssertionError(f"fleet campaigns {bad} differ from solo")
    return {"sharded_equal": True, "fleet_equal": K}


def _check_checkout():
    """Refuse to run without the repository beside this script."""
    here = os.path.dirname(os.path.abspath(__file__))
    import safeopt_tpu

    pkg = os.path.dirname(os.path.abspath(safeopt_tpu.__file__))
    if os.path.dirname(pkg) != here:
        raise SystemExit(f"chip_smoke: safeopt_tpu imported from {pkg}, "
                         f"not from this checkout ({here})")


def main(argv=None):
    """Run the phases; the last line printed is the JSON result."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card sharded grid and "
                             "fleet, against their one-card runs")
    args = parser.parse_args(argv)

    _check_checkout()
    from safeopt_tpu.config import enable_compile_cache

    info = phase_device()
    if args.four and info["count"] != 4:
        raise SystemExit(f"--four needs 4 cards, found {info['count']}")
    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_intervals()
        phase_flagship()
        phase_cap512()
        phase_expander()
        phase_entry_points()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))


if __name__ == "__main__":
    sys.exit(main())
