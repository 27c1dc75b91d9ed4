"""Fully-fused SafeOptSwarm iteration: one device program per optimize().

The stepwise path (swarm_opt.py) mirrors the reference's host
orchestration — validate safe set, init particles, run swarm, grow
safe set, query posteriors — which costs ~15 host<->device round trips
per ``optimize()``, each a synchronisation the device waits on.

This module lifts the entire iteration — all three swarms (greedy,
maximizers, expanders), safe-set validation/pruning/growth, and the
final maximizer-vs-expander choice — into one jitted program over a
*device-resident* padded safe-set buffer. The host dispatches once and
pulls one small diagnostics tuple.

Semantics replicated from the reference (gp_opt.py:1015-1177):
- re-validate stored safe points per swarm; prune unsafe ones only when
  at least ``swarm_size`` safe points remain (order-preserving
  compaction), never prune below swarm size;
- particle init uniformly from the safe set; the greedy swarm swaps in
  the previous greedy estimate, the most recent observation, and the
  best observation;
- safe-set growth by greedy covariance dedup (accept a best position
  iff its normalized covariance to every previously accepted point is
  <= 0.95), applied after the maximizers and expanders swarms;
- the greedy estimate moves when the swarm beat the old lower bound;
- expander stds below threshold / unconstrained GPs zeroed, both
  scaled, larger max wins (gp_opt.py:1161-1177).

Empty-safe-set handling: the program never raises on device — each
phase reports its safe count and gates all state updates on
``has_safe``, and the host raises the reference's RuntimeError after
the (single) pull.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import with_matmul_precision
from ..gp.regression import gp_predict
from .swarm_core import swarm_scan
from .swarm_opt import _particle_fitness

__all__ = ["SwarmIterState", "SwarmIterOut", "fused_swarm_optimize"]


class SwarmIterState(NamedTuple):
    """Device-resident SafeOptSwarm state."""

    S: jnp.ndarray             # (cap, d) padded safe-set points
    count: jnp.ndarray         # () int32 active rows
    greedy: jnp.ndarray        # (d,) running best-lower-bound location


class SwarmIterOut(NamedTuple):
    """Diagnostics of a fused iteration.

    ``diag`` packs every host-needed small output into ONE flat array
    so the per-iteration device->host pull is a single buffer (each
    separate buffer costs its own round trip). Layout, with
    d = input_dim:

        [0:d]         x_next          [5d]      best_lower_bound
        [d:2d]        x_maxi          [5d+1]    std_maxi
        [2d:3d]       x_exp           [5d+2]    std_exp
        [3d:4d]       x_greedy        [5d+3:+3] num_safe (3)
        [4d:5d]       greedy_point    [5d+6:+3] num_pruned (3)
                                      [5d+9:+2] num_added (2)
                                      [5d+11]   safe-set count
    """

    x_next: jnp.ndarray        # (d,) chosen query point
    state: SwarmIterState      # updated device state
    best_lower_bound: jnp.ndarray
    num_safe: jnp.ndarray      # (3,) per-phase safe counts (0 => raise)
    num_pruned: jnp.ndarray    # (3,) per-phase pruned counts (warn)
    num_added: jnp.ndarray     # (2,) growth per non-greedy swarm
    std_maxi: jnp.ndarray      # scaled max std of the maximizer
    std_exp: jnp.ndarray       # scaled max std of the expander
    x_maxi: jnp.ndarray        # (d,)
    x_exp: jnp.ndarray
    x_greedy: jnp.ndarray      # (d,) greedy swarm's best (reference
                               # stores it as ``self.greedy``)
    diag: jnp.ndarray          # (5d+12,) single-pull packed outputs


def _pack_diag(x_next, x_maxi, x_exp, x_greedy, greedy_point, blb,
               std_maxi, std_exp, num_safe, num_pruned, num_added, count):
    dtype = x_next.dtype
    return jnp.concatenate([
        x_next, x_maxi, x_exp, x_greedy, greedy_point,
        jnp.stack([blb, std_maxi, std_exp]).astype(dtype),
        num_safe.astype(dtype), num_pruned.astype(dtype),
        num_added.astype(dtype), count.astype(dtype)[None],
    ])


def _validate_and_prune(kernels, states, S, count, swarm_size, beta, fmin,
                        scaling):
    """Reference gp_opt.py:1044-1062 in traced form."""
    cap = S.shape[0]
    active = jnp.arange(cap) < count
    _, safe = _particle_fitness("safe_set", kernels, states, beta, fmin,
                                scaling, jnp.asarray(0.0), S)
    safe = safe & active
    num_safe = jnp.sum(safe)
    do_prune = (num_safe >= swarm_size) & (num_safe != count)

    # order-preserving compaction: stable sort by (not safe)
    order = jnp.argsort(jnp.where(safe, 0, 1), stable=True)
    S_pruned = jnp.take(S, order, axis=0)
    S_new = jnp.where(do_prune, S_pruned, S)
    count_new = jnp.where(do_prune, num_safe.astype(count.dtype), count)
    pruned = jnp.where(do_prune, count - num_safe.astype(count.dtype), 0)
    return S_new, count_new, num_safe, pruned


def _init_particles(u_idx, S, count, swarm_type, greedy_point, specials):
    """Reference gp_opt.py:1064-1081 in traced form.

    ``u_idx`` is a U[0,1) vector mapped to indices via
    ``floor(u * count)`` — the convention shared with the stepwise
    path and ``RefSafeOptSwarm`` so identical uniform streams seed
    identical particles. ``specials`` is (2, d): the most recent
    observation and the best observation, computed by the host from
    the data store (the device GP state's X/Y are inducing points /
    unused for sparse models, so they cannot be read here).
    """
    cnt = jnp.maximum(count, 1)
    idx = jnp.minimum((u_idx * cnt).astype(jnp.int32), cnt - 1)
    particles = jnp.take(S, idx, axis=0)
    if swarm_type != "greedy":
        return particles
    return jnp.concatenate(
        [particles, greedy_point[None, :], specials], axis=0)


def _grow_safe_set(kernel0, scaling0, S, count, best_positions):
    """Greedy covariance dedup growth (gp_opt.py:1089-1114), traced.

    Sequential scan over the swarm's best positions; each accepted
    point immediately joins the comparison set for later candidates.
    """
    cap = S.shape[0]
    swarm = best_positions.shape[0]

    # covariance of candidates vs [S | candidates]
    stacked = jnp.concatenate([S, best_positions], axis=0)
    cov = kernel0.K(best_positions, stacked) / (scaling0 ** 2)

    col_is_s = jnp.arange(cap + swarm) < cap

    def body(carry, j):
        S_buf, cnt, added, accepted = carry
        # active columns: S rows < cnt, plus already-accepted candidates
        # (candidate columns are the trailing ``swarm`` entries)
        active_s = col_is_s & (jnp.arange(cap + swarm) < cnt)
        active_c = jnp.concatenate([jnp.zeros((cap,), bool), accepted])
        mask = active_s | active_c
        ok = jnp.all(jnp.where(mask, cov[j], -jnp.inf) <= 0.95)
        ok &= cnt < cap                       # buffer guard
        S_buf = jnp.where(
            ok,
            jax.lax.dynamic_update_index_in_dim(
                S_buf, best_positions[j], cnt, axis=0),
            S_buf)
        cnt = cnt + jnp.where(ok, 1, 0).astype(cnt.dtype)
        added = added + jnp.where(ok, 1, 0)
        accepted = accepted.at[j].set(ok)
        return (S_buf, cnt, added, accepted), None

    init = (S, count, jnp.asarray(0, jnp.int32), jnp.zeros((swarm,), bool))
    (S_new, count_new, added, _), _ = jax.lax.scan(
        body, init, jnp.arange(swarm))
    return S_new, count_new, added


@partial(jax.jit, static_argnames=("swarm_size", "max_iters", "ucb"))
@with_matmul_precision
def fused_swarm_optimize(kernels, states, state: SwarmIterState,
                         key, velocity_scale, bounds, fmin, scaling,
                         threshold, scalar_pack,
                         streams=None, *, swarm_size: int, max_iters: int,
                         ucb: bool = False) -> SwarmIterOut:
    """One complete SafeOptSwarm optimize() as a single device program.

    ``scalar_pack`` carries every per-iteration host scalar in ONE
    array — ``[beta, best_lower_bound, last_x..., best_x...]`` — so the
    host pays a single transfer per iteration instead of one blocking
    round trip per operand (the unpacking slices below fuse into the
    program for free).

    ``streams`` (optional) injects the per-swarm uniform randomness —
    a dict with keys ``{greedy,maximizers,expanders}_{idx,vel,r}`` —
    instead of drawing from ``key`` on device; lockstep parity tests
    feed the identical streams to the stepwise path and
    ``RefSafeOptSwarm``. Default (None) keeps on-device generation:
    shipping ~1 MB of host-drawn uniforms every iteration would cost
    more than the three on-device draws.
    """
    dtype = state.S.dtype
    d = state.S.shape[1]

    # Callers pass the key as RAW uint32 key data: a typed key lives
    # committed on the host CPU backend and its transfer blocks the
    # dispatch for a full round trip; raw data rides the normal
    # async argument path.
    if not jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.wrap_key_data(key)

    beta = scalar_pack[0]
    best_lower_bound_init = scalar_pack[1]
    specials = scalar_pack[2:2 + 2 * d].reshape(2, d)
    # the greedy estimate rides the pack too: the host may have moved
    # it (stepwise path, checkpoint load) since the device state was
    # produced, and the host already re-reads it every iteration
    greedy_in = scalar_pack[2 + 2 * d: 2 + 3 * d]

    S, count, greedy_point = state.S, state.count, greedy_in
    num_safe = []
    num_pruned = []
    num_added = []

    def run_one(S, count, greedy_point, blb, key, swarm_type):
        n_random = swarm_size - 3 if swarm_type == "greedy" else swarm_size
        if streams is None:
            k1, k2, k3 = jax.random.split(key, 3)
            u_idx = jax.random.uniform(k1, (n_random,), dtype=dtype)
            u_vel = jax.random.uniform(k2, (swarm_size, d), dtype=dtype)
            r_stream = jax.random.uniform(
                k3, (max_iters, 2, swarm_size, d), dtype=dtype)
        else:
            u_idx = streams[swarm_type + "_idx"]
            u_vel = streams[swarm_type + "_vel"]
            r_stream = streams[swarm_type + "_r"]

        S, count, n_safe, pruned = _validate_and_prune(
            kernels, states, S, count, swarm_size, beta, fmin, scaling)
        has_safe = n_safe > 0

        particles = _init_particles(u_idx, S, count, swarm_type,
                                    greedy_point, specials)
        velocities = u_vel * velocity_scale

        fitness = partial(_particle_fitness, swarm_type, kernels, states,
                          beta, fmin, scaling, blb)
        result = swarm_scan(fitness, particles, velocities, r_stream,
                            velocity_scale, bounds)
        return (S, count, n_safe, pruned, has_safe, result)

    key_g, key_m, key_e = jax.random.split(key, 3)

    # -- greedy: refresh the best-lower-bound estimate -----------------------
    S, count, ns, pr, has_safe_g, res_g = run_one(
        S, count, greedy_point, jnp.asarray(-jnp.inf, dtype), key_g,
        "greedy")
    num_safe.append(ns)
    num_pruned.append(pr)

    mu_gp, var_gp = gp_predict(kernels[0], states[0],
                               greedy_point[None, :])
    old_lb = mu_gp[0] - beta * jnp.sqrt(var_gp[0])
    best_val = jnp.max(res_g.best_values)
    move = has_safe_g & (old_lb < best_val)
    greedy_point = jnp.where(move, res_g.global_best, greedy_point)
    best_lower_bound = jnp.where(has_safe_g, best_val,
                                 best_lower_bound_init)

    # -- maximizers ----------------------------------------------------------
    S, count, ns, pr, has_safe_m, res_m = run_one(
        S, count, greedy_point, best_lower_bound, key_m, "maximizers")
    num_safe.append(ns)
    num_pruned.append(pr)
    S_grown, count_grown, added = _grow_safe_set(
        kernels[0], scaling[0], S, count, res_m.best_positions)
    S = jnp.where(has_safe_m, S_grown, S)
    count = jnp.where(has_safe_m, count_grown, count)
    num_added.append(jnp.where(has_safe_m, added, 0))
    x_maxi = res_m.global_best

    def stds_at(x):
        out = []
        for kern, st in zip(kernels, states):
            _, var = gp_predict(kern, st, x[None, :])
            out.append(jnp.sqrt(var[0]))
        return jnp.stack(out)

    std_maxi_vec = stds_at(x_maxi)
    std_maxi = std_maxi_vec[0] / scaling[0]

    if ucb:
        # ucb returns the maximizer; expanders never run
        # (gp_opt.py:1154-1156).
        ns = jnp.stack(num_safe + [jnp.asarray(1)])
        npr = jnp.stack(num_pruned + [jnp.asarray(0)])
        na = jnp.stack(num_added + [jnp.asarray(0)])
        zero = jnp.asarray(0.0, dtype)
        return SwarmIterOut(
            x_next=x_maxi,
            state=SwarmIterState(S=S, count=count, greedy=greedy_point),
            best_lower_bound=best_lower_bound,
            num_safe=ns, num_pruned=npr, num_added=na,
            std_maxi=std_maxi, std_exp=zero,
            x_maxi=x_maxi, x_exp=x_maxi, x_greedy=res_g.global_best,
            diag=_pack_diag(x_maxi, x_maxi, x_maxi, res_g.global_best,
                            greedy_point, best_lower_bound, std_maxi,
                            zero, ns, npr, na, count))

    # -- expanders -----------------------------------------------------------
    S, count, ns, pr, has_safe_e, res_e = run_one(
        S, count, greedy_point, best_lower_bound, key_e, "expanders")
    num_safe.append(ns)
    num_pruned.append(pr)
    S_grown, count_grown, added = _grow_safe_set(
        kernels[0], scaling[0], S, count, res_e.best_positions)
    S = jnp.where(has_safe_e, S_grown, S)
    count = jnp.where(has_safe_e, count_grown, count)
    num_added.append(jnp.where(has_safe_e, added, 0))
    x_exp = res_e.global_best

    # final choice (gp_opt.py:1161-1177)
    std_exp_vec = stds_at(x_exp)
    std_exp_vec = jnp.where((std_exp_vec < threshold) | (fmin == -jnp.inf),
                            0.0, std_exp_vec)
    std_exp = jnp.max(std_exp_vec / scaling)
    x_next = jnp.where(std_maxi > std_exp, x_maxi, x_exp)

    ns = jnp.stack(num_safe)
    npr = jnp.stack(num_pruned)
    na = jnp.stack(num_added)
    return SwarmIterOut(
        x_next=x_next,
        state=SwarmIterState(S=S, count=count, greedy=greedy_point),
        best_lower_bound=best_lower_bound,
        num_safe=ns, num_pruned=npr, num_added=na,
        std_maxi=std_maxi, std_exp=std_exp,
        x_maxi=x_maxi, x_exp=x_exp, x_greedy=res_g.global_best,
        diag=_pack_diag(x_next, x_maxi, x_exp, res_g.global_best,
                        greedy_point, best_lower_bound, std_maxi, std_exp,
                        ns, npr, na, count))
