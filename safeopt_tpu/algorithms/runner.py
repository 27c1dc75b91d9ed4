"""Fully on-device safe-BO loops.

The reference's driver loop is inherently host-bound — evaluate the
real system, feed the observation back (examples/README.md:17-18). But
whenever the objective is computable on the accelerator (simulation,
surrogate benchmarking, self-play tuning, batch re-optimization), the
entire loop — fused SafeOpt iteration, observation, exact O(n^2) model
update — can run as ONE compiled program under ``lax.scan``: zero
host round trips between iterations. It amortizes the dispatch + pull
latency across the whole run and removes the Python driver entirely.

New capability (no reference counterpart): the reference cannot
express this — every GPy refit is a host-side object mutation.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import with_matmul_precision
from ..gp.regression import gp_append
from .safe_opt_core import safeopt_step

__all__ = ["BOLoopResult", "run_safeopt_loop", "SwarmLoopResult",
           "run_swarmopt_loop"]


class BOLoopResult(NamedTuple):
    """Trajectory of an on-device SafeOpt run."""

    states: Tuple                # final per-GP states (count grown)
    xs: jnp.ndarray              # (T, d) queried points
    ys: jnp.ndarray              # (T, G) observations fed to the GPs
    next_idx: jnp.ndarray        # (T,) chosen grid indices
    safe_counts: jnp.ndarray     # (T,) |S| per iteration
    has_safe: jnp.ndarray        # (T,) bool — all True on a healthy run


@partial(jax.jit, static_argnames=("objectives", "n_iter", "ucb",
                                   "use_lipschitz", "chunk"))
@with_matmul_precision
def run_safeopt_loop(kernels, states, grid, fmin, beta, scaling, threshold,
                     key, *, objectives: Tuple[Callable, ...], n_iter: int,
                     lipschitz=None, noise_std=0.0, ucb: bool = False,
                     use_lipschitz: bool = False, chunk: int = 64,
                     objective_args=None, contexts=None,
                     betas=None, it_keys=None) -> BOLoopResult:
    """Run ``n_iter`` complete SafeOpt iterations on device.

    Parameters
    ----------
    objectives : tuple of traceable callables, one per GP
        ``f_i(x (d,)) -> scalar`` — the simulated system. The first is
        the objective; the rest are the safety measurements.
    noise_std : float
        Gaussian observation noise added to every measurement.
    key : jax PRNG key
        Noise randomness.
    objective_args : pytree, optional
        Traced system parameters; when given, objectives are called as
        ``f_i(x, objective_args)``. Because it is traced (not static),
        a vmapped batch of campaigns can carry *different* parameters
        per campaign — heterogeneous tuning fleets
        (parallel/campaigns.py).
    contexts : (n_iter, num_contexts) array, optional
        Contextual optimization inside the compiled loop: iteration t
        overwrites the grid's trailing context columns with
        ``contexts[t]`` before the fused step (the reference's
        per-round context setter, gp_opt.py:439-451,464). Objectives
        receive the full input including the context columns, exactly
        like the reference's driver loop.
    betas : (n_iter,) array, optional
        Per-iteration confidence scale (the reference's callable
        ``beta(t)``, precomputed by the host); overrides ``beta``.
    it_keys : (n_iter,) PRNG key array, optional
        Explicit per-iteration keys instead of splitting ``key``. This
        is the resume protocol: precompute ``jax.random.split(key,
        total)`` once, run a prefix, checkpoint (utils/checkpoint.
        save_state), and relaunch with the remaining key slice — the
        resumed trajectory is bit-identical to the uninterrupted one.

    Every iteration performs the fused SafeOpt step (posterior +
    classification + expander search + selection), evaluates the
    objectives at the chosen grid point, and appends the observation to
    every GP via the exact bordered-Cholesky update. GP capacities must
    admit ``n_iter`` more points (grow the wrappers beforehand).

    Notes
    -----
    If the safe set empties mid-run (model misspecification), the loop
    cannot raise from inside the compiled program; iterations keep
    running on the degenerate argmax and ``has_safe`` records exactly
    where certification was lost — callers must check it.
    """
    num_gps = len(kernels)
    d = grid.shape[1]
    dtype = grid.dtype
    nc = 0 if contexts is None else contexts.shape[1]

    def body(carry, inp):
        states = carry
        it_key, ctx_t, beta_t = inp
        grid_t = (grid if nc == 0
                  else grid.at[:, d - nc:].set(
                      jnp.broadcast_to(ctx_t, (grid.shape[0], nc))))
        result = safeopt_step(kernels, states, grid_t, fmin, beta_t,
                              scaling, threshold, lipschitz, ucb=ucb,
                              use_lipschitz=use_lipschitz, chunk=chunk)
        x = jnp.take(grid_t, result.next_idx, axis=0)        # (d,)
        noise = noise_std * jax.random.normal(it_key, (num_gps,),
                                              dtype=dtype)
        ys = jnp.stack([obj(x) if objective_args is None
                        else obj(x, objective_args)
                        for obj in objectives]) + noise
        states = tuple(
            gp_append(kern, st, x, ys[i])
            for i, (kern, st) in enumerate(zip(kernels, states)))
        out = (x, ys, result.next_idx, result.safe_count, result.has_safe)
        return states, out

    keys = jax.random.split(key, n_iter) if it_keys is None else it_keys
    ctx_stream = (jnp.zeros((n_iter, 0), dtype) if contexts is None
                  else jnp.asarray(contexts, dtype))
    beta_stream = (jnp.broadcast_to(jnp.asarray(beta, dtype), (n_iter,))
                   if betas is None else jnp.asarray(betas, dtype))
    states, (xs, ys, idxs, safe_counts, has_safe) = jax.lax.scan(
        body, tuple(states), (keys, ctx_stream, beta_stream))
    return BOLoopResult(states=states, xs=xs, ys=ys, next_idx=idxs,
                        safe_counts=safe_counts, has_safe=has_safe)


class SwarmLoopResult(NamedTuple):
    """Trajectory of an on-device SafeOptSwarm run."""

    states: Tuple                # final per-GP states (count grown)
    iter_state: object           # final SwarmIterState (device safe set)
    xs: jnp.ndarray              # (T, d) queried points
    ys: jnp.ndarray              # (T, G) observations fed to the GPs
    best_lower_bounds: jnp.ndarray  # (T,)
    safe_counts: jnp.ndarray     # (T,) |S| after each iteration
    num_safe_min: jnp.ndarray    # (T,) min per-phase safe count (0 = lost)


@partial(jax.jit, static_argnames=("objectives", "n_iter", "swarm_size",
                                   "max_iters", "ucb"))
@with_matmul_precision
def run_swarmopt_loop(kernels, states, iter_state, key, velocity_scale,
                      bounds, fmin, scaling, threshold, betas, greedy0,
                      blb0, *, objectives: Tuple[Callable, ...],
                      n_iter: int, swarm_size: int, max_iters: int,
                      noise_std=0.0, ucb: bool = False,
                      objective_args=None, it_keys=None) -> SwarmLoopResult:
    """Run ``n_iter`` complete SafeOptSwarm iterations on device.

    The swarm analog of ``run_safeopt_loop`` — the reference's
    equivalent is ~300 sequential GPy posterior calls per iteration
    driven from Python (SURVEY.md section 3.3); here the whole campaign
    is one ``lax.scan`` over the fused swarm iteration + observation +
    exact bordered-Cholesky model update, with zero host round trips.

    Parameters
    ----------
    iter_state : SwarmIterState
        Device safe-set buffer; size it for the whole run
        (``count + 2 * swarm_size * n_iter`` rows is always enough —
        growth silently stops at the buffer capacity otherwise).
    betas : (n_iter,) array
        Per-iteration confidence scale (``beta(t)`` precomputed by the
        host; t advances by one observation per iteration).
    greedy0, blb0 : (d,) array, scalar
        Initial greedy estimate and best lower bound.
    it_keys : (n_iter,) PRNG key array, optional
        Explicit per-iteration keys (the resume protocol; see
        ``run_safeopt_loop``).

    Exact GPs only: the greedy swarm's special particles (most recent /
    best observation) are read from the GP state's padded X/Y buffers,
    which hold inducing points for sparse models.

    Like ``run_safeopt_loop``, an emptied safe set cannot raise from
    inside the compiled program — ``num_safe_min`` records any
    certification loss and callers must check it.
    """
    from .swarm_opt_fused import fused_swarm_optimize

    num_gps = len(kernels)
    dtype = iter_state.S.dtype

    def body(carry, inp):
        states, sstate, greedy_point, blb = carry
        it_key, beta = inp
        k_swarm, k_noise = jax.random.split(it_key)

        # greedy specials from the device-resident observation buffers
        st0 = states[0]
        cnt = st0.count
        last_x = jax.lax.dynamic_index_in_dim(st0.X, cnt - 1, axis=0,
                                              keepdims=False)
        y_col = jnp.where(jnp.arange(st0.capacity) < cnt, st0.Y[:, 0],
                          -jnp.inf)
        best_x = jnp.take(st0.X, jnp.argmax(y_col), axis=0)
        pack = jnp.concatenate([
            jnp.stack([beta, blb]).astype(dtype),
            last_x.astype(dtype), best_x.astype(dtype),
            greedy_point.astype(dtype)])

        out = fused_swarm_optimize(
            kernels, states, sstate, k_swarm, velocity_scale, bounds,
            fmin, scaling, threshold, pack,
            swarm_size=swarm_size, max_iters=max_iters, ucb=ucb)

        x = out.x_next
        noise = noise_std * jax.random.normal(k_noise, (num_gps,),
                                              dtype=dtype)
        ys = jnp.stack([obj(x) if objective_args is None
                        else obj(x, objective_args)
                        for obj in objectives]) + noise
        states = tuple(
            gp_append(kern, st, x, ys[i])
            for i, (kern, st) in enumerate(zip(kernels, states)))

        carry = (states, out.state, out.state.greedy,
                 out.best_lower_bound.astype(dtype))
        rec = (x, ys, out.best_lower_bound, out.state.count,
               jnp.min(out.num_safe))
        return carry, rec

    keys = jax.random.split(key, n_iter) if it_keys is None else it_keys
    init = (tuple(states), iter_state, jnp.asarray(greedy0, dtype),
            jnp.asarray(blb0, dtype))
    (states, sstate, _, _), (xs, ys, blbs, counts, ns_min) = jax.lax.scan(
        body, init, (keys, jnp.asarray(betas, dtype)))
    return SwarmLoopResult(states=states, iter_state=sstate, xs=xs, ys=ys,
                           best_lower_bounds=blbs, safe_counts=counts,
                           num_safe_min=ns_min)
