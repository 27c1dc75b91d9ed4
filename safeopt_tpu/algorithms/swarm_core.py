"""Constrained particle-swarm optimization as a single fused scan.

Accelerator-native counterpart of the reference PSO engine
(/root/reference/safeopt/swarm.py:17-146). The reference runs 100
Python-loop iterations, each doing a full fitness callback — here the
whole run is one ``lax.scan`` whose body fuses the velocity/position
update with the (traceable) fitness, so a swarm run is a single device
program instead of ~100 host dispatches.

Semantics preserved exactly:
- velocity update ``v <- inertia*v + (c1*r1*(best_self - x) +
  c2*r2*(global - x)) / velocity_scale`` with r1, r2 ~ U[0,1)
  (swarm.py:100-112); inertia annealed linearly 1.0 -> 0.1 *after* the
  velocity update of each iteration (swarm.py:95-96,109-114);
- velocity clipped to +-10*velocity_scale (swarm.py:61-64,118-121);
- positions clipped to bounds (swarm.py:124-131);
- per-particle bests move only when the new value improves AND the
  particle is safe (swarm.py:134-143); initial bests are seeded from
  the initial fitness regardless of safety (swarm.py:78-84).

Randomness is injectable: callers pass the full uniform stream
(max_iter, 2, swarm_size, ndim) so golden-parity tests can feed the
same stream to the NumPy reference implementation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["SwarmRunResult", "swarm_scan", "make_uniform_stream"]


class SwarmRunResult(NamedTuple):
    """Device-side outputs of one full constrained-PSO run."""

    positions: jnp.ndarray        # (S, d) final particle positions
    velocities: jnp.ndarray       # (S, d) final velocities
    best_positions: jnp.ndarray   # (S, d) per-particle best (safe) positions
    best_values: jnp.ndarray      # (S,) per-particle best values
    global_best: jnp.ndarray      # (d,) best position overall


def make_uniform_stream(key: jax.Array, max_iter: int, swarm_size: int,
                        ndim: int, dtype) -> jnp.ndarray:
    """U[0,1) stream shaped (max_iter, 2, swarm_size, ndim) for one run."""
    return jax.random.uniform(key, (max_iter, 2, swarm_size, ndim),
                              dtype=dtype)


def swarm_scan(fitness: Callable, positions: jnp.ndarray,
               velocities: jnp.ndarray, r_stream: jnp.ndarray,
               velocity_scale: jnp.ndarray,
               bounds: Optional[jnp.ndarray] = None,
               c1: float = 1.0, c2: float = 1.0,
               initial_inertia: float = 1.0,
               final_inertia: float = 0.1) -> SwarmRunResult:
    """Run a full constrained-PSO exploration as one scan.

    Parameters
    ----------
    fitness : callable (S, d) -> (values (S,), safe (S,) bool)
        Must be JAX-traceable; it is inlined into the scan body.
    positions, velocities : (S, d)
        Initial particle state (velocities are the caller's draw of
        U[0,1) * velocity_scale, reference swarm.py:75-76).
    r_stream : (max_iter, 2, S, d)
        Per-iteration uniform randomness (r1 = [, 0], r2 = [, 1]).
    velocity_scale : (d,)
        Base per-dimension velocity; max velocity is 10x this.
    bounds : (d, 2) or None
        Position clip box.
    """
    max_iter = r_stream.shape[0]
    dtype = positions.dtype
    max_velocity = 10.0 * velocity_scale
    inertia_step = (final_inertia - initial_inertia) / max_iter

    values0, _ = fitness(positions)
    best_positions = positions
    best_values = values0
    global_best = positions[jnp.argmax(values0)]

    def body(carry, r):
        x, v, bp, bv, gb, inertia = carry
        r1, r2 = r[0], r[1]

        v = inertia * v + (c1 * r1 * (bp - x) + c2 * r2 * (gb - x)) \
            / velocity_scale
        inertia = inertia + inertia_step
        v = jnp.clip(v, -max_velocity, max_velocity)

        x = x + v
        if bounds is not None:
            x = jnp.clip(x, bounds[:, 0], bounds[:, 1])

        values, safe = fitness(x)
        improved = (values > bv) & safe
        bv = jnp.where(improved, values, bv)
        bp = jnp.where(improved[:, None], x, bp)
        gb = bp[jnp.argmax(bv)]
        return (x, v, bp, bv, gb, inertia), None

    init = (positions, velocities, best_positions, best_values, global_best,
            jnp.asarray(initial_inertia, dtype))
    (x, v, bp, bv, gb, _), _ = jax.lax.scan(body, init, r_stream)
    return SwarmRunResult(positions=x, velocities=v, best_positions=bp,
                          best_values=bv, global_best=gb)
