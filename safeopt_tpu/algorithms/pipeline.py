"""Pipelined (result-pull-overlapped) SafeOptSwarm campaign runner.

Each blocking ``optimize()`` costs ``dispatch + device compute + one
device->host round trip`` plus the plant's evaluation. For physical
systems that
permit *pipelined queries* — query t is being evaluated on the plant
while the optimizer already computes query t+1 — the BO loop can hide
that latency entirely: the algorithm becomes the standard lag-1
(delayed-feedback) variant where x[t+1] is chosen from observations up
to t-1, and its execution overlaps the pull of x[t] (plus the plant's
evaluation of y[t]) with the device compute of x[t+1].

``run_lagged_campaign`` runs exactly that loop — for ``SafeOptSwarm``
AND the exact-grid ``SafeOpt`` — either

* ``pipelined=False`` — the semantic reference: every ``optimize()``
  blocks on its pull before the next dispatch; or
* ``pipelined=True`` — ``optimize_async`` chains iteration t+1's
  dispatch on iteration t's still-in-flight device state
  (``SafeOptSwarm._fused_args_after``), so per-iteration wall time
  approaches ``max(pull, compute, plant)`` instead of their sum.

The two execute the SAME algorithm and produce BITWISE-identical
query sequences (pinned by tests/test_pipeline.py; bench.py
``swarm_pipeline_traj_match`` and chip_smoke.py check it on the GPU):
observations are added in the same order, PRNG keys are split in the
same order, and the chained dispatch reads exactly the device values
the blocking path would have committed host-side.

The plain zero-lag loop (observe y[t] before choosing x[t+1]) cannot
be pipelined without changing the algorithm — x[t+1] depends on y[t]
through the GP — so this runner is explicit about the lag rather than
silently trading regret for throughput. The reference framework has
no delayed-feedback story at all; it pays the full round trip every
iteration (new capability).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["run_lagged_campaign"]


def run_lagged_campaign(opt, objective: Callable[[np.ndarray], float],
                        n_iter: int, pipelined: bool = True,
                        ucb: bool = False):
    """Run a lag-1 SafeOptSwarm campaign; returns ``(xs, ys)``.

    Parameters
    ----------
    opt : SafeOptSwarm or SafeOpt
        The optimizer (its GP accumulates the data). The swarm chains
        iteration t+1's dispatch on t's in-flight device state; the
        grid algorithm needs no chain at all (its only inter-iteration
        dependence is the GP data, entering on the host), so both
        pipeline through their ``optimize_async``.
    objective : callable
        The plant: ``y = objective(x)`` — a scalar for one GP, a
        length-G vector for multi-GP problems (one column per model,
        NaN to skip one, matching ``add_new_data_point``). Called once
        per query, in query order, after the query point is
        available — a physical system would overlap this with the next
        query's computation; the runner's structure already permits it.
    n_iter : int
        Number of queries.
    pipelined : bool
        Overlap iteration t+1's device compute with iteration t's
        result pull (identical trajectory either way).
    """
    n_iter = int(n_iter)
    xs, ys = [], []
    if n_iter <= 0:
        return np.asarray(xs), np.asarray(ys)

    if pipelined:
        if hasattr(opt, "reserve"):      # SafeOptSwarm: device chain
            opt.reserve(n_iter)
        pending = opt.optimize_async(ucb=ucb)
        for t in range(n_iter):
            nxt = (opt.optimize_async(ucb=ucb, after=pending)
                   if t + 1 < n_iter else None)
            x = pending.result()
            y = np.asarray(objective(x), dtype=float)
            xs.append(x)
            ys.append(y)
            # y[t] enters the model now -> influences x[t+2]'s dispatch
            opt.add_new_data_point(x, y)
            pending = nxt
    else:
        x = opt.optimize(ucb=ucb)
        for t in range(n_iter):
            nxt = opt.optimize(ucb=ucb) if t + 1 < n_iter else None
            y = np.asarray(objective(x), dtype=float)
            xs.append(x)
            ys.append(y)
            opt.add_new_data_point(x, y)
            x = nxt
    return np.asarray(xs), np.asarray(ys)
