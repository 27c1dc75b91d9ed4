"""Multi-chip scaling for the candidate grid and GP factors.

The reference is a single-process NumPy program with no distributed
story (SURVEY.md section 2.10); scaling out is new capability designed
the JAX way: pick a mesh, annotate shardings, let the XLA SPMD
partitioner insert the collectives.

Two parallel axes map naturally onto hardware:

* ``data`` — the candidate-grid rows (and swarm particles). All O(N)
  work in ``safeopt_step`` is pointwise or row-parallel; the only
  cross-shard traffic is the handful of global reductions (safe-set
  max, maximizer width, argmax selection) and the expander search's
  candidate gathers, all of them tiny collectives (NCCL on GPUs).

* ``model`` — the GP factor rows (training points). The posterior
  ``V = Linv @ K(X, grid)`` contracts over this axis, so sharding
  ``X``/``L``/``Linv``/``w`` row-wise turns the grid posterior into a
  2-D SPMD matmul with one ``psum`` over ``model`` for the
  mean/variance reductions.

Because the fused step (``safe_opt_core.safeopt_step``) is pure jnp
with static shapes, the SAME program runs single-chip or partitioned:
callers only place the operands with ``NamedSharding`` and jit does the
rest. Numerics are unchanged (contractions keep their within-shard
order; global max/argmax are order-independent).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..gp.regression import GPState

__all__ = ["make_mesh", "make_hier_mesh", "shard_grid", "shard_state",
           "replicate", "GRID_AXIS", "MODEL_AXIS", "DCN_AXIS"]

GRID_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    ``model_parallel`` chips shard the GP-factor contraction; the rest
    shard the candidate grid. Defaults to pure grid data-parallelism.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}")
    arr = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, (GRID_AXIS, MODEL_AXIS))


def make_hier_mesh(n_hosts: int, model_parallel: int = 1,
                   n_devices: Optional[int] = None, devices=None) -> Mesh:
    """Build a (dcn, data, model) mesh for a multi-host slice.

    Axis order follows the hosts (docs/design.md, "Beyond one
    host"): the slowest-varying ``dcn`` axis strides across hosts —
    ``jax.devices()`` orders devices host-major, so consecutive cards
    of one host land in one ``dcn`` row — while ``model`` is
    fastest-varying, keeping the factor contraction's psum within a
    host. The candidate grid shards over BOTH ``(dcn, data)`` (see
    ``shard_grid``): its only cross-host traffic is the step's scalar
    reductions. Campaign fleets shard their campaign axis over
    ``dcn`` (``shard_campaigns(..., axis=DCN_AXIS)``) — zero
    cross-card traffic inside the loop.

    On an actual multi-host slice run ``jax.distributed.initialize()``
    per host first; here the same program is validated on a virtual
    device mesh (tests/test_sharding.py, driver dryrun).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % n_hosts != 0:
        raise ValueError(f"{n} devices not divisible by n_hosts={n_hosts}")
    per_host = n // n_hosts
    if per_host % model_parallel != 0:
        raise ValueError(f"{per_host} devices/host not divisible by "
                         f"model_parallel={model_parallel}")
    arr = np.asarray(devices).reshape(
        n_hosts, per_host // model_parallel, model_parallel)
    return Mesh(arr, (DCN_AXIS, GRID_AXIS, MODEL_AXIS))


def _grid_axes(mesh: Mesh):
    """Mesh axes the candidate grid rows shard over."""
    if DCN_AXIS in mesh.axis_names:
        return (DCN_AXIS, GRID_AXIS)
    return (GRID_AXIS,)


def shard_grid(grid, mesh: Mesh):
    """Place the candidate grid row-sharded over the data axis.

    On a hierarchical ``make_hier_mesh`` the rows shard over
    ``(dcn, data)`` jointly — grid rows never move between shards, so
    spanning hosts costs only the step's scalar reductions.

    Rows are padded to a multiple of the axis size so every shard is
    equal (XLA requires even partitions for best layouts); padding rows
    replicate the last row, which is harmless for SafeOpt because
    padded duplicates can never win an argmax over their originals
    (ties resolve to the first/lowest index).
    """
    grid = np.asarray(grid)
    axes = _grid_axes(mesh)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    pad = (-grid.shape[0]) % n_shards
    if pad:
        grid = np.concatenate([grid, np.repeat(grid[-1:], pad, axis=0)])
    spec = P(axes if len(axes) > 1 else axes[0], None)
    return jax.device_put(grid, NamedSharding(mesh, spec)), pad


def _put(x, sharding: NamedSharding):
    """device_put that also works on multi-process meshes: committed
    local device arrays are rejected by a non-fully-addressable
    sharding, so stage them through the host (every process holds the
    identical global value and contributes its addressable shards)."""
    if not sharding.is_fully_addressable and hasattr(x, "devices"):
        x = jax.device_get(x)
    return jax.device_put(x, sharding)


def shard_state(state: GPState, mesh: Mesh) -> GPState:
    """Shard a GP factor over the model axis (rows of X/Y/L/Linv/w).

    The padded-capacity design guarantees the row count is a power of
    two, so it divides the mesh axis evenly.
    """
    row = NamedSharding(mesh, P(MODEL_AXIS))
    mat = NamedSharding(mesh, P(MODEL_AXIS, None))
    rep = NamedSharding(mesh, P())
    return GPState(
        X=_put(state.X, mat),
        Y=_put(state.Y, mat),
        count=_put(state.count, rep),
        L=_put(state.L, mat),
        Linv=_put(state.Linv, mat),
        w=_put(state.w, row),
        noise_var=_put(state.noise_var, rep),
    )


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: _put(x, sharding), tree)
