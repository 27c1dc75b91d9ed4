"""Cross-process multichip validation (VERDICT r3 #5).

The virtual 8-device CPU mesh validates sharding semantics inside ONE
process; this module validates them across an actual process boundary:
two localhost processes (4 virtual CPU devices each) join via
``jax.distributed.initialize`` and run the hierarchical
(dcn, data, model) mesh — the layout ``parallel/sharding.py`` documents
for multi-host slices — with real cross-process (gloo) collectives.

Checks, each asserted inside the workers:

* hier-mesh ``safeopt_step`` over a grid sharded across both processes
  == the replicated single-device step (S/M/G masks, next_idx), which
  catches host-major device-ordering mistakes no single-process mesh
  can;
* a campaign fleet sharded over the ``dcn`` axis (campaigns 0..K/2-1
  on process 0, the rest on process 1) == each campaign's solo run.

Run as a worker: ``python tools/mp_dryrun.py <port> <process_id>``.
Run the whole check: ``run_two_process()`` (spawns both workers),
called from ``__graft_entry__.dryrun_multichip`` and
``tests/test_multiprocess.py``.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(port: int, pid: int) -> None:
    """One of two distributed processes; asserts and prints OK lines."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    sys.path.insert(0, REPO)
    from __graft_entry__ import _build_problem
    from safeopt_tpu.algorithms.safe_opt_core import safeopt_step
    from safeopt_tpu.parallel import (make_hier_mesh, replicate,
                                      run_safeopt_campaigns, shard_grid,
                                      shard_state, stack_campaign_states)

    assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

    # -- hier-mesh step across the process boundary --------------------
    a = _build_problem(n_grid=127 * 127, n_obs=40, capacity=64)
    mesh = make_hier_mesh(n_hosts=2, model_parallel=2)
    grid_sharded, pad = shard_grid(np.asarray(a["grid"]), mesh)
    num_valid = jnp.asarray(a["grid"].shape[0], jnp.int32)
    states = tuple(shard_state(s, mesh) for s in a["states"])
    kernels = replicate(a["kernels"], mesh)
    fmin, beta, scaling, threshold = replicate(
        (a["fmin"], a["beta"], a["scaling"], a["threshold"]), mesh)

    res = safeopt_step(kernels, states, grid_sharded, fmin, beta, scaling,
                       threshold, num_valid=num_valid, chunk=16)
    jax.block_until_ready(res)

    # solo single-device reference, local to this process
    ref = safeopt_step(a["kernels"], a["states"], a["grid"], a["fmin"],
                       a["beta"], a["scaling"], a["threshold"], chunk=16)
    n = a["grid"].shape[0]
    S = multihost_utils.process_allgather(res.S, tiled=True)
    M = multihost_utils.process_allgather(res.M, tiled=True)
    G = multihost_utils.process_allgather(res.G, tiled=True)
    # next_idx is a replicated scalar: read the local replica (a
    # non-fully-addressable array can't be device_get across processes)
    idx = int(np.asarray(res.next_idx.addressable_data(0)))
    S_r, M_r, G_r, idx_r = jax.device_get((ref.S, ref.M, ref.G,
                                           ref.next_idx))
    assert (S[:n] == S_r).all(), "2-process S != replicated S"
    assert (M[:n] == M_r).all(), "2-process M != replicated M"
    assert (G[:n] == G_r).all(), "2-process G != replicated G"
    assert idx == int(idx_r), "2-process next_idx != replicated"
    assert not S[n:].any(), "2-process padding rows classified safe"
    print(f"[p{pid}] hier mesh OK across 2 processes: "
          f"(dcn, data, model) = {mesh.devices.shape}, grid {n} + {pad} "
          f"pad, sharded==replicated decisions, next_idx={idx}",
          flush=True)

    # -- campaign fleet sharded over dcn (process boundary) ------------
    from safeopt_tpu import linearly_spaced_combinations
    from safeopt_tpu.algorithms.runner import run_safeopt_loop
    from safeopt_tpu.gp import GPRegression, RBF

    K, n_iter = 8, 3
    kern = RBF(2, variance=2.0, lengthscale=1.2)

    def objective(x):
        return 2.0 * jnp.exp(-0.5 * jnp.sum(x * x))

    rng = np.random.default_rng(1)
    per_campaign = []
    for _ in range(K):
        x0 = rng.uniform(-0.3, 0.3, size=(1, 2))
        y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
        gp = GPRegression(x0, np.array([[y0]]), kern, noise_var=1e-4,
                          capacity=16)
        per_campaign.append((gp.state,))

    fgrid = jnp.asarray(np.asarray(
        linearly_spaced_combinations([(-2.0, 2.0), (-2.0, 2.0)], 25)))
    dtype = fgrid.dtype
    ffmin = jnp.asarray([0.5], dtype)
    fscal = jnp.asarray([np.sqrt(2.0)], dtype)
    fthr = jnp.asarray([0.0], dtype)
    keys = jax.random.split(jax.random.key(0), K)

    fleet = run_safeopt_campaigns(
        (kern,), stack_campaign_states(per_campaign), fgrid, ffmin,
        jnp.asarray(2.0, dtype), fscal, fthr, keys,
        objectives=(objective,), n_iter=n_iter, mesh=mesh, axis="dcn",
        chunk=16)
    jax.block_until_ready(fleet.xs)
    xs = multihost_utils.process_allgather(fleet.xs, tiled=True)
    fleet_idx = multihost_utils.process_allgather(fleet.next_idx,
                                                  tiled=True)
    has_safe = multihost_utils.process_allgather(fleet.has_safe,
                                                 tiled=True)
    assert xs.shape == (K, n_iter, 2)
    assert bool(np.asarray(has_safe).all()), "2-process fleet lost safety"

    # campaign K-1 lives on process 1; its query trajectory must equal
    # a solo local run of the same campaign (the exact-equality gate
    # tests/test_campaigns.py pins on the single-process mesh)
    solo = run_safeopt_loop(
        (kern,), per_campaign[-1], fgrid, ffmin, jnp.asarray(2.0, dtype),
        fscal, fthr, keys[-1], objectives=(objective,), n_iter=n_iter,
        chunk=16)
    assert (np.asarray(fleet_idx[-1])
            == np.asarray(solo.next_idx)).all(), \
        "2-process fleet campaign diverged from its solo run"
    print(f"[p{pid}] fleet OK across 2 processes: {K} campaigns sharded "
          f"over dcn x {n_iter} iterations, sharded==solo trajectories",
          flush=True)


def run_two_process(timeout_s: float = 900.0) -> str:
    """Spawn the 2 workers, wait, and return their combined output.

    Raises on nonzero exit or a missing OK line. Safe to call from any
    platform — the workers force JAX_PLATFORMS=cpu themselves.
    """
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    extra = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = REPO + (os.pathsep + extra if extra else "")

    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    combined = "\n".join(outs)
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"2-process worker {i} exited {p.returncode}:\n{combined}")
    for pid in (0, 1):
        assert f"[p{pid}] hier mesh OK across 2 processes" in combined, \
            combined
        assert f"[p{pid}] fleet OK across 2 processes" in combined, combined
    return combined


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
