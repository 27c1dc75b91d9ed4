"""Multi-chip sharding: partitioned step equals the single-device step.

Runs on the virtual 8-device CPU mesh from conftest. The same fused
``safeopt_step`` executes with the grid row-sharded over the data axis
and GP factors row-sharded over the model axis; GSPMD inserts the
collectives. Results must be identical to the unsharded run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from safeopt_tpu import linearly_spaced_combinations
from safeopt_tpu.algorithms.safe_opt_core import safeopt_step
from safeopt_tpu.gp import GPRegression, Matern32, RBF
from safeopt_tpu.parallel import (DCN_AXIS, GRID_AXIS, MODEL_AXIS,
                                  make_hier_mesh, make_mesh, replicate,
                                  shard_grid, shard_state)

RNG = np.random.default_rng(3)


def _problem(n_grid=333):  # deliberately not divisible by 8
    X = RNG.uniform(-1.0, 1.0, size=(6, 2))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    Yg = (1.0 - 0.2 * np.sum(X ** 2, axis=1))[:, None]
    gp_f = GPRegression(X, Yf, RBF(2, variance=2.0), noise_var=0.01,
                        capacity=16)
    gp_g = GPRegression(X, Yg, Matern32(2, variance=1.0, lengthscale=1.5),
                        noise_var=0.01, capacity=16)
    side = int(np.ceil(np.sqrt(n_grid)))
    grid = linearly_spaced_combinations([(-3.0, 3.0), (-3.0, 3.0)],
                                        side)[:n_grid]
    dtype = gp_f.state.X.dtype
    args = dict(
        kernels=(gp_f.kern, gp_g.kern),
        states=(gp_f.state, gp_g.state),
        grid=np.asarray(grid),
        fmin=jnp.asarray([0.2, 0.4], dtype),
        beta=jnp.asarray(2.0, dtype),
        scaling=jnp.asarray([np.sqrt(2.0), 1.0], dtype),
        threshold=jnp.asarray([0.0, 0.0], dtype),
    )
    return args


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _run(a, grid, states, num_valid=None, **kw):
    return safeopt_step(a["kernels"], states, grid, a["fmin"], a["beta"],
                        a["scaling"], a["threshold"], num_valid=num_valid,
                        chunk=16, **kw)


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_step_matches_single_device(problem, model_parallel):
    a = problem
    ref = _run(a, jnp.asarray(a["grid"]), a["states"])

    mesh = make_mesh(n_devices=8, model_parallel=model_parallel)
    grid_sharded, pad = shard_grid(a["grid"], mesh)
    assert pad > 0  # exercises the padding mask
    num_valid = jnp.asarray(a["grid"].shape[0], jnp.int32)
    states = tuple(shard_state(s, mesh) for s in a["states"])
    kernels = replicate(a["kernels"], mesh)

    res = safeopt_step(kernels, states, grid_sharded, a["fmin"], a["beta"],
                       a["scaling"], a["threshold"], num_valid=num_valid,
                       chunk=16)

    n = a["grid"].shape[0]
    assert_allclose(np.asarray(res.Q)[:n], np.asarray(ref.Q), rtol=1e-12,
                    atol=1e-13)
    np.testing.assert_array_equal(np.asarray(res.S)[:n], np.asarray(ref.S))
    np.testing.assert_array_equal(np.asarray(res.M)[:n], np.asarray(ref.M))
    np.testing.assert_array_equal(np.asarray(res.G)[:n], np.asarray(ref.G))
    assert int(res.next_idx) == int(ref.next_idx)
    # padding rows are never classified
    assert not np.asarray(res.S)[n:].any()


def test_sharded_ucb_and_lipschitz(problem):
    a = problem
    mesh = make_mesh(n_devices=8, model_parallel=2)
    grid_sharded, _ = shard_grid(a["grid"], mesh)
    num_valid = jnp.asarray(a["grid"].shape[0], jnp.int32)
    states = tuple(shard_state(s, mesh) for s in a["states"])
    kernels = replicate(a["kernels"], mesh)
    dtype = a["fmin"].dtype

    ref_ucb = _run(a, jnp.asarray(a["grid"]), a["states"], ucb=True)
    res_ucb = safeopt_step(kernels, states, grid_sharded, a["fmin"],
                           a["beta"], a["scaling"], a["threshold"],
                           num_valid=num_valid, chunk=16, ucb=True)
    assert int(res_ucb.next_idx) == int(ref_ucb.next_idx)

    lip = jnp.asarray([1.5, 1.5], dtype)
    ref_lip = _run(a, jnp.asarray(a["grid"]), a["states"], lipschitz=lip,
                   use_lipschitz=True)
    res_lip = safeopt_step(kernels, states, grid_sharded, a["fmin"],
                           a["beta"], a["scaling"], a["threshold"],
                           lipschitz=lip, num_valid=num_valid, chunk=16,
                           use_lipschitz=True)
    n = a["grid"].shape[0]
    np.testing.assert_array_equal(np.asarray(res_lip.G)[:n],
                                  np.asarray(ref_lip.G))


def test_mesh_construction_validation():
    with pytest.raises(ValueError):
        make_mesh(n_devices=7, model_parallel=2)
    mesh = make_mesh(n_devices=8, model_parallel=4)
    assert mesh.shape[GRID_AXIS] == 2
    assert mesh.shape[MODEL_AXIS] == 4


def test_hier_mesh_construction():
    """(dcn, data, model) hierarchy: dcn slowest-varying (host-major
    device order), model fastest (factor psum stays on a host's
    adjacent chips)."""
    mesh = make_hier_mesh(n_hosts=2, model_parallel=2, n_devices=8)
    assert mesh.axis_names == (DCN_AXIS, GRID_AXIS, MODEL_AXIS)
    assert mesh.shape[DCN_AXIS] == 2
    assert mesh.shape[GRID_AXIS] == 2
    assert mesh.shape[MODEL_AXIS] == 2
    devs = np.asarray(mesh.devices)
    flat = [d.id for d in np.asarray(jax.devices()[:8])]
    # host 0 gets devices 0-3, host 1 gets 4-7; model varies fastest
    assert [d.id for d in devs[0].reshape(-1)] == flat[:4]
    assert [d.id for d in devs[1].reshape(-1)] == flat[4:]

    with pytest.raises(ValueError):
        make_hier_mesh(n_hosts=3, n_devices=8)
    with pytest.raises(ValueError):
        make_hier_mesh(n_hosts=2, model_parallel=3, n_devices=8)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_hier_sharded_step_matches_single_device(problem, model_parallel):
    """The fused step partitioned over a 2-host (dcn, data, model)
    mesh — grid rows over (dcn, data) jointly, factors over model —
    is bit-identical to the single-device run."""
    a = problem
    ref = _run(a, jnp.asarray(a["grid"]), a["states"])

    mesh = make_hier_mesh(n_hosts=2, model_parallel=model_parallel,
                          n_devices=8)
    grid_sharded, pad = shard_grid(a["grid"], mesh)
    assert pad > 0
    # rows really shard over the product of both grid axes
    n_row_shards = mesh.shape[DCN_AXIS] * mesh.shape[GRID_AXIS]
    assert grid_sharded.shape[0] % n_row_shards == 0
    num_valid = jnp.asarray(a["grid"].shape[0], jnp.int32)
    states = tuple(shard_state(s, mesh) for s in a["states"])
    kernels = replicate(a["kernels"], mesh)

    res = safeopt_step(kernels, states, grid_sharded, a["fmin"], a["beta"],
                       a["scaling"], a["threshold"], num_valid=num_valid,
                       chunk=16)
    n = a["grid"].shape[0]
    assert_allclose(np.asarray(res.Q)[:n], np.asarray(ref.Q), rtol=1e-12,
                    atol=1e-13)
    np.testing.assert_array_equal(np.asarray(res.S)[:n], np.asarray(ref.S))
    np.testing.assert_array_equal(np.asarray(res.M)[:n], np.asarray(ref.M))
    np.testing.assert_array_equal(np.asarray(res.G)[:n], np.asarray(ref.G))
    assert int(res.next_idx) == int(ref.next_idx)


def test_hier_fleet_over_dcn_matches_solo():
    """Campaign fleets shard over the dcn axis (the zero-communication
    DCN shape): each campaign reproduces its solo run exactly."""
    from safeopt_tpu import linearly_spaced_combinations as lsc
    from safeopt_tpu.algorithms.runner import run_safeopt_loop
    from safeopt_tpu.gp import GPRegression
    from safeopt_tpu.parallel import (run_safeopt_campaigns,
                                      stack_campaign_states)

    def objective(x):
        return 2.0 * jnp.exp(-0.5 * jnp.sum(x * x))

    gps = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        x0 = rng.uniform(-0.3, 0.3, size=(1, 2))
        y0 = 2.0 * np.exp(-0.5 * np.sum(x0 ** 2))
        gps.append(GPRegression(x0, np.array([[y0]]),
                                RBF(2, variance=2.0, lengthscale=1.2),
                                noise_var=1e-4, capacity=16))
    kern = gps[0].kern
    grid = np.asarray(lsc([(-2.0, 2.0), (-2.0, 2.0)], 17))
    dtype = gps[0].state.X.dtype
    fmin = jnp.asarray([0.5], dtype)
    beta = jnp.asarray(2.0, dtype)
    scaling = jnp.asarray([np.sqrt(2.0)], dtype)
    threshold = jnp.asarray([0.0], dtype)
    keys = jax.random.split(jax.random.key(7), 2)

    mesh = make_hier_mesh(n_hosts=2, n_devices=8)
    batched = stack_campaign_states([(g.state,) for g in gps])
    fleet = run_safeopt_campaigns(
        (kern,), batched, jnp.asarray(grid), fmin, beta, scaling,
        threshold, keys, objectives=(objective,), n_iter=3, mesh=mesh,
        axis=DCN_AXIS, chunk=16)
    assert bool(fleet.has_safe.all())
    for k in range(2):
        solo = run_safeopt_loop(
            (kern,), (gps[k].state,), jnp.asarray(grid), fmin, beta,
            scaling, threshold, keys[k], objectives=(objective,),
            n_iter=3, chunk=16)
        np.testing.assert_array_equal(np.asarray(fleet.next_idx[k]),
                                      np.asarray(solo.next_idx))
        np.testing.assert_allclose(np.asarray(fleet.xs[k]),
                                   np.asarray(solo.xs), atol=1e-12)


def test_sharded_full_expander_sets_matches(problem):
    """full_sets classification is padding-aware and shard-invariant
    (full_expander_sets takes num_valid like safeopt_step)."""
    from safeopt_tpu.algorithms.safe_opt_core import full_expander_sets

    a = problem
    ref = full_expander_sets(a["kernels"], a["states"],
                             jnp.asarray(a["grid"]), a["fmin"], a["beta"],
                             a["scaling"], chunk=16)

    mesh = make_mesh(n_devices=8, model_parallel=2)
    grid_sharded, pad = shard_grid(a["grid"], mesh)
    assert pad > 0
    num_valid = jnp.asarray(a["grid"].shape[0], jnp.int32)
    states = tuple(shard_state(s, mesh) for s in a["states"])
    kernels = replicate(a["kernels"], mesh)

    res = full_expander_sets(kernels, states, grid_sharded, a["fmin"],
                             a["beta"], a["scaling"], num_valid=num_valid,
                             chunk=16)
    n = a["grid"].shape[0]
    np.testing.assert_array_equal(np.asarray(res.S)[:n], np.asarray(ref.S))
    np.testing.assert_array_equal(np.asarray(res.M)[:n], np.asarray(ref.M))
    np.testing.assert_array_equal(np.asarray(res.G)[:n], np.asarray(ref.G))
    # padding rows are never classified as safe/expander
    assert not np.asarray(res.S)[n:].any()
    assert not np.asarray(res.G)[n:].any()
    assert np.asarray(ref.G).sum() >= 1   # full sets: every qualifying point


def test_sharded_step_with_context_kernel():
    """Round-2 kernel algebra through the sharded step: the contextual
    product kernel partitioned over the mesh equals the single-device
    run exactly."""
    kern = (RBF(1, variance=2.0, lengthscale=0.8, active_dims=[0])
            * Matern32(1, variance=1.0, lengthscale=1.3, active_dims=[1]))
    X = np.hstack([RNG.uniform(-1.0, 1.0, size=(5, 1)), np.zeros((5, 1))])
    Y = (1.5 - 0.3 * X[:, :1] ** 2)
    gp = GPRegression(X, Y, kern, noise_var=0.01, capacity=16)

    xs = np.linspace(-3.0, 3.0, 333)[:, None]     # odd: padding live
    grid = np.hstack([xs, np.zeros_like(xs)])
    dtype = gp.state.X.dtype
    args = dict(
        kernels=(kern,), states=(gp.state,), grid=grid,
        fmin=jnp.asarray([0.5], dtype), beta=jnp.asarray(2.0, dtype),
        scaling=jnp.asarray([np.sqrt(2.0)], dtype),
        threshold=jnp.asarray([0.0], dtype))

    ref = _run(args, jnp.asarray(grid), args["states"])

    mesh = make_mesh(n_devices=8, model_parallel=1)
    grid_sharded, pad = shard_grid(grid, mesh)
    assert pad > 0
    num_valid = jnp.asarray(grid.shape[0], jnp.int32)
    states = (shard_state(gp.state, mesh),)
    kernels = replicate((kern,), mesh)
    res = safeopt_step(kernels, states, grid_sharded, args["fmin"],
                       args["beta"], args["scaling"], args["threshold"],
                       num_valid=num_valid, chunk=16)

    n = grid.shape[0]
    assert_allclose(np.asarray(res.Q)[:n], np.asarray(ref.Q), rtol=1e-12,
                    atol=1e-13)
    np.testing.assert_array_equal(np.asarray(res.S)[:n], np.asarray(ref.S))
    np.testing.assert_array_equal(np.asarray(res.G)[:n], np.asarray(ref.G))
    assert int(res.next_idx) == int(ref.next_idx)
