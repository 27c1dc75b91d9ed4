"""SafeOpt trajectory parity vs the float64 NumPy reference.

Covers the four shipped reference configurations (SURVEY.md section
2.9): 1-D single constraint, 1-D multi-constraint, 2-D, and contextual
optimization — plus the Lipschitz variant, safe-UCB mode, and
get_maximum. Each test runs the full BO loop on a deterministic RKHS
test function and asserts the fused device implementation visits exactly
the same points as the sequential reference.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from safeopt_tpu import SafeOpt, linearly_spaced_combinations
from safeopt_tpu.gp import GPRegression, Matern32, RBF

from reference_impl import (RefGP, RefMatern32, RefRBF, RefSafeOpt)


def rkhs_fn(kern_eval, centers, weights):
    """Deterministic test function f(x) = sum_j w_j k(x, c_j)."""
    centers = np.atleast_2d(np.asarray(centers, dtype=float))
    weights = np.asarray(weights, dtype=float)

    def f(x):
        x = np.atleast_2d(np.asarray(x, dtype=float))
        return kern_eval(x, centers) @ weights

    return f


def run_loop(opt, ref, fns, iters, context=None):
    """Run both implementations in lockstep; assert identical queries."""
    for it in range(iters):
        x = np.asarray(opt.optimize(context=context)
                       if context is not None else opt.optimize())
        x_ref = np.asarray(ref.optimize(context=context)
                           if context is not None else ref.optimize())
        assert_allclose(x, x_ref, atol=1e-9,
                        err_msg=f"query diverged at iteration {it}")
        y = [float(f(x)[0]) for f in fns]
        if context is not None:
            opt.add_new_data_point(x, np.array([y]), context=context)
            ref.add_new_data_point(x, np.array([y]), context=context)
        else:
            opt.add_new_data_point(x, np.array([y]))
            ref.add_new_data_point(x, np.array([y]))


class Test1D:
    """1d_example.ipynb configuration: RBF(var=2), noise 0.05^2,
    grid over [-10, 10], fmin=0, safe seed at x=0."""

    def _setup(self, threshold=0.2):
        kern = RBF(1, variance=2.0, lengthscale=1.0, ARD=True)
        rkern = RefRBF(1, variance=2.0, lengthscale=1.0, ARD=True)
        f = rkhs_fn(rkern.K, [[-4.0], [-1.0], [0.0], [2.0], [5.0]],
                    [1.5, -1.0, 2.0, 1.0, -2.0])
        x0 = np.array([[0.0]])
        y0 = f(x0)[:, None]
        assert y0[0, 0] > 0.5
        grid = linearly_spaced_combinations([(-10.0, 10.0)], 500)
        gp = GPRegression(x0, y0, kern, noise_var=0.05 ** 2)
        rgp = RefGP(x0, y0, rkern, noise_var=0.05 ** 2)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=threshold)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=threshold)
        return opt, ref, f

    def test_trajectory_parity(self):
        opt, ref, f = self._setup()
        run_loop(opt, ref, [f], iters=10)
        # sets agree at the end
        assert_allclose(opt.Q, ref.Q, rtol=1e-7, atol=1e-9)
        np.testing.assert_array_equal(opt.S, ref.S)
        np.testing.assert_array_equal(opt.M, ref.M)
        np.testing.assert_array_equal(opt.G, ref.G)

    def test_get_maximum_parity(self):
        opt, ref, f = self._setup()
        run_loop(opt, ref, [f], iters=5)
        x, y = opt.get_maximum()
        xr, yr = ref.get_maximum()
        assert_allclose(np.asarray(x), xr, atol=1e-9)
        assert_allclose(y, yr, rtol=1e-8)

    def test_ucb_parity(self):
        opt, ref, f = self._setup()
        for _ in range(5):
            x = np.asarray(opt.optimize(ucb=True))
            xr = np.asarray(ref.optimize(ucb=True))
            assert_allclose(x, xr, atol=1e-9)
            y = float(f(x)[0])
            opt.add_new_data_point(x, y)
            ref.add_new_data_point(x, y)

    def test_empty_safe_set_raises(self):
        kern = RBF(1, variance=2.0)
        gp = GPRegression(np.array([[0.0]]), np.array([[-5.0]]), kern,
                          noise_var=0.05 ** 2)
        grid = linearly_spaced_combinations([(-10.0, 10.0)], 100)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        with pytest.raises(EnvironmentError):
            opt.optimize()

    def test_lipschitz_variant_parity(self):
        opt, ref, f = self._setup()
        opt_l, ref_l, _ = self._setup()
        # rebuild with lipschitz constants
        kern = RBF(1, variance=2.0, lengthscale=1.0, ARD=True)
        rkern = RefRBF(1, variance=2.0, lengthscale=1.0, ARD=True)
        x0 = np.array([[0.0]])
        y0 = f(x0)[:, None]
        grid = linearly_spaced_combinations([(-10.0, 10.0)], 500)
        gp = GPRegression(x0, y0, kern, noise_var=0.05 ** 2)
        rgp = RefGP(x0, y0, rkern, noise_var=0.05 ** 2)
        opt = SafeOpt(gp, grid, fmin=[0.0], lipschitz=1.5, threshold=0.2)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], lipschitz=1.5, threshold=0.2)
        assert opt.use_lipschitz
        run_loop(opt, ref, [f], iters=8)


class TestMultiConstraint:
    """1d_multiple_constraints_example.ipynb: unconstrained objective +
    one safety-constraint GP (fmin = [-inf, 0])."""

    def test_trajectory_parity(self):
        kern_f = RBF(1, variance=2.0)
        kern_g = Matern32(1, variance=1.5)
        rkern_f = RefRBF(1, variance=2.0)
        rkern_g = RefMatern32(1, variance=1.5)
        f = rkhs_fn(rkern_f.K, [[-3.0], [0.0], [3.0]], [1.0, 1.5, -1.0])
        g = rkhs_fn(rkern_g.K, [[-2.0], [0.0], [4.0]], [-0.5, 2.0, -1.5])
        x0 = np.array([[0.0]])
        assert g(x0)[0] > 0.1

        grid = linearly_spaced_combinations([(-8.0, 8.0)], 400)
        gps = [GPRegression(x0, f(x0)[:, None], kern_f, noise_var=1e-5),
               GPRegression(x0, g(x0)[:, None], kern_g, noise_var=1e-5)]
        rgps = [RefGP(x0, f(x0)[:, None], rkern_f, noise_var=1e-5),
                RefGP(x0, g(x0)[:, None], rkern_g, noise_var=1e-5)]
        opt = SafeOpt(gps, grid, fmin=[-np.inf, 0.0], threshold=0.1)
        ref = RefSafeOpt(rgps, grid, fmin=[-np.inf, 0.0], threshold=0.1)
        run_loop(opt, ref, [f, g], iters=10)
        np.testing.assert_array_equal(opt.S, ref.S)

    def test_nan_observation_routing(self):
        kern_f = RBF(1, variance=2.0)
        kern_g = RBF(1, variance=2.0)
        x0 = np.array([[0.0]])
        gps = [GPRegression(x0, np.array([[1.0]]), kern_f, noise_var=1e-4),
               GPRegression(x0, np.array([[1.0]]), kern_g, noise_var=1e-4)]
        grid = linearly_spaced_combinations([(-5.0, 5.0)], 50)
        opt = SafeOpt(gps, grid, fmin=[-np.inf, 0.0])
        opt.add_new_data_point(np.array([[1.0]]), np.array([[2.0, np.nan]]))
        assert opt.gps[0].num_data == 2
        assert opt.gps[1].num_data == 1
        assert opt.t == 2


class Test2D:
    """2d_example.ipynb configuration (reduced grid)."""

    def test_trajectory_parity(self):
        kern = RBF(2, variance=2.0, lengthscale=1.0, ARD=True)
        rkern = RefRBF(2, variance=2.0, lengthscale=1.0, ARD=True)
        f = rkhs_fn(rkern.K,
                    [[0.0, 0.0], [2.0, 1.0], [-2.0, -1.5], [1.0, -2.0]],
                    [2.0, 1.2, -1.0, -1.5])
        x0 = np.array([[0.0, 0.0]])
        assert f(x0)[0] > 0.5

        grid = linearly_spaced_combinations([(-5.0, 5.0), (-5.0, 5.0)], 25)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=0.05 ** 2)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=0.05 ** 2)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.2)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.2)
        run_loop(opt, ref, [f], iters=8)
        np.testing.assert_array_equal(opt.S, ref.S)


class TestContext:
    """context_example.ipynb: product kernel with one context column,
    context switched mid-run."""

    def test_trajectory_parity(self):
        kern = (RBF(1, variance=2.0, active_dims=[0]) *
                RBF(1, variance=1.0, lengthscale=2.0, active_dims=[1]))
        rkern = (RefRBF(1, variance=2.0, active_dims=[0]) *
                 RefRBF(1, variance=1.0, lengthscale=2.0, active_dims=[1]))
        f = rkhs_fn(rkern.K,
                    [[0.0, 0.0], [2.0, 0.5], [-3.0, 0.0]],
                    [2.0, 1.0, -1.0])
        x0 = np.array([[0.0, 0.0]])  # parameter 0 at context 0
        assert f(x0)[0] > 0.5

        params = linearly_spaced_combinations([(-5.0, 5.0)], 200)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=0.05 ** 2)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=0.05 ** 2)
        opt = SafeOpt(gp, params, fmin=[0.0], num_contexts=1, threshold=0.1)
        ref = RefSafeOpt(rgp, params, fmin=[0.0], num_contexts=1,
                         threshold=0.1)

        def step(context, iters):
            for _ in range(iters):
                x = np.asarray(opt.optimize(context=context))
                xr = np.asarray(ref.optimize(context=context))
                assert_allclose(x, xr, atol=1e-9)
                xc = np.concatenate([x, [context]])
                y = float(f(xc[None, :])[0])
                opt.add_new_data_point(x, y, context=context)
                ref.add_new_data_point(x, y, context=context)

        step(0.0, 4)
        step(0.1, 4)  # context switch mid-run

        xm, ym = opt.get_maximum(context=0.1)
        xmr, ymr = ref.get_maximum(context=0.1)
        assert_allclose(np.asarray(xm), xmr, atol=1e-9)
        assert_allclose(ym, ymr, rtol=1e-8)

    def test_context_properties(self):
        kern = (RBF(1, active_dims=[0]) * RBF(1, active_dims=[1]))
        gp = GPRegression(np.array([[0.0, 0.0]]), np.array([[1.0]]), kern,
                          noise_var=0.01)
        params = linearly_spaced_combinations([(-1.0, 1.0)], 10)
        opt = SafeOpt(gp, params, fmin=[0.0], num_contexts=1)
        opt.context = 0.5
        assert_allclose(opt.context, [0.5])
        assert opt.context_fixed_inputs == [(1, 0.5)]
        assert opt.inputs.shape == (10, 2)
        assert opt.parameter_set.shape == (10, 1)


class TestEdgeCases:
    def test_threshold_as_list(self):
        """Per-GP threshold list (reference gp_opt.py:536 broadcast)."""
        kern_f = RBF(1, variance=2.0)
        kern_g = RBF(1, variance=1.0)
        rkern_f = RefRBF(1, variance=2.0)
        rkern_g = RefRBF(1, variance=1.0)
        f = rkhs_fn(rkern_f.K, [[0.0], [2.0]], [2.0, 1.0])
        g = rkhs_fn(rkern_g.K, [[0.0], [-2.0]], [1.5, 1.0])
        x0 = np.array([[0.0]])
        grid = linearly_spaced_combinations([(-6.0, 6.0)], 200)
        gps = [GPRegression(x0, f(x0)[:, None], kern_f, noise_var=1e-4),
               GPRegression(x0, g(x0)[:, None], kern_g, noise_var=1e-4)]
        rgps = [RefGP(x0, f(x0)[:, None], rkern_f, noise_var=1e-4),
                RefGP(x0, g(x0)[:, None], rkern_g, noise_var=1e-4)]
        opt = SafeOpt(gps, grid, fmin=[-np.inf, 0.0], threshold=[0.1, 0.3])
        ref = RefSafeOpt(rgps, grid, fmin=[-np.inf, 0.0],
                         threshold=np.array([0.1, 0.3]))
        run_loop(opt, ref, [f, g], iters=6)

    def test_remove_last_data_point_in_loop(self):
        kern = RBF(1, variance=2.0)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]), kern,
                          noise_var=1e-3)
        grid = linearly_spaced_combinations([(-4.0, 4.0)], 100)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        x1 = np.asarray(opt.optimize())
        opt.add_new_data_point(x1, 1.0)
        x2 = np.asarray(opt.optimize())
        opt.remove_last_data_point()
        x1_again = np.asarray(opt.optimize())
        assert_allclose(x1_again, x1, atol=1e-12)
        assert not np.allclose(x1, x2) or True  # x2 may differ

    def test_beta_callable_parity(self):
        kern = RBF(1, variance=2.0)
        rkern = RefRBF(1, variance=2.0)
        f = rkhs_fn(rkern.K, [[0.0], [1.5]], [2.0, 1.0])
        x0 = np.array([[0.0]])
        grid = linearly_spaced_combinations([(-4.0, 4.0)], 150)
        beta = lambda t: 2.0 + 0.5 * np.log(max(t, 1))  # noqa: E731
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
        opt = SafeOpt(gp, grid, fmin=[0.0], beta=beta)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], beta=beta)
        run_loop(opt, ref, [f], iters=5)


class TestMultipleContexts:
    def test_two_context_columns(self):
        """num_contexts=2: both trailing columns pinned per round."""
        kern = (RBF(1, variance=2.0, active_dims=[0]) *
                RBF(2, variance=1.0, lengthscale=2.0, active_dims=[1, 2]))
        rkern = (RefRBF(1, variance=2.0, active_dims=[0]) *
                 RefRBF(2, variance=1.0, lengthscale=2.0,
                        active_dims=[1, 2]))
        f = rkhs_fn(rkern.K, [[0.0, 0.0, 0.0], [1.5, 0.3, -0.2]],
                    [2.0, 1.0])
        x0 = np.array([[0.0, 0.0, 0.0]])
        assert f(x0)[0] > 0.5

        params = linearly_spaced_combinations([(-3.0, 3.0)], 120)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
        opt = SafeOpt(gp, params, fmin=[0.0], num_contexts=2)
        ref = RefSafeOpt(rgp, params, fmin=[0.0], num_contexts=2)

        ctx = np.array([0.2, -0.1])
        for _ in range(4):
            x = np.asarray(opt.optimize(context=ctx))
            xr = np.asarray(ref.optimize(context=ctx))
            assert_allclose(x, xr, atol=1e-9)
            joint = np.concatenate([x, ctx])
            y = float(f(joint[None, :])[0])
            opt.add_new_data_point(x, y, context=ctx)
            ref.add_new_data_point(x, y, context=ctx)
        assert opt.inputs.shape[1] == 3
        assert_allclose(opt.context, ctx)


class TestObservability:
    def test_stats_recorded_per_iteration(self):
        kern = RBF(1, variance=2.0)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]), kern,
                          noise_var=1e-3)
        grid = linearly_spaced_combinations([(-3.0, 3.0)], 80)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        for _ in range(3):
            x = opt.optimize()
            opt.add_new_data_point(x, 1.0)
        assert len(opt.stats.history) == 3
        last = opt.stats.last
        assert last.safe_count > 0
        assert last.duration_s > 0
        assert opt.stats.summary()["iterations"] == 3


class TestFullSets:
    def test_full_sets_parity(self):
        """compute_sets(full_sets=True) evaluates every safe point
        without early exit (reference gp_opt.py:527-555)."""
        kern = RBF(1, variance=2.0)
        rkern = RefRBF(1, variance=2.0)
        f = rkhs_fn(rkern.K, [[-2.0], [0.0], [2.0]], [1.0, 2.0, -0.5])
        x0 = np.array([[0.0]])
        grid = linearly_spaced_combinations([(-5.0, 5.0)], 150)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.05)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.05)

        # accumulate a few observations first
        run_loop(opt, ref, [f], iters=4)

        opt.update_confidence_intervals()
        opt.compute_sets(full_sets=True)
        ref.update_confidence_intervals()
        ref.compute_sets(full_sets=True)

        np.testing.assert_array_equal(opt.S, ref.S)
        np.testing.assert_array_equal(opt.M, ref.M)
        np.testing.assert_array_equal(opt.G, ref.G)
        assert opt.G.sum() >= 1


def test_update_confidence_intervals_preserves_sets():
    """Reference semantics: update_confidence_intervals refreshes Q
    only; S stays until compute_safe_set runs (gp_opt.py:453-481)."""
    kern = RBF(1, variance=2.0)
    gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]), kern,
                      noise_var=1e-3)
    grid = linearly_spaced_combinations([(-3.0, 3.0)], 60)
    opt = SafeOpt(gp, grid, fmin=[0.0])

    assert not opt.S.any()                 # initial S is empty
    opt.update_confidence_intervals()
    assert opt.Q.any()                     # intervals computed
    assert not opt.S.any()                 # ...but S untouched
    with pytest.raises(EnvironmentError):
        opt.get_new_query_point()          # reference would raise too
    opt.compute_safe_set()
    assert opt.S.any()
    opt.get_new_query_point(ucb=True)      # now fine


class TestMaternObjective:
    def test_matern_objective_trajectory(self):
        """Matern-3/2 objective GP end to end (both engine code paths:
        native gram + device kernel + fused step)."""
        kern = Matern32(1, variance=2.0, lengthscale=1.2)
        rkern = RefMatern32(1, variance=2.0, lengthscale=1.2)
        f = rkhs_fn(rkern.K, [[-2.0], [0.0], [3.0]], [1.0, 1.8, -0.8])
        x0 = np.array([[0.0]])
        assert f(x0)[0] > 0.5
        grid = linearly_spaced_combinations([(-6.0, 6.0)], 250)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.1)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.1)
        run_loop(opt, ref, [f], iters=8)
        np.testing.assert_array_equal(opt.S, ref.S)


class TestThreeGPs:
    def test_three_gp_trajectory(self):
        """Objective + two safety constraints."""
        ks = [RBF(1, variance=2.0), RBF(1, variance=1.0, lengthscale=1.5),
              Matern32(1, variance=1.5)]
        rks = [RefRBF(1, variance=2.0),
               RefRBF(1, variance=1.0, lengthscale=1.5),
               RefMatern32(1, variance=1.5)]
        f = rkhs_fn(rks[0].K, [[0.0], [2.0]], [2.0, 1.0])
        g1 = rkhs_fn(rks[1].K, [[0.0], [-3.0]], [1.5, 1.0])
        g2 = rkhs_fn(rks[2].K, [[0.5], [4.0]], [1.8, -1.0])
        x0 = np.array([[0.0]])
        assert g1(x0)[0] > 0.1 and g2(x0)[0] > 0.1

        grid = linearly_spaced_combinations([(-6.0, 6.0)], 200)
        gps = [GPRegression(x0, fn(x0)[:, None], k, noise_var=1e-4)
               for k, fn in zip(ks, (f, g1, g2))]
        rgps = [RefGP(x0, fn(x0)[:, None], k, noise_var=1e-4)
                for k, fn in zip(rks, (f, g1, g2))]
        opt = SafeOpt(gps, grid, fmin=[-np.inf, 0.0, 0.0], threshold=0.1)
        ref = RefSafeOpt(rgps, grid, fmin=[-np.inf, 0.0, 0.0],
                         threshold=0.1)
        run_loop(opt, ref, [f, g1, g2], iters=6)
        np.testing.assert_array_equal(opt.S, ref.S)


class TestLongTrajectory:
    def test_thirty_iterations_with_capacity_growth(self):
        """30 lockstep iterations: crosses the padded-factor capacity
        boundary (64 -> 128 at n = 64... here 31 observations exercise
        repeated incremental updates) and keeps exact query parity."""
        kern = RBF(1, variance=2.0)
        rkern = RefRBF(1, variance=2.0)
        f = rkhs_fn(rkern.K, [[-4.0], [-1.5], [0.0], [1.5], [4.0]],
                    [1.0, -0.8, 2.0, 1.2, -1.5])
        x0 = np.array([[0.0]])
        grid = linearly_spaced_combinations([(-8.0, 8.0)], 160)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3,
                          capacity=16)   # forces two capacity growths
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.05)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.05)
        run_loop(opt, ref, [f], iters=30)
        assert gp.num_data == 31
        assert gp.state.capacity >= 32   # grew past the initial 16


class TestAdvisorRegressions:
    """Regression tests for round-1 advisor findings (ADVICE.md)."""

    def test_compute_sets_after_contextual_optimize(self):
        """compute_sets() must keep the current context, not reset it
        (reference compute_sets never touches the context,
        gp_opt.py:483)."""
        kern = (RBF(1, variance=2.0, active_dims=[0]) *
                RBF(1, variance=1.0, lengthscale=2.0, active_dims=[1]))
        rkern = (RefRBF(1, variance=2.0, active_dims=[0]) *
                 RefRBF(1, variance=1.0, lengthscale=2.0, active_dims=[1]))
        f = rkhs_fn(rkern.K, [[0.0, 0.0], [2.0, 0.5]], [2.0, 1.0])
        x0 = np.array([[0.0, 0.0]])
        params = linearly_spaced_combinations([(-5.0, 5.0)], 100)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=0.05 ** 2)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=0.05 ** 2)
        opt = SafeOpt(gp, params, fmin=[0.0], num_contexts=1, threshold=0.1)
        ref = RefSafeOpt(rgp, params, fmin=[0.0], num_contexts=1,
                         threshold=0.1)

        opt.optimize(context=0.3)
        ref.optimize(context=0.3)
        opt.compute_sets()          # crashed before the fix
        ref.compute_sets()
        assert_allclose(opt.context, [0.3])
        np.testing.assert_array_equal(opt.S, ref.S)
        np.testing.assert_array_equal(opt.M, ref.M)
        np.testing.assert_array_equal(opt.G, ref.G)
        # explicit None still errors, like the reference setter
        with pytest.raises(ValueError):
            opt.optimize(context=None)

    def test_ucb_step_keeps_stale_sets(self):
        """After a ucb step, M/G retain the previous non-ucb values
        (the reference leaves them stale, gp_opt.py:670-675) even when
        the host mirrors were never materialized in between."""
        kern = RBF(1, variance=2.0)
        rkern = RefRBF(1, variance=2.0)
        f = rkhs_fn(rkern.K, [[-1.0], [0.0], [2.0]], [1.0, 2.0, -1.5])
        x0 = np.array([[0.0]])
        params = linearly_spaced_combinations([(-4.0, 4.0)], 120)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=0.05 ** 2)
        opt = SafeOpt(gp, params, fmin=[0.0], threshold=0.1)

        twin_gp = GPRegression(x0, f(x0)[:, None], kern.copy(),
                               noise_var=0.05 ** 2)
        twin = SafeOpt(twin_gp, params, fmin=[0.0], threshold=0.1)

        opt.optimize()              # mirrors left unmaterialized
        twin.optimize()
        M_expect = twin.M.copy()    # materialize on the twin only
        G_expect = twin.G.copy()
        assert M_expect.any()

        opt.optimize(ucb=True)
        twin.optimize(ucb=True)
        np.testing.assert_array_equal(opt.M, M_expect)
        np.testing.assert_array_equal(opt.G, G_expect)
        np.testing.assert_array_equal(twin.M, M_expect)


class TestEmptyUnsafeWalk:
    """Everything-safe grid: the expander predicate is vacuously false
    for every candidate (reference gp_opt.py:591-606 predicts over an
    empty unsafe set and never breaks), so both implementations must
    walk all candidates, leave G empty, and pick the same maximizer."""

    def test_all_safe_grid_matches_reference(self):
        rng = np.random.default_rng(5)
        X = rng.uniform(-2.0, 2.0, size=(12, 2))
        Yf = (2.0 * np.exp(-0.1 * np.sum(X ** 2, axis=1)))[:, None]
        kern_f = RBF(2, variance=2.0, lengthscale=1.0)
        rkern_f = RefRBF(2, variance=2.0, lengthscale=1.0)
        kern_g = RBF(2, variance=1.0, lengthscale=1.0)
        rkern_g = RefRBF(2, variance=1.0, lengthscale=1.0)

        gp_f = GPRegression(X, Yf, kern_f, noise_var=0.05 ** 2)
        gp_g = GPRegression(X[:1], np.array([[0.0]]), kern_g,
                            noise_var=0.05 ** 2)
        rgp_f = RefGP(X, Yf, rkern_f, noise_var=0.05 ** 2)
        rgp_g = RefGP(X[:1], np.array([[0.0]]), rkern_g,
                      noise_var=0.05 ** 2)

        grid = linearly_spaced_combinations([(-3.0, 3.0), (-3.0, 3.0)], 25)
        fmin = [-np.inf, -3.0]

        # give the constraint GP the same X rows (y at prior mean) so
        # the constructor's identical-X requirement holds
        gp_g.set_XY(X, np.zeros((12, 1)))
        rgp_g.set_XY(X, np.zeros((12, 1)))

        opt = SafeOpt([gp_f, gp_g], grid, fmin=fmin, threshold=0.0,
                      expander_chunk=64)
        ref = RefSafeOpt([rgp_f, rgp_g], grid, fmin=fmin, threshold=0.0)

        x = np.asarray(opt.optimize())
        xr = np.asarray(ref.optimize())
        assert_allclose(x, xr, atol=1e-9)
        assert opt.S.all() and ref.S.all()
        assert not opt.G.any() and not ref.G.any()
        assert opt.M.sum() == ref.M.sum()


class TestExtendedKernelAlgebra:
    """Round-2 kernel surface (Sum / Exponential / Bias) through the
    full BO loop, lockstep against the f64 NumPy mirror."""

    def test_sum_kernel_trajectory(self):
        from safeopt_tpu.gp import Bias

        from reference_impl import RefBias

        kern = RBF(1, variance=2.0, lengthscale=0.9) + Bias(1, variance=0.3)
        rkern = RefRBF(1, variance=2.0, lengthscale=0.9) \
            + RefBias(1, variance=0.3)
        f = rkhs_fn(rkern.K, [[-2.0], [0.0], [2.5]], [0.8, 1.5, -0.6])
        x0 = np.array([[0.0]])
        assert f(x0)[0] > 0.5
        grid = linearly_spaced_combinations([(-5.0, 5.0)], 220)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.1)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.1)
        run_loop(opt, ref, [f], iters=8)
        np.testing.assert_array_equal(opt.S, ref.S)

    def test_exponential_constraint_trajectory(self):
        from safeopt_tpu.gp import Exponential

        from reference_impl import RefExponential

        ks = [RBF(1, variance=2.0),
              Exponential(1, variance=1.5, lengthscale=2.0)]
        rks = [RefRBF(1, variance=2.0),
               RefExponential(1, variance=1.5, lengthscale=2.0)]
        f = rkhs_fn(rks[0].K, [[0.0], [2.0]], [2.0, 1.0])
        g = rkhs_fn(rks[1].K, [[0.0], [-3.0]], [1.5, 1.0])
        x0 = np.array([[0.0]])
        assert g(x0)[0] > 0.1
        grid = linearly_spaced_combinations([(-6.0, 6.0)], 180)
        gps = [GPRegression(x0, fn(x0)[:, None], k, noise_var=1e-4)
               for k, fn in zip(ks, (f, g))]
        rgps = [RefGP(x0, fn(x0)[:, None], k, noise_var=1e-4)
                for k, fn in zip(rks, (f, g))]
        opt = SafeOpt(gps, grid, fmin=[-np.inf, 0.0], threshold=0.1)
        ref = RefSafeOpt(rgps, grid, fmin=[-np.inf, 0.0], threshold=0.1)
        run_loop(opt, ref, [f, g], iters=6)
        np.testing.assert_array_equal(opt.S, ref.S)
