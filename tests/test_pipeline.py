"""Pipelined (lag-1) swarm campaign: trajectory identity + mechanics.

The pipelined runner overlaps iteration t+1's device dispatch with
iteration t's result pull (algorithms/pipeline.py). It must execute
the SAME lag-1 algorithm as the blocking loop — bitwise-identical
query sequences — because the chained dispatch reads the previous
iteration's device outputs (state buffer, best lower bound, greedy
point) exactly where the blocking path reads its committed host
mirrors. Hardware gate: bench.py ``swarm_pipeline_traj_match``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safeopt_tpu import SafeOptSwarm
from safeopt_tpu.algorithms.pipeline import run_lagged_campaign
from safeopt_tpu.gp import GPRegression, Matern32, RBF


def _objective(x):
    x = np.asarray(x, dtype=float)
    return float(2.0 * np.exp(-0.5 * np.sum(x ** 2)))


def _objective2(x):
    x = np.asarray(x, dtype=float)
    return np.array([2.0 * np.exp(-0.5 * np.sum(x ** 2)),
                     1.0 - 0.05 * np.sum(x ** 2)])


def _opt(num_gps=1, d=3, seed=0):
    rng = np.random.default_rng(1)
    n0 = 4
    X = rng.uniform(-0.4, 0.4, size=(n0, d))
    Yf = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
    gps = [GPRegression(X, Yf, RBF(d, variance=2.0, lengthscale=2.0),
                        noise_var=0.01)]
    fmin = [0.2]
    if num_gps == 2:
        Yg = (1.0 - 0.05 * np.sum(X ** 2, axis=1))[:, None]
        gps.append(GPRegression(
            X, Yg, Matern32(d, variance=1.0, lengthscale=3.0),
            noise_var=0.01))
        fmin = [-np.inf, 0.0]
    return SafeOptSwarm(gps if num_gps == 2 else gps[0], fmin=fmin,
                        bounds=[(-2.0, 2.0)] * d, swarm_size=12,
                        key=jax.random.key(seed))


class TestLaggedCampaignIdentity:
    @pytest.mark.parametrize("num_gps", [1, 2])
    def test_pipelined_matches_serial_bitwise(self, num_gps):
        obj = _objective if num_gps == 1 else _objective2
        xs_s, ys_s = run_lagged_campaign(_opt(num_gps), obj,
                                         n_iter=6, pipelined=False)
        xs_p, ys_p = run_lagged_campaign(_opt(num_gps), obj,
                                         n_iter=6, pipelined=True)
        assert xs_s.shape == xs_p.shape == (6, 3)
        np.testing.assert_array_equal(xs_p, xs_s)
        np.testing.assert_array_equal(ys_p, ys_s)

    def test_model_state_matches_after_campaign(self):
        a, b = _opt(), _opt()
        run_lagged_campaign(a, _objective, n_iter=5, pipelined=False)
        run_lagged_campaign(b, _objective, n_iter=5, pipelined=True)
        np.testing.assert_array_equal(np.asarray(a.gp.X_host),
                                      np.asarray(b.gp.X_host))
        # committed swarm state converges too (S pulled lazily)
        assert a._count == b._count
        np.testing.assert_array_equal(a.S, b.S)
        assert a.best_lower_bound == b.best_lower_bound

    def test_empty_output_for_zero_iters(self):
        xs, ys = run_lagged_campaign(_opt(), _objective, n_iter=0)
        assert xs.size == 0 and ys.size == 0


class TestAsyncMechanics:
    def test_result_idempotent(self):
        opt = _opt()
        opt.reserve(2)
        p = opt.optimize_async()
        x1 = p.result()
        x2 = p.result()
        np.testing.assert_array_equal(x1, x2)

    def test_chained_dispatch_requires_reserve(self):
        opt = _opt()
        # default buffer holds ~1-2 chained iterations of worst-case
        # growth; an unreserved deep chain must fail loudly rather
        # than overflow the device buffer silently
        p = opt.optimize_async()
        with pytest.raises(RuntimeError, match="reserve"):
            for _ in range(64):
                p = opt.optimize_async(after=p)

    def test_reserve_noop_when_large_enough(self):
        opt = _opt()
        opt.reserve(8)
        buf = opt._S_dev.S.shape[0]
        opt.reserve(4)
        assert opt._S_dev.S.shape[0] == buf

    def test_async_unchained_matches_blocking(self):
        a, b = _opt(seed=3), _opt(seed=3)
        xa = a.optimize()
        xb = b.optimize_async().result()
        np.testing.assert_array_equal(xa, xb)


class TestGridSafeOptPipeline:
    """The exact-grid SafeOpt pipelines too (round 5): its only
    inter-iteration dependence is the GP data (host side), so
    consecutive optimize_async dispatches overlap naturally. The lag-1
    trajectories must match the blocking loop bitwise, for the plain
    path AND the device-oracle certified path."""

    def _opt(self, **kw):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, RBF

        rng = np.random.default_rng(4)
        X = rng.uniform(-1.5, 1.5, size=(25, 2))
        Y = (1.0 + np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
        gp = GPRegression(X, Y, RBF(2, variance=2.0, lengthscale=1.0),
                          noise_var=1e-4)
        grid = linearly_spaced_combinations(
            [(-2.0, 2.0), (-2.0, 2.0)], 25)
        return SafeOpt(gp, grid, fmin=[1.0], **kw)

    @staticmethod
    def _plant(x):
        x = np.asarray(x, dtype=float)
        return float(1.0 + np.exp(-0.5 * np.sum(x ** 2)))

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(exact_boundaries=True, oracle="device"),
        dict(exact_boundaries=True, oracle="host"),
    ], ids=["plain", "device-oracle", "host-oracle"])
    def test_pipelined_matches_serial(self, kw):
        xs_s, ys_s = run_lagged_campaign(self._opt(**kw), self._plant,
                                         n_iter=5, pipelined=False)
        xs_p, ys_p = run_lagged_campaign(self._opt(**kw), self._plant,
                                         n_iter=5, pipelined=True)
        np.testing.assert_array_equal(xs_p, xs_s)
        np.testing.assert_array_equal(ys_p, ys_s)

    def test_async_matches_blocking(self):
        a, b = self._opt(), self._opt()
        np.testing.assert_array_equal(
            np.asarray(b.optimize_async().result()),
            np.asarray(a.optimize()))

    def test_stats_recorded_at_result(self):
        opt = self._opt(exact_boundaries=True, oracle="device")
        p = opt.optimize_async()
        n0 = len(opt.stats.history)
        p.result()
        assert len(opt.stats.history) == n0 + 1
        p.result()                       # idempotent
        assert len(opt.stats.history) == n0 + 1
