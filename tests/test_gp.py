"""GP engine tests: kernels and regression vs the NumPy f64 reference."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from safeopt_tpu.gp import (GPRegression, Matern32, Product, RBF, gp_append,
                            gp_pop, gp_predict)

from reference_impl import RefGP, RefMatern32, RefRBF


RNG = np.random.default_rng(0)


def _pairs():
    """(ours, reference) kernel pairs covering the consumed feature set."""
    return [
        (RBF(1), RefRBF(1)),
        (RBF(2, variance=2.0, lengthscale=0.7),
         RefRBF(2, variance=2.0, lengthscale=0.7)),
        (RBF(3, variance=1.5, lengthscale=[0.5, 1.0, 2.0], ARD=True),
         RefRBF(3, variance=1.5, lengthscale=[0.5, 1.0, 2.0], ARD=True)),
        (Matern32(2, variance=4.0, lengthscale=1.3),
         RefMatern32(2, variance=4.0, lengthscale=1.3)),
        (RBF(1, variance=2.0, active_dims=[0]) *
         RBF(1, variance=1.0, lengthscale=2.0, active_dims=[1]),
         RefRBF(1, variance=2.0, active_dims=[0]) *
         RefRBF(1, variance=1.0, lengthscale=2.0, active_dims=[1])),
    ]


class TestKernels:
    def test_gram_matches_reference(self):
        for ours, ref in _pairs():
            d = ours.input_dim if not isinstance(ours, Product) else 2
            X = RNG.normal(size=(7, d))
            Z = RNG.normal(size=(5, d))
            assert_allclose(np.asarray(ours.K(X, Z)), ref.K(X, Z),
                            rtol=1e-12, atol=1e-12)
            assert_allclose(np.asarray(ours.K(X)), ref.K(X),
                            rtol=1e-12, atol=1e-12)
            assert_allclose(np.asarray(ours.Kdiag(X)), ref.Kdiag(X),
                            rtol=1e-12)

    def test_product_input_dim(self):
        k = RBF(1, active_dims=[0]) * RBF(1, active_dims=[1])
        assert k.input_dim == 2
        assert k.active_dims == (0, 1)

    def test_copy_is_independent(self):
        k = RBF(2, variance=3.0)
        k2 = k.copy()
        assert np.asarray(k2.variance) == 3.0
        assert k2.input_dim == 2

    def test_matern_at_zero_distance(self):
        k = Matern32(1, variance=4.0)
        X = np.zeros((1, 1))
        assert_allclose(np.asarray(k.K(X, X)), [[4.0]], rtol=1e-10)


class TestGPRegression:
    def test_posterior_matches_reference(self):
        X = RNG.normal(size=(10, 2))
        Y = RNG.normal(size=(10, 1))
        Xq = RNG.normal(size=(20, 2))
        kern = RBF(2, variance=2.0, lengthscale=0.8)
        rkern = RefRBF(2, variance=2.0, lengthscale=0.8)

        gp = GPRegression(X, Y, kern, noise_var=0.05 ** 2)
        ref = RefGP(X, Y, rkern, noise_var=0.05 ** 2)

        mu, var = gp.predict_noiseless(Xq)
        rmu, rvar = ref.predict_noiseless(Xq)
        assert_allclose(np.asarray(mu), rmu, rtol=1e-9, atol=1e-11)
        assert_allclose(np.asarray(var), rvar, rtol=1e-9, atol=1e-11)

    def test_incremental_append_matches_full_refit(self):
        kern = Matern32(1, variance=2.0)
        rkern = RefMatern32(1, variance=2.0)
        X0 = np.array([[0.0]])
        Y0 = np.array([[1.0]])
        gp = GPRegression(X0, Y0, kern, noise_var=0.01)
        ref = RefGP(X0, Y0, rkern, noise_var=0.01)
        Xq = np.linspace(-3, 3, 25)[:, None]

        for i in range(40):  # crosses capacity-growth boundary (64 init cap)
            x = RNG.normal(size=(1, 1))
            y = RNG.normal(size=(1, 1))
            gp.set_XY(np.vstack([np.asarray(gp.X), x]),
                      np.vstack([np.asarray(gp.Y), y]))
            ref.set_XY(np.vstack([ref.X, x]), np.vstack([ref.Y, y]))

        mu, var = gp.predict_noiseless(Xq)
        rmu, rvar = ref.predict_noiseless(Xq)
        assert_allclose(np.asarray(mu), rmu, rtol=1e-8, atol=1e-10)
        assert_allclose(np.asarray(var), rvar, rtol=1e-8, atol=1e-10)

    def test_append_then_pop_is_identity(self):
        kern = RBF(2)
        X = RNG.normal(size=(5, 2))
        Y = RNG.normal(size=(5, 1))
        gp = GPRegression(X, Y, kern, noise_var=0.1)
        Xq = RNG.normal(size=(8, 2))
        mu0, var0 = gp.predict_noiseless(Xq)

        gp.append_data(np.array([1.0, -1.0]), 0.5)
        gp.pop_data()

        mu1, var1 = gp.predict_noiseless(Xq)
        assert_allclose(np.asarray(mu1), np.asarray(mu0), rtol=1e-12,
                        atol=1e-14)
        assert_allclose(np.asarray(var1), np.asarray(var0), rtol=1e-12,
                        atol=1e-14)
        assert gp.num_data == 5

    def test_set_xy_full_replace(self):
        gp = GPRegression(np.zeros((1, 1)), np.ones((1, 1)), RBF(1),
                          noise_var=0.01)
        Xn = RNG.normal(size=(6, 1))
        Yn = RNG.normal(size=(6, 1))
        gp.set_XY(Xn, Yn)
        assert gp.num_data == 6
        ref = RefGP(Xn, Yn, RefRBF(1), noise_var=0.01)
        Xq = np.linspace(-2, 2, 9)[:, None]
        mu, var = gp.predict_noiseless(Xq)
        rmu, rvar = ref.predict_noiseless(Xq)
        assert_allclose(np.asarray(mu), rmu, rtol=1e-9, atol=1e-11)
        assert_allclose(np.asarray(var), rvar, rtol=1e-9, atol=1e-11)

    def test_set_xy_pop_last(self):
        X = RNG.normal(size=(4, 1))
        Y = RNG.normal(size=(4, 1))
        gp = GPRegression(X, Y, RBF(1), noise_var=0.01)
        gp.set_XY(X[:-1], Y[:-1])
        assert gp.num_data == 3
        assert_allclose(np.asarray(gp.X), X[:-1])

    def test_default_kernel_and_noise(self):
        # GPy defaults: RBF(d) kernel, noise_var=1.0
        gp = GPRegression(np.zeros((1, 2)), np.ones((1, 1)))
        assert isinstance(gp.kern, RBF)
        assert gp.kern.input_dim == 2
        assert gp.noise_var == 1.0

    def test_prior_reversion_far_from_data(self):
        gp = GPRegression(np.zeros((1, 1)), np.ones((1, 1)),
                          RBF(1, variance=2.0), noise_var=0.01)
        mu, var = gp.predict_noiseless(np.array([[100.0]]))
        assert abs(float(mu[0, 0])) < 1e-8
        assert_allclose(float(var[0, 0]), 2.0, rtol=1e-9)

    def test_jitted_core_functions(self):
        """gp_append/gp_pop/gp_predict compose under jit transformations."""
        import jax

        kern = RBF(1)
        gp = GPRegression(np.zeros((1, 1)), np.ones((1, 1)), kern,
                          noise_var=0.1)
        state = gp.state

        @jax.jit
        def virtual_update_predict(state, x, y, xq):
            st2 = gp_append(kern, state, x, y)
            mu, var = gp_predict(kern, st2, xq)
            st3 = gp_pop(st2)
            return mu, var, st3

        mu, var, st3 = virtual_update_predict(
            state, np.array([0.5]), np.array(2.0), np.array([[0.25]]))
        ref = RefGP(np.array([[0.0], [0.5]]), np.array([[1.0], [2.0]]),
                    RefRBF(1), noise_var=0.1)
        rmu, rvar = ref.predict_noiseless(np.array([[0.25]]))
        assert_allclose(np.asarray(mu), rmu[:, 0], rtol=1e-9)
        assert_allclose(np.asarray(var), rvar[:, 0], rtol=1e-9)
        assert int(st3.count) == 1


class TestNumericalStability:
    def test_no_drift_over_many_appends_and_pops(self):
        """150 interleaved appends/pops: incremental factors stay
        within float64 noise of a from-scratch refactorization."""
        rng = np.random.default_rng(21)
        kern = RBF(2, variance=2.0, lengthscale=0.8)
        gp = GPRegression(np.zeros((1, 2)), np.ones((1, 1)), kern,
                          noise_var=1e-4)
        for i in range(150):
            gp.append_data(rng.uniform(-3, 3, size=2), float(rng.normal()))
            if i % 3 == 2:
                gp.pop_data()

        Xq = rng.uniform(-3, 3, size=(20, 2))
        mu_inc, var_inc = gp.predict_noiseless(Xq)

        gp.refit()
        mu_ref, var_ref = gp.predict_noiseless(Xq)
        assert_allclose(np.asarray(mu_inc), np.asarray(mu_ref),
                        rtol=1e-9, atol=1e-11)
        assert_allclose(np.asarray(var_inc), np.asarray(var_ref),
                        rtol=1e-8, atol=1e-11)


class TestSetXYFastPath:
    def test_sixteen_row_append_stays_incremental(self):
        """Any pure-append delta uses the O(k n^2) bordering path (the
        round-1 implementation silently degraded to a refit above 4
        rows); parity with a from-scratch factorization stays exact."""
        rng = np.random.default_rng(11)
        X = rng.uniform(-2, 2, size=(6, 2))
        Y = np.sum(np.sin(X), axis=1, keepdims=True)
        gp = GPRegression(X, Y, RBF(2, variance=1.5), noise_var=0.01)

        refits = []
        orig_set_data = type(gp._host).set_data

        def counting_set_data(self, *a, **kw):
            refits.append(1)
            return orig_set_data(self, *a, **kw)

        X_new = rng.uniform(-2, 2, size=(16, 2))
        Y_new = np.sum(np.sin(X_new), axis=1, keepdims=True)
        X_all = np.vstack([X, X_new])
        Y_all = np.vstack([Y, Y_new])

        import unittest.mock as mock
        with mock.patch.object(type(gp._host), "set_data",
                               counting_set_data):
            gp.set_XY(X_all, Y_all)
        assert not refits, "16-row append fell back to a full refit"
        assert gp.num_data == 22

        fresh = GPRegression(X_all, Y_all, RBF(2, variance=1.5),
                             noise_var=0.01)
        q = rng.uniform(-2, 2, size=(40, 2))
        m1, v1 = gp.predict_noiseless(q)
        m2, v2 = fresh.predict_noiseless(q)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2),
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                                   atol=1e-10)

    def test_sixteen_row_truncate_stays_incremental(self):
        rng = np.random.default_rng(12)
        X = rng.uniform(-2, 2, size=(22, 2))
        Y = np.sum(np.sin(X), axis=1, keepdims=True)
        gp = GPRegression(X, Y, RBF(2), noise_var=0.01)

        refits = []
        orig_set_data = type(gp._host).set_data

        def counting_set_data(self, *a, **kw):
            refits.append(1)
            return orig_set_data(self, *a, **kw)

        import unittest.mock as mock
        with mock.patch.object(type(gp._host), "set_data",
                               counting_set_data):
            gp.set_XY(X[:6], Y[:6])
        assert not refits
        assert gp.num_data == 6

        fresh = GPRegression(X[:6], Y[:6], RBF(2), noise_var=0.01)
        q = rng.uniform(-2, 2, size=(25, 2))
        m1, v1 = gp.predict_noiseless(q)
        m2, v2 = fresh.predict_noiseless(q)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2),
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                                   atol=1e-10)


class TestMatern52:
    """Matern-5/2 (round-2 new kernel) across every layer: jax gram,
    host f64 gram, native C++ gram, GP posterior vs the independent
    scipy reference, checkpoint roundtrip."""

    def test_gram_matches_reference_everywhere(self):
        from reference_impl import RefMatern52

        from safeopt_tpu import native
        from safeopt_tpu.gp import Matern52
        from safeopt_tpu.gp.host_math import np_kernel

        rng = np.random.default_rng(21)
        X = rng.normal(size=(6, 3))
        Z = rng.normal(size=(9, 3))
        kern = Matern52(3, variance=1.8, lengthscale=[0.7, 1.1, 1.6],
                        ARD=True)
        rkern = RefMatern52(3, variance=1.8, lengthscale=[0.7, 1.1, 1.6],
                            ARD=True)
        expected = rkern.K(X, Z)
        np.testing.assert_allclose(np.asarray(kern.K(X, Z)), expected,
                                   atol=1e-12)
        np.testing.assert_allclose(np_kernel(kern, X, Z), expected,
                                   atol=1e-12)
        if native.available():
            got = native.gram("matern52", X, Z,
                              np.asarray([0.7, 1.1, 1.6]), 1.8)
            np.testing.assert_allclose(got, expected, atol=1e-12)

    def test_posterior_and_safeopt_lockstep(self):
        from reference_impl import RefGP, RefMatern52, RefSafeOpt

        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import Matern52

        rkern = RefMatern52(1, variance=2.0, lengthscale=1.2)

        def f(x):
            return (rkern.K(np.atleast_2d(x), np.array([[0.0], [1.5]]))
                    @ np.array([2.0, 1.0]))

        x0 = np.array([[0.0]])
        grid = linearly_spaced_combinations([(-3.0, 3.0)], 120)
        gp = GPRegression(x0, f(x0)[:, None],
                          Matern52(1, variance=2.0, lengthscale=1.2),
                          noise_var=1e-4)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-4)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.1)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.1)
        for _ in range(5):
            x = np.asarray(opt.optimize())
            xr = np.asarray(ref.optimize())
            np.testing.assert_allclose(x, xr, atol=1e-9)
            y = np.array([[float(f(x)[0])]])
            opt.add_new_data_point(x, y)
            ref.add_new_data_point(x, y)
        np.testing.assert_array_equal(opt.S, ref.S)

    def test_fused_intervals_matern52(self):
        import jax.numpy as jnp

        from safeopt_tpu.algorithms.safe_opt_core import (
            _confidence_intervals)
        from safeopt_tpu.gp import Matern52

        kern = Matern52(2, variance=1.5, lengthscale=0.9)
        rng = np.random.default_rng(4)
        X = rng.uniform(-2, 2, size=(12, 2))
        Y = np.sum(np.sin(X), axis=1, keepdims=True)
        gp = GPRegression(X, Y, kern, noise_var=0.01)
        grid = rng.uniform(-3, 3, size=(640, 2))
        gd = jnp.asarray(grid, gp.state.X.dtype)
        Q = np.asarray(_confidence_intervals((kern,), (gp.state,), gd,
                                             jnp.asarray(2.0))[0])
        mu, var = gp.predict_f64(grid)
        sd = np.sqrt(var)
        np.testing.assert_allclose(Q[:, 0], mu - 2 * sd,
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(Q[:, 1], mu + 2 * sd,
                                   rtol=1e-8, atol=1e-10)

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu import SafeOptSwarm
        from safeopt_tpu.gp import Matern52
        from safeopt_tpu.utils import checkpoint

        gp = GPRegression(np.array([[0.0]]), np.array([[1.0]]),
                          Matern52(1, variance=2.0), noise_var=0.01)
        opt = SafeOptSwarm(gp, fmin=[0.0], bounds=[[-2.0, 2.0]],
                           swarm_size=8)
        path = str(tmp_path / "m52.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        assert type(opt2.gp.kern).__name__ == "Matern52"
        q = np.linspace(-2, 2, 15)[:, None]
        m1, _ = gp.predict_noiseless(q)
        m2, _ = opt2.gp.predict_noiseless(q)
        np.testing.assert_allclose(np.asarray(m2), np.asarray(m1),
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# round 3: GPy-compat prediction surface beyond the reference's consumption
# ---------------------------------------------------------------------------


class TestGPyCompatSurface:
    def _gp(self, n=20, seed=4):
        rng = np.random.default_rng(seed)
        X = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
        Y = np.sin(X) + 0.05 * rng.normal(size=(n, 1))
        return GPRegression(X, Y, RBF(1, variance=2.0, lengthscale=1.0),
                            noise_var=0.05 ** 2)

    def test_predict_adds_likelihood_noise(self):
        gp = self._gp()
        Xq = np.linspace(-3, 3, 9)[:, None]
        mu_n, var_n = gp.predict_noiseless(Xq)
        mu_p, var_p = gp.predict(Xq)
        np.testing.assert_allclose(np.asarray(mu_p), np.asarray(mu_n))
        np.testing.assert_allclose(np.asarray(var_p),
                                   np.asarray(var_n) + 0.05 ** 2,
                                   rtol=1e-6)
        _, var_l = gp.predict(Xq, include_likelihood=False)
        np.testing.assert_allclose(np.asarray(var_l), np.asarray(var_n))

    def test_log_likelihood_matches_direct_formula(self):
        gp = self._gp(n=15)
        X = np.asarray(gp.X_host)
        Y = np.asarray(gp.Y_host)
        K = 2.0 * np.exp(-0.5 * (X - X.T) ** 2) + 0.05 ** 2 * np.eye(15)
        sign, logdet = np.linalg.slogdet(K)
        want = (-0.5 * Y[:, 0] @ np.linalg.solve(K, Y[:, 0])
                - 0.5 * logdet - 7.5 * np.log(2 * np.pi))
        np.testing.assert_allclose(gp.log_likelihood(), want, rtol=1e-8)

    def test_posterior_samples_f_statistics(self):
        import jax

        gp = self._gp()
        Xq = np.linspace(-3, 3, 7)[:, None]
        draws = gp.posterior_samples_f(Xq, size=4000,
                                       key=jax.random.key(1))
        assert draws.shape == (7, 1, 4000)
        mu, var = gp.predict_noiseless(Xq)
        emp_mu = draws[:, 0, :].mean(axis=1)
        emp_var = draws[:, 0, :].var(axis=1)
        np.testing.assert_allclose(emp_mu, np.asarray(mu)[:, 0],
                                   atol=4 * np.sqrt(
                                       np.asarray(var)[:, 0].max() / 4000)
                                   + 0.02)
        np.testing.assert_allclose(emp_var, np.asarray(var)[:, 0],
                                   rtol=0.15, atol=1e-4)
        # samples at training points interpolate the data closely
        d0 = gp.posterior_samples_f(np.asarray(gp.X_host)[:3], size=50,
                                    key=jax.random.key(2))
        spread = d0[:, 0, :].std(axis=1)
        assert np.all(spread < 0.1)      # pinned by observations

    def test_posterior_samples_respect_joint_correlation(self):
        """Nearby query points must draw CORRELATED values (a diagonal-
        only sampler fails this)."""
        import jax

        gp = self._gp(n=5)
        Xq = np.array([[5.0], [5.01]])   # far from data: prior-like
        draws = gp.posterior_samples_f(Xq, size=2000,
                                       key=jax.random.key(3))
        a, b = draws[0, 0, :], draws[1, 0, :]
        corr = np.corrcoef(a, b)[0, 1]
        assert corr > 0.98

    def test_sparse_predict_and_samples(self):
        import jax

        from safeopt_tpu.gp.sparse import SparseGPRegression

        rng = np.random.default_rng(6)
        X = np.sort(rng.uniform(-3, 3, size=(40, 1)), axis=0)
        Y = np.sin(X) + 0.05 * rng.normal(size=(40, 1))
        gp = SparseGPRegression(X, Y, RBF(1, variance=2.0), noise_var=0.01,
                                inducing=12)
        Xq = np.linspace(-3, 3, 6)[:, None]
        mu_n, var_n = gp.predict_noiseless(Xq)
        mu_p, var_p = gp.predict(Xq)
        np.testing.assert_allclose(var_p, var_n + 0.01, rtol=1e-8)
        assert np.isfinite(gp.log_likelihood())
        draws = gp.posterior_samples_f(Xq, size=3000,
                                       key=jax.random.key(4))
        assert draws.shape == (6, 1, 3000)
        np.testing.assert_allclose(draws[:, 0, :].mean(axis=1),
                                   mu_n[:, 0], atol=0.05)
        np.testing.assert_allclose(draws[:, 0, :].var(axis=1),
                                   var_n[:, 0], rtol=0.2, atol=1e-3)

    def test_sparse_log_likelihood_equals_exact_when_z_is_x(self):
        from safeopt_tpu.gp.sparse import SparseGPRegression

        rng = np.random.default_rng(8)
        X = rng.uniform(-2, 2, size=(12, 1))
        Y = np.sin(X)
        exact = GPRegression(X, Y, RBF(1, variance=2.0), noise_var=0.05)
        sparse = SparseGPRegression(X, Y, RBF(1, variance=2.0),
                                    noise_var=0.05, inducing=X)
        np.testing.assert_allclose(sparse.log_likelihood(),
                                   exact.log_likelihood(), rtol=1e-4)


class TestIncrementalDeviceMirror:
    """append/pop propagate ONE row to the device state (and the f64
    oracle mirror) instead of re-shipping O(cap^2) factors every
    observation. Must be BIT-identical to a full rebuild."""

    def _gp(self):
        from safeopt_tpu.gp import GPRegression, RBF
        rng = np.random.default_rng(5)
        X = rng.uniform(-2, 2, size=(10, 2))
        Y = (np.exp(-0.5 * np.sum(X ** 2, axis=1)))[:, None]
        return GPRegression(X, Y, RBF(2, variance=1.5), noise_var=1e-3,
                            capacity=64)

    @staticmethod
    def _assert_state_equal(a, b):
        for name in ("X", "Y", "L", "Linv", "w"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, name)),
                np.asarray(getattr(b, name)), err_msg=name)
        assert int(a.count) == int(b.count)

    def test_append_pop_bitwise_vs_rebuild(self):
        gp = self._gp()
        rng = np.random.default_rng(0)
        for k in range(6):
            gp.append_data(rng.uniform(-2, 2, size=2), float(k) / 7)
        gp.pop_data()
        gp.append_data(np.array([0.1, -0.4]), 0.3)
        gp.pop_data()
        gp.pop_data()
        incremental = gp.state
        rebuilt = gp._device_state()
        self._assert_state_equal(incremental, rebuilt)

    def test_oracle_mirror_row_update_bitwise(self):
        gp = self._gp()
        st0, _ = gp.device_oracle_state()      # materialize the cache
        rng = np.random.default_rng(1)
        gp.append_data(rng.uniform(-2, 2, size=2), 0.7)
        gp.append_data(rng.uniform(-2, 2, size=2), 0.2)
        gp.pop_data()
        incremental = gp._oracle_cache
        gp._oracle_cache = None                # force a full rebuild
        rebuilt, _ = gp.device_oracle_state()
        for name in ("X", "F", "w", "alpha"):
            np.testing.assert_array_equal(
                np.asarray(getattr(incremental, name)),
                np.asarray(getattr(rebuilt, name)), err_msg=name)
        assert int(incremental.count) == int(rebuilt.count)

    def test_capacity_growth_falls_back_to_rebuild(self):
        from safeopt_tpu.gp import GPRegression, RBF
        X = np.zeros((1, 1))
        gp = GPRegression(X, np.ones((1, 1)), RBF(1), noise_var=1e-3)
        cap0 = gp.state.capacity
        for k in range(cap0 + 3):
            gp.append_data(np.array([0.01 * (k + 1)]), 0.5)
        assert gp.state.capacity > cap0
        self._assert_state_equal(gp.state, gp._device_state())
