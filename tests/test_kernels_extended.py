"""Extended kernel algebra: Sum / Exponential / Bias / White.

Beyond the reference's consumed GPy surface (SURVEY.md section 2.8
lists RBF / Matern-3/2 / product); these are the adjacent GPy features
real users reach for (``k1 + k2``, offset, jitter, OU processes).
Checks device grams against the host f64 mirror, full GP regression
against a direct NumPy solve, the fused step's interval pass,
hyperparameter fitting, and checkpoint round-trips.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from safeopt_tpu.gp import (Bias, Exponential, GPRegression, Matern32,
                            RBF, Sum, White)
from safeopt_tpu.gp.host_math import np_kdiag, np_kernel

RNG = np.random.default_rng(11)


def _interval_pass(kern, state, grid, beta):
    """(l, u) of one GP from the fused step's grid interval pass."""
    import jax.numpy as jnp

    from safeopt_tpu.algorithms.safe_opt_core import _confidence_intervals

    Q = _confidence_intervals((kern,), (state,),
                              jnp.asarray(grid, state.X.dtype),
                              jnp.asarray(beta, state.X.dtype))[0]
    return np.asarray(Q[:, 0]), np.asarray(Q[:, 1])


def _algebras():
    return [
        ("sum", lambda: RBF(2, variance=2.0, lengthscale=0.8)
         + Matern32(2, variance=0.5, lengthscale=1.5)),
        ("sum_bias", lambda: RBF(2, variance=1.5, lengthscale=1.0)
         + Bias(2, variance=0.3)),
        ("exponential", lambda: Exponential(2, variance=1.2,
                                            lengthscale=[0.7, 1.4],
                                            ARD=True)),
        ("sum_of_products", lambda: (RBF(1, active_dims=[0])
                                     * Matern32(1, active_dims=[1]))
         + Exponential(2, variance=0.4)),
    ]


@pytest.mark.parametrize("name,make", _algebras())
def test_device_gram_matches_host_f64(name, make):
    kern = make()
    X = RNG.uniform(-2, 2, size=(7, 2))
    Z = RNG.uniform(-2, 2, size=(5, 2))
    assert_allclose(np.asarray(kern.K(X, Z)), np_kernel(kern, X, Z),
                    rtol=1e-12, atol=1e-14)
    assert_allclose(np.asarray(kern.K(X)), np_kernel(kern, X),
                    rtol=1e-12, atol=1e-14)
    assert_allclose(np.asarray(kern.Kdiag(X)), np_kdiag(kern, X),
                    rtol=1e-12, atol=1e-14)


def test_white_kernel_gpy_semantics():
    """GPy White: var*I on one set, exactly zero across two sets."""
    k = White(2, variance=0.7)
    X = RNG.uniform(-1, 1, size=(4, 2))
    assert_allclose(np.asarray(k.K(X)), 0.7 * np.eye(4), atol=0)
    # cross-gram is zero even for coincident points
    assert_allclose(np.asarray(k.K(X, X.copy())), np.zeros((4, 4)), atol=0)
    assert_allclose(np.asarray(k.Kdiag(X)), 0.7 * np.ones(4), atol=0)
    assert_allclose(np_kernel(k, X), 0.7 * np.eye(4), atol=0)
    assert_allclose(np_kernel(k, X, X.copy()), np.zeros((4, 4)), atol=0)


@pytest.mark.parametrize("name,make", _algebras() + [
    ("rbf_plus_white", lambda: RBF(2, variance=2.0) + White(2, variance=0.1)),
])
def test_gp_regression_matches_direct_solve(name, make):
    """Posterior with composed kernels equals the direct f64 solve."""
    kern = make()
    X = RNG.uniform(-2, 2, size=(9, 2))
    Y = RNG.normal(size=(9, 1))
    noise = 0.05
    gp = GPRegression(X, Y, kern, noise_var=noise)

    Xq = RNG.uniform(-2, 2, size=(20, 2))
    mu, var = gp.predict_noiseless(Xq)

    K = np_kernel(kern, X) + noise * np.eye(9)
    kq = np_kernel(kern, X, Xq)
    alpha = np.linalg.solve(K, Y[:, 0])
    mu_ref = kq.T @ alpha
    var_ref = np_kdiag(kern, Xq) - np.sum(kq * np.linalg.solve(K, kq),
                                          axis=0)
    assert_allclose(mu[:, 0], mu_ref, rtol=1e-8, atol=1e-10)
    assert_allclose(var[:, 0], var_ref, rtol=1e-8, atol=1e-10)


def test_incremental_append_pop_with_sum_kernel():
    kern = RBF(1, variance=2.0) + Bias(1, variance=0.2)
    gp = GPRegression(np.array([[0.0]]), np.array([[1.0]]), kern,
                      noise_var=0.01)
    Xq = np.linspace(-1, 1, 7)[:, None]
    mu0, var0 = gp.predict_noiseless(Xq)
    gp.append_data(np.array([0.4]), 1.3)
    gp.pop_data()
    mu1, var1 = gp.predict_noiseless(Xq)
    assert_allclose(mu1, mu0, rtol=1e-10, atol=1e-12)
    assert_allclose(var1, var0, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,make", _algebras())
def test_fused_intervals_extended_algebra(name, make):
    """Sum-of-products algebras through the fused step's grid interval
    pass, against the host float64 oracle."""
    kern = make()
    X = RNG.uniform(-2, 2, size=(10, 2))
    Y = RNG.normal(size=(10, 1))
    gp = GPRegression(X, Y, kern, noise_var=0.01)

    grid = RNG.uniform(-3, 3, size=(300, 2))
    beta = 2.0
    l, u = _interval_pass(kern, gp.state, grid, beta)
    mu, var = gp.predict_f64(grid)
    assert_allclose(l, mu - beta * np.sqrt(var), rtol=1e-9, atol=1e-10)
    assert_allclose(u, mu + beta * np.sqrt(var), rtol=1e-9, atol=1e-10)


def test_hyperopt_sum_kernel():
    """LML fitting walks every leaf of a Sum composition."""
    from safeopt_tpu.gp import fit_hyperparameters, log_marginal_likelihood

    true = RBF(1, variance=2.0, lengthscale=0.5)
    X = np.linspace(-3, 3, 40)[:, None]
    K = np_kernel(true, X) + 0.01 * np.eye(40)
    Y = np.linalg.cholesky(K) @ RNG.normal(size=(40, 1))

    kern0 = RBF(1, variance=1.0, lengthscale=2.0) + Bias(1, variance=1.0)
    lml0 = float(log_marginal_likelihood(kern0, X, Y, 0.01))
    kern1, nv, lml1 = fit_hyperparameters(kern0, X, Y, 0.01, steps=100)
    assert lml1 > lml0
    assert isinstance(kern1, Sum)
    assert np.all(np.isfinite(np.asarray(kern1.k1.lengthscale)))


def test_checkpoint_roundtrip_sum_kernel(tmp_path):
    from safeopt_tpu.algorithms import SafeOpt
    from safeopt_tpu.utils import checkpoint
    from safeopt_tpu.utils.grids import linearly_spaced_combinations

    kern = (RBF(1, variance=2.0, lengthscale=0.8)
            + Exponential(1, variance=0.4, lengthscale=2.0))
    gp = GPRegression(np.array([[0.0]]), np.array([[1.0]]), kern,
                      noise_var=0.01)
    grid = linearly_spaced_combinations([(-3, 3)], 101)
    opt = SafeOpt([gp], grid, fmin=[0.0], beta=2.0)
    x0 = opt.optimize()

    path = str(tmp_path / "ck.npz")
    checkpoint.save(opt, path)
    opt2 = checkpoint.load(path)
    assert isinstance(opt2.gps[0].kern, Sum)
    assert isinstance(opt2.gps[0].kern.k2, Exponential)
    x1 = opt2.optimize()
    assert_allclose(np.asarray(x1), np.asarray(x0), atol=0)


def test_white_kernel_full_loop_lockstep():
    """RBF + White through the full SafeOpt loop in lockstep with the
    f64 mirror (White adds prior variance on the diagonal of the
    training gram and the query Kdiag but no cross-correlation)."""
    import sys

    sys.path.insert(0, "tests") if "tests" not in sys.path[0] else None
    from reference_impl import RefGP, RefRBF, RefSafeOpt, RefWhite

    from safeopt_tpu import SafeOpt, linearly_spaced_combinations

    kern = RBF(1, variance=2.0, lengthscale=0.9) + White(1, variance=0.02)
    rkern = RefRBF(1, variance=2.0, lengthscale=0.9) \
        + RefWhite(1, variance=0.02)

    centers = np.array([[-2.0], [0.0], [2.5]])
    weights = np.array([0.8, 1.6, -0.6])
    rbf_only = RefRBF(1, variance=2.0, lengthscale=0.9)

    def f(x):
        return rbf_only.K(np.atleast_2d(x), centers) @ weights

    x0 = np.array([[0.0]])
    assert f(x0)[0] > 0.5
    grid = linearly_spaced_combinations([(-5.0, 5.0)], 180)
    gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3)
    rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
    opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.1)
    ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.1)
    for it in range(6):
        x = np.asarray(opt.optimize())
        xr = np.asarray(ref.optimize())
        assert_allclose(x, xr, atol=1e-9,
                        err_msg=f"diverged at iteration {it}")
        y = float(f(x)[0])
        opt.add_new_data_point(x, np.array([[y]]))
        ref.add_new_data_point(x, np.array([[y]]))
    np.testing.assert_array_equal(opt.S, ref.S)


def test_sparse_gp_with_sum_kernel():
    """DTC sparse regression composes with the round-2 algebra."""
    from safeopt_tpu.gp import SparseGPRegression

    kern = RBF(1, variance=2.0, lengthscale=0.8) + Bias(1, variance=0.2)
    X = np.linspace(-3, 3, 40)[:, None]
    rng = np.random.default_rng(2)
    K = np_kernel(kern, X) + 0.01 * np.eye(40)
    Y = np.linalg.cholesky(K) @ rng.normal(size=(40, 1))

    sgp = SparseGPRegression(X, Y, kern, noise_var=0.01, inducing=40)
    gp = GPRegression(X, Y, kern, noise_var=0.01)
    Xq = np.linspace(-3, 3, 25)[:, None]
    mu_s, var_s = sgp.predict_noiseless(Xq)
    mu_d, var_d = gp.predict_noiseless(Xq)
    # inducing == data: DTC mean equals the exact GP mean
    assert_allclose(np.asarray(mu_s), np.asarray(mu_d), rtol=1e-6,
                    atol=1e-8)


class TestRatQuad:
    def test_gram_and_posterior(self):
        from safeopt_tpu.gp import RatQuad

        kern = RatQuad(2, variance=2.0, lengthscale=[0.8, 1.4], power=1.5,
                       ARD=True)
        X = RNG.uniform(-2, 2, size=(9, 2))
        Z = RNG.uniform(-2, 2, size=(5, 2))
        assert_allclose(np.asarray(kern.K(X, Z)), np_kernel(kern, X, Z),
                        rtol=1e-12, atol=1e-14)

        Y = RNG.normal(size=(9, 1))
        gp = GPRegression(X, Y, kern, noise_var=0.05)
        Xq = RNG.uniform(-2, 2, size=(15, 2))
        mu, var = gp.predict_noiseless(Xq)
        K = np_kernel(kern, X) + 0.05 * np.eye(9)
        kq = np_kernel(kern, X, Xq)
        mu_ref = kq.T @ np.linalg.solve(K, Y[:, 0])
        assert_allclose(mu[:, 0], mu_ref, rtol=1e-8, atol=1e-10)

    def test_trajectory_lockstep(self):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import RatQuad

        from reference_impl import RefGP, RefRatQuad, RefSafeOpt

        kern = RatQuad(1, variance=2.0, lengthscale=0.9, power=1.2)
        rkern = RefRatQuad(1, variance=2.0, lengthscale=0.9, power=1.2)
        centers = np.array([[-2.0], [0.0], [2.5]])
        weights = np.array([0.8, 1.6, -0.6])

        def f(x):
            return rkern.K(np.atleast_2d(x), centers) @ weights

        x0 = np.array([[0.0]])
        assert f(x0)[0] > 0.5
        grid = linearly_spaced_combinations([(-5.0, 5.0)], 180)
        gp = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-3)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-3)
        opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.1)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.1)
        for it in range(6):
            x = np.asarray(opt.optimize())
            xr = np.asarray(ref.optimize())
            assert_allclose(x, xr, atol=1e-9,
                            err_msg=f"diverged at iteration {it}")
            y = float(f(x)[0])
            opt.add_new_data_point(x, np.array([[y]]))
            ref.add_new_data_point(x, np.array([[y]]))
        np.testing.assert_array_equal(opt.S, ref.S)

    def test_hyperopt_fits_power(self):
        from safeopt_tpu.gp import RatQuad, fit_hyperparameters
        from safeopt_tpu.gp.hyperopt import log_marginal_likelihood

        true = RatQuad(1, variance=2.0, lengthscale=0.5, power=1.0)
        X = np.linspace(-3, 3, 35)[:, None]
        K = np_kernel(true, X) + 0.01 * np.eye(35)
        Y = np.linalg.cholesky(K) @ RNG.normal(size=(35, 1))
        k0 = RatQuad(1, variance=1.0, lengthscale=2.0, power=3.0)
        lml0 = float(log_marginal_likelihood(k0, X, Y, 0.01))
        k1, nv, lml1 = fit_hyperparameters(k0, X, Y, 0.01, steps=120)
        assert lml1 > lml0
        assert np.isfinite(float(np.asarray(k1.power)))

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu.algorithms import SafeOpt
        from safeopt_tpu.gp import RatQuad
        from safeopt_tpu.utils import checkpoint
        from safeopt_tpu.utils.grids import linearly_spaced_combinations

        kern = RatQuad(1, variance=2.0, lengthscale=0.8, power=1.7)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.0]]), kern,
                          noise_var=0.01)
        grid = linearly_spaced_combinations([(-3, 3)], 101)
        opt = SafeOpt([gp], grid, fmin=[0.0], beta=2.0)
        x0 = opt.optimize()
        path = str(tmp_path / "ck.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        assert isinstance(opt2.gps[0].kern, RatQuad)
        assert_allclose(float(np.asarray(opt2.gps[0].kern.power)), 1.7)
        assert_allclose(np.asarray(opt2.optimize()), np.asarray(x0),
                        atol=0)


# ---------------------------------------------------------------------------
# round 3: StdPeriodic (GPy standard periodic kernel)
# ---------------------------------------------------------------------------


class TestStdPeriodic:
    def test_matches_direct_formula(self):
        from safeopt_tpu.gp import StdPeriodic

        rng = np.random.default_rng(0)
        X = rng.uniform(-3, 3, size=(7, 2))
        Z = rng.uniform(-3, 3, size=(5, 2))
        kern = StdPeriodic(2, variance=1.7, period=[2.0, 3.0],
                           lengthscale=0.8, ARD1=True)
        K = np.asarray(kern.K(X, Z))
        s2 = np.zeros((7, 5))
        for j, T in enumerate([2.0, 3.0]):
            base = np.pi * (X[:, j][:, None] - Z[:, j][None, :]) / T
            s2 += (np.sin(base) / 0.8) ** 2
        assert_allclose(K, 1.7 * np.exp(-0.5 * s2), rtol=1e-6)
        assert_allclose(np.asarray(kern.Kdiag(X)), np.full(7, 1.7),
                        rtol=1e-6)

    def test_periodicity(self):
        from safeopt_tpu.gp import StdPeriodic

        kern = StdPeriodic(1, variance=2.0, period=1.5, lengthscale=0.7)
        x = np.array([[0.3]])
        z = np.array([[0.3 + 4 * 1.5]])       # shifted by whole periods
        assert_allclose(float(kern.K(x, z)[0, 0]), 2.0, rtol=1e-5)

    def test_host_f64_mirror_matches_device(self):
        from safeopt_tpu.gp import StdPeriodic
        from safeopt_tpu.gp.host_math import np_kernel, np_kdiag

        rng = np.random.default_rng(1)
        X = rng.uniform(-2, 2, size=(6, 2))
        kern = StdPeriodic(2, variance=1.2, period=2.5,
                           lengthscale=[0.5, 1.5], ARD2=True)
        assert_allclose(np_kernel(kern, X), np.asarray(kern.K(X)),
                        rtol=1e-6, atol=1e-8)
        assert_allclose(np_kdiag(kern, X), np.asarray(kern.Kdiag(X)),
                        rtol=1e-8)

    def test_gp_regression_and_safeopt(self):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, StdPeriodic

        period = 2.0
        X = np.linspace(-2, 2, 9)[:, None]
        Y = 1.0 + np.cos(np.pi * X)            # period-2 signal
        kern = StdPeriodic(1, variance=2.0, period=period,
                           lengthscale=1.0)
        gp = GPRegression(X, Y, kern, noise_var=1e-4)
        # posterior mean repeats with the period
        mu1, _ = gp.predict_noiseless(np.array([[0.25]]))
        mu2, _ = gp.predict_noiseless(np.array([[0.25 + 2 * period]]))
        assert abs(float(mu1[0, 0]) - float(mu2[0, 0])) < 1e-3

        grid = linearly_spaced_combinations([(-4.0, 4.0)], 80)
        opt = SafeOpt(gp, grid, fmin=[0.5])
        x = opt.optimize()
        assert -4.0 <= float(np.asarray(x)[0]) <= 4.0

    def test_sum_and_product_composition(self):
        from safeopt_tpu.gp import RBF, StdPeriodic
        from safeopt_tpu.gp.host_math import np_kernel

        rng = np.random.default_rng(2)
        X = rng.uniform(-2, 2, size=(5, 1))
        quasi = StdPeriodic(1, period=1.0) * RBF(1, lengthscale=5.0)
        assert_allclose(np_kernel(quasi, X), np.asarray(quasi.K(X)),
                        rtol=1e-6, atol=1e-8)
        both = StdPeriodic(1, period=1.0) + RBF(1)
        assert_allclose(np_kernel(both, X), np.asarray(both.K(X)),
                        rtol=1e-6, atol=1e-8)

    def test_hyperopt_fits_period(self):
        from safeopt_tpu.gp import GPRegression, StdPeriodic

        rng = np.random.default_rng(3)
        X = np.sort(rng.uniform(-4, 4, size=(60, 1)), axis=0)
        Y = np.sin(2 * np.pi * X / 1.5) + 0.05 * rng.normal(size=(60, 1))
        gp = GPRegression(X, Y, StdPeriodic(1, variance=1.0, period=1.3,
                                            lengthscale=1.0),
                          noise_var=0.05)
        lml0 = None
        from safeopt_tpu.gp.hyperopt import log_marginal_likelihood
        import jax
        with jax.enable_x64(True):
            lml0 = float(log_marginal_likelihood(gp.kern, X, Y, 0.05))
        lml = gp.optimize_hyperparameters(steps=200)
        assert lml > lml0
        assert 1.2 < float(np.asarray(gp.kern.period)) < 1.8

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, StdPeriodic
        from safeopt_tpu.utils import checkpoint

        X = np.array([[0.0]])
        Y = np.array([[1.5]])
        kern = StdPeriodic(1, variance=2.0, period=1.7, lengthscale=0.9)
        gp = GPRegression(X, Y, kern, noise_var=1e-3)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 40)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        path = str(tmp_path / "periodic.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        k2 = opt2.gps[0].kern
        assert type(k2).__name__ == "StdPeriodic"
        assert_allclose(float(np.asarray(k2.period)), 1.7)
        np.testing.assert_array_equal(np.asarray(opt2.optimize()),
                                      np.asarray(opt.optimize()))

    def test_export_roundtrip(self):
        import jax.numpy as jnp

        from safeopt_tpu import linearly_spaced_combinations
        from safeopt_tpu.algorithms.safe_opt_core import safeopt_step
        from safeopt_tpu.gp import GPRegression, StdPeriodic
        from safeopt_tpu.utils.deployment import export_step, load_step

        X = np.linspace(-1, 1, 5)[:, None]
        Y = 1.0 + np.cos(np.pi * X)
        kern = StdPeriodic(1, variance=2.0, period=2.0, lengthscale=1.0)
        gp = GPRegression(X, Y, kern, noise_var=1e-3, capacity=8)
        grid = jnp.asarray(np.asarray(
            linearly_spaced_combinations([(-2.0, 2.0)], 30)))
        dtype = gp.state.X.dtype
        args = ((gp.kern,), (gp.state,), grid, jnp.asarray([0.2], dtype),
                jnp.asarray(2.0, dtype), jnp.asarray([np.sqrt(2.0)], dtype),
                jnp.asarray([0.0], dtype))
        served = load_step(export_step(*args, chunk=8))
        out = served(*args)
        ref = safeopt_step(*args, chunk=8)
        np.testing.assert_array_equal(np.asarray(out.S), np.asarray(ref.S))
        assert int(out.next_idx) == int(ref.next_idx)


class TestLinear:
    """GPy.kern.Linear mirror: k(x, z) = sum_j variances_j x_j z_j,
    through every layer (device, host f64, native C++, hyperopt,
    checkpoint, export, SafeOpt loop)."""

    def test_matches_direct_formula_and_ard(self):
        from safeopt_tpu.gp import Linear

        rng = np.random.default_rng(0)
        X = rng.uniform(-3, 3, size=(7, 3))
        Z = rng.uniform(-3, 3, size=(5, 3))
        kern = Linear(3, variances=[0.5, 2.0, 1.3], ARD=True)
        v = np.array([0.5, 2.0, 1.3])
        assert_allclose(np.asarray(kern.K(X, Z)), (X * v) @ Z.T,
                        rtol=1e-6)
        assert_allclose(np.asarray(kern.Kdiag(X)), np.sum(X * X * v, 1),
                        rtol=1e-6)
        iso = Linear(3, variances=1.7)
        assert_allclose(np.asarray(iso.K(X, Z)), 1.7 * X @ Z.T, rtol=1e-6)

    def test_host_f64_and_native_gram(self):
        from safeopt_tpu import native
        from safeopt_tpu.gp import Linear
        from safeopt_tpu.gp.host_math import HostFactor, np_kdiag, np_kernel

        rng = np.random.default_rng(1)
        X = rng.uniform(-2, 2, size=(6, 2))
        kern = Linear(2, variances=[1.2, 0.4], ARD=True)
        v = np.array([1.2, 0.4])
        assert_allclose(np_kernel(kern, X), (X * v) @ X.T, rtol=1e-12)
        assert_allclose(np_kdiag(kern, X), np.sum(X * X * v, 1),
                        rtol=1e-12)
        if native.available():
            hf = HostFactor(kern, capacity=8, input_dim=2, noise_var=0.01)
            assert hf._native_kind == "linear"
            assert_allclose(hf._gram(X, X), (X * v) @ X.T, rtol=1e-12)

    def test_gp_regression_recovers_linear_function(self):
        from safeopt_tpu.gp import GPRegression, Linear

        rng = np.random.default_rng(2)
        X = rng.uniform(-2, 2, size=(25, 2))
        w_true = np.array([1.5, -0.7])
        Y = (X @ w_true)[:, None]
        gp = GPRegression(X, Y, Linear(2, variances=10.0),
                          noise_var=1e-6)
        Xq = rng.uniform(-2, 2, size=(10, 2))
        mu, var = gp.predict_noiseless(Xq)
        assert_allclose(mu[:, 0], Xq @ w_true, atol=1e-3)
        assert np.all(np.asarray(var) < 1e-2)

    def test_trajectory_lockstep_with_sum_kernel(self):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, Linear, RBF

        from reference_impl import (RefGP, RefLinear, RefRBF, RefSafeOpt)

        kern = RBF(1, variance=2.0, lengthscale=1.0) + Linear(
            1, variances=0.3)
        rkern = RefRBF(1, variance=2.0, lengthscale=1.0) + RefLinear(
            1, variances=0.3)

        def f(x):
            x = np.atleast_2d(x)
            return (1.5 * np.exp(-0.5 * (x[:, 0] - 0.3) ** 2)
                    + 0.4 * x[:, 0])

        x0 = np.array([[0.0]])
        y0 = np.array([[float(f(x0)[0])]])
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 120)
        gp = GPRegression(x0, y0, kern, noise_var=1e-4)
        rgp = RefGP(x0, y0, rkern, noise_var=1e-4)
        opt = SafeOpt(gp, grid, fmin=[-0.5], beta=2.0)
        ref = RefSafeOpt(rgp, grid, fmin=[-0.5], beta=2.0)
        for it in range(6):
            x = np.asarray(opt.optimize())
            x_ref = np.asarray(ref.optimize())
            assert_allclose(x, x_ref, atol=1e-9,
                            err_msg=f"diverged at iteration {it}")
            y = np.array([[float(f(x)[0])]])
            opt.add_new_data_point(x, y)
            ref.add_new_data_point(x, y)

    def test_auto_scaling_rejected_for_linear_only(self):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, Linear

        gp = GPRegression(np.array([[1.0]]), np.array([[1.0]]),
                          Linear(1, variances=1.0), noise_var=1e-4)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 30)
        with pytest.raises(ValueError, match="scaling"):
            SafeOpt(gp, grid, fmin=[0.0])
        opt = SafeOpt(gp, grid, fmin=[-10.0], scaling=[1.0])
        assert -2.0 <= float(np.asarray(opt.optimize())[0]) <= 2.0

    def test_hyperopt_fits_variances(self):
        from safeopt_tpu.gp import GPRegression, Linear

        rng = np.random.default_rng(3)
        X = rng.uniform(-2, 2, size=(40, 2))
        Y = (X @ np.array([2.0, 0.1]))[:, None] \
            + 0.05 * rng.normal(size=(40, 1))
        gp = GPRegression(X, Y, Linear(2, variances=[1.0, 1.0], ARD=True),
                          noise_var=0.05 ** 2)
        import jax

        from safeopt_tpu.gp.hyperopt import log_marginal_likelihood
        with jax.enable_x64(True):
            lml0 = float(log_marginal_likelihood(gp.kern, X, Y, 0.0025))
        lml = gp.optimize_hyperparameters(steps=200)
        assert lml > lml0
        v = np.asarray(gp.kern.variances)
        assert v[0] > v[1]              # the informative dim dominates

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, Linear, RBF
        from safeopt_tpu.utils import checkpoint

        kern = RBF(1, variance=2.0) + Linear(1, variances=0.7)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.0]]), kern,
                          noise_var=1e-3)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 40)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        path = str(tmp_path / "linear.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        k2 = opt2.gps[0].kern.k2
        assert type(k2).__name__ == "Linear"
        assert_allclose(float(np.asarray(k2.variances)), 0.7)
        np.testing.assert_array_equal(np.asarray(opt2.optimize()),
                                      np.asarray(opt.optimize()))

    def test_export_roundtrip(self):
        import jax.numpy as jnp

        from safeopt_tpu import linearly_spaced_combinations
        from safeopt_tpu.algorithms.safe_opt_core import safeopt_step
        from safeopt_tpu.gp import GPRegression, Linear, RBF
        from safeopt_tpu.utils.deployment import export_step, load_step

        X = np.linspace(-1, 1, 5)[:, None]
        Y = 1.0 + 0.5 * X
        kern = RBF(1, variance=2.0) + Linear(1, variances=0.5)
        gp = GPRegression(X, Y, kern, noise_var=1e-3, capacity=8)
        grid = jnp.asarray(np.asarray(
            linearly_spaced_combinations([(-2.0, 2.0)], 30)))
        dtype = gp.state.X.dtype
        args = ((gp.kern,), (gp.state,), grid, jnp.asarray([0.2], dtype),
                jnp.asarray(2.0, dtype), jnp.asarray([np.sqrt(2.0)], dtype),
                jnp.asarray([0.0], dtype))
        served = load_step(export_step(*args, chunk=8))
        out = served(*args)
        ref = safeopt_step(*args, chunk=8)
        np.testing.assert_array_equal(np.asarray(out.S), np.asarray(ref.S))
        assert int(out.next_idx) == int(ref.next_idx)



# ---------------------------------------------------------------------------
# round 3b: Cosine / Poly / MLP (GPy kernel families)
# ---------------------------------------------------------------------------


class TestCosine:
    """GPy.kern.Cosine mirror: k(r) = variance * cos(r), through every
    layer (device, host f64, native C++, fused step, hyperopt,
    checkpoint, export, SafeOpt lockstep)."""

    def test_matches_direct_formula(self):
        from safeopt_tpu.gp import Cosine

        rng = np.random.default_rng(0)
        X = rng.uniform(-3, 3, size=(7, 1))
        Z = rng.uniform(-3, 3, size=(5, 1))
        kern = Cosine(1, variance=1.8, lengthscale=0.7)
        r = np.abs(X - Z.T) / 0.7
        assert_allclose(np.asarray(kern.K(X, Z)), 1.8 * np.cos(r),
                        rtol=1e-6, atol=1e-7)
        assert_allclose(np.asarray(kern.Kdiag(X)), 1.8 * np.ones(7),
                        rtol=1e-6)

    def test_host_f64_and_native_gram(self):
        from safeopt_tpu import native
        from safeopt_tpu.gp import Cosine
        from safeopt_tpu.gp.host_math import HostFactor, np_kernel

        rng = np.random.default_rng(1)
        X = rng.uniform(-2, 2, size=(6, 1))
        kern = Cosine(1, variance=1.3, lengthscale=0.9)
        r = np.abs(X - X.T) / 0.9
        assert_allclose(np_kernel(kern, X), 1.3 * np.cos(r), rtol=1e-12)
        if native.available():
            hf = HostFactor(kern, capacity=8, input_dim=1, noise_var=0.01)
            assert hf._native_kind == "cosine"
            assert_allclose(hf._gram(X, X), 1.3 * np.cos(r), rtol=1e-12)

    def test_fused_intervals_cosine(self):
        """Cosine through the fused step's grid interval pass like the
        other stationary kernels, against the host float64 oracle."""
        from safeopt_tpu.gp import Cosine, RBF

        kern = Cosine(1, variance=1.5, lengthscale=1.1) \
            * RBF(1, lengthscale=5.0)
        rng = np.random.default_rng(2)
        X = rng.uniform(-2, 2, size=(9, 1))
        Y = rng.normal(size=(9, 1))
        gp = GPRegression(X, Y, kern, noise_var=0.01)
        grid = rng.uniform(-3, 3, size=(256, 1))
        l, u = _interval_pass(kern, gp.state, grid, 2.0)
        mu, var = gp.predict_f64(grid)
        assert_allclose(l, mu - 2.0 * np.sqrt(var), rtol=1e-9, atol=1e-10)
        assert_allclose(u, mu + 2.0 * np.sqrt(var), rtol=1e-9, atol=1e-10)

    def test_trajectory_lockstep_quasiperiodic(self):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import Cosine, GPRegression, RBF

        from reference_impl import RefCosine, RefGP, RefRBF, RefSafeOpt

        kern = Cosine(1, variance=2.0, lengthscale=1.0) \
            * RBF(1, lengthscale=4.0)
        rkern = RefCosine(1, variance=2.0, lengthscale=1.0) \
            * RefRBF(1, lengthscale=4.0)

        def f(x):
            x = np.atleast_2d(x)
            return (1.2 * np.cos(x[:, 0])
                    * np.exp(-0.5 * (x[:, 0] / 4.0) ** 2) + 0.8)

        x0 = np.array([[0.0]])
        y0 = np.array([[float(f(x0)[0])]])
        grid = linearly_spaced_combinations([(-4.0, 4.0)], 160)
        gp = GPRegression(x0, y0, kern, noise_var=1e-4)
        rgp = RefGP(x0, y0, rkern, noise_var=1e-4)
        opt = SafeOpt(gp, grid, fmin=[0.0], beta=2.0)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], beta=2.0)
        for it in range(6):
            x = np.asarray(opt.optimize())
            x_ref = np.asarray(ref.optimize())
            assert_allclose(x, x_ref, atol=1e-9,
                            err_msg=f"diverged at iteration {it}")
            y = np.array([[float(f(x)[0])]])
            opt.add_new_data_point(x, y)
            ref.add_new_data_point(x, y)

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import Cosine, GPRegression, RBF
        from safeopt_tpu.utils import checkpoint

        kern = Cosine(1, variance=1.4, lengthscale=0.8) + RBF(1)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]), kern,
                          noise_var=1e-3)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 40)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        path = str(tmp_path / "cosine.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        k1 = opt2.gps[0].kern.k1
        assert type(k1).__name__ == "Cosine"
        assert_allclose(float(np.asarray(k1.variance)), 1.4)
        np.testing.assert_array_equal(np.asarray(opt2.optimize()),
                                      np.asarray(opt.optimize()))

    def test_rejects_multidimensional_input(self):
        """cos(|x-z|) is PD only in 1-D; the constructor refuses
        higher dims (GPy constructs the invalid kernel silently —
        verified: Cosine(2)'s gram has negative eigenvalues)."""
        from safeopt_tpu.gp import Cosine

        with pytest.raises(ValueError, match="1-D"):
            Cosine(2)
        # the valid multi-dim pattern: one column via active_dims
        k = Cosine(1, active_dims=[1])
        assert k.active_dims == (1,)


class TestPoly:
    """GPy.kern.Poly mirror: k(x, z) = var * (scale x.z + bias)^order,
    through every layer."""


    def test_rejects_fractional_order(self):
        """A fractional order NaNs the gram wherever scale*x.z + bias
        < 0; rejected at construction."""
        from safeopt_tpu.gp import Poly

        with pytest.raises(ValueError, match="order"):
            Poly(1, order=2.5)
        with pytest.raises(ValueError, match="order"):
            Poly(1, order=0.0)
        assert Poly(1, order=2).order == 2.0

    def test_matches_direct_formula(self):
        from safeopt_tpu.gp import Poly

        rng = np.random.default_rng(3)
        X = rng.uniform(-2, 2, size=(6, 2))
        Z = rng.uniform(-2, 2, size=(4, 2))
        kern = Poly(2, variance=1.5, scale=0.3, bias=0.7, order=3.0)
        ref = 1.5 * (0.3 * (X @ Z.T) + 0.7) ** 3
        assert_allclose(np.asarray(kern.K(X, Z)), ref, rtol=1e-5)
        dref = 1.5 * (0.3 * np.sum(X * X, 1) + 0.7) ** 3
        assert_allclose(np.asarray(kern.Kdiag(X)), dref, rtol=1e-5)

    def test_host_f64_and_native_gram(self):
        from safeopt_tpu import native
        from safeopt_tpu.gp import Poly
        from safeopt_tpu.gp.host_math import HostFactor, np_kdiag, np_kernel

        rng = np.random.default_rng(4)
        X = rng.uniform(-2, 2, size=(6, 2))
        kern = Poly(2, variance=0.8, scale=0.25, bias=1.1, order=2.0)
        ref = 0.8 * (0.25 * (X @ X.T) + 1.1) ** 2
        assert_allclose(np_kernel(kern, X), ref, rtol=1e-12)
        assert_allclose(np_kdiag(kern, X), np.diag(ref), rtol=1e-12)
        if native.available():
            hf = HostFactor(kern, capacity=8, input_dim=2, noise_var=0.01)
            assert hf._native_kind == "poly"
            assert_allclose(hf._gram(X, X), ref, rtol=1e-12)


    def test_trajectory_lockstep_with_sum_kernel(self):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, Poly, RBF

        from reference_impl import RefGP, RefPoly, RefRBF, RefSafeOpt

        kern = RBF(1, variance=2.0) + Poly(1, variance=0.1, scale=0.05,
                                           bias=0.5, order=3.0)
        rkern = RefRBF(1, variance=2.0) + RefPoly(
            1, variance=0.1, scale=0.05, bias=0.5, order=3.0)

        def f(x):
            x = np.atleast_2d(x)
            return (1.4 * np.exp(-0.5 * (x[:, 0] + 0.4) ** 2)
                    + 0.02 * x[:, 0] ** 3 + 0.3)

        x0 = np.array([[0.0]])
        y0 = np.array([[float(f(x0)[0])]])
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 120)
        gp = GPRegression(x0, y0, kern, noise_var=1e-4)
        rgp = RefGP(x0, y0, rkern, noise_var=1e-4)
        opt = SafeOpt(gp, grid, fmin=[0.0], beta=2.0)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], beta=2.0)
        for it in range(6):
            x = np.asarray(opt.optimize())
            x_ref = np.asarray(ref.optimize())
            assert_allclose(x, x_ref, atol=1e-9,
                            err_msg=f"diverged at iteration {it}")
            y = np.array([[float(f(x)[0])]])
            opt.add_new_data_point(x, y)
            ref.add_new_data_point(x, y)

    def test_hyperopt_improves_lml_and_order_is_static(self):
        import jax

        from safeopt_tpu.gp import GPRegression, Poly
        from safeopt_tpu.gp.hyperopt import log_marginal_likelihood

        rng = np.random.default_rng(5)
        X = rng.uniform(-2, 2, size=(30, 1))
        Y = (0.05 * X[:, 0] ** 3 + 0.2 * X[:, 0])[:, None] \
            + 0.02 * rng.normal(size=(30, 1))
        gp = GPRegression(X, Y, Poly(1, variance=1.0, scale=1.0,
                                     bias=1.0, order=3.0),
                          noise_var=0.02 ** 2)
        with jax.enable_x64(True):
            lml0 = float(log_marginal_likelihood(gp.kern, X, Y, 4e-4))
        lml = gp.optimize_hyperparameters(steps=150)
        assert lml > lml0
        assert gp.kern.order == 3.0      # static structure, not fitted

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, Poly, RBF
        from safeopt_tpu.utils import checkpoint

        kern = RBF(1, variance=2.0) + Poly(1, variance=0.2, scale=0.1,
                                           bias=0.9, order=2.0)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.0]]), kern,
                          noise_var=1e-3)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 40)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        path = str(tmp_path / "poly.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        k2 = opt2.gps[0].kern.k2
        assert type(k2).__name__ == "Poly"
        assert k2.order == 2.0
        assert_allclose(float(np.asarray(k2.scale)), 0.1)
        np.testing.assert_array_equal(np.asarray(opt2.optimize()),
                                      np.asarray(opt.optimize()))


class TestMLP:
    """GPy.kern.MLP mirror: the arcsine covariance of an infinite-width
    erf network, through every layer."""

    def test_matches_direct_formula_and_ard(self):
        from safeopt_tpu.gp import MLP

        rng = np.random.default_rng(6)
        X = rng.uniform(-2, 2, size=(6, 2))
        Z = rng.uniform(-2, 2, size=(4, 2))
        w = np.array([1.5, 0.4])
        b = 0.8
        kern = MLP(2, variance=1.2, weight_variance=w.tolist(),
                   bias_variance=b, ARD=True)
        num = (X * w) @ Z.T + b
        xd = np.sqrt(np.sum(X * X * w, 1) + b + 1.0)
        zd = np.sqrt(np.sum(Z * Z * w, 1) + b + 1.0)
        ref = 1.2 * (2.0 / np.pi) * np.arcsin(
            num / xd[:, None] / zd[None, :])
        assert_allclose(np.asarray(kern.K(X, Z)), ref, rtol=1e-5,
                        atol=1e-6)
        p = np.sum(X * X * w, 1) + b
        dref = 1.2 * (2.0 / np.pi) * np.arcsin(p / (p + 1.0))
        assert_allclose(np.asarray(kern.Kdiag(X)), dref, rtol=1e-5)

    def test_self_gram_diag_equals_kdiag(self):
        """K(X)'s diagonal must equal Kdiag(X) (the arcsin argument is
        exactly p/(p+1) on the diagonal)."""
        from safeopt_tpu.gp import MLP

        rng = np.random.default_rng(7)
        X = rng.uniform(-2, 2, size=(5, 2))
        kern = MLP(2, variance=2.0, weight_variance=1.3,
                   bias_variance=0.5)
        assert_allclose(np.diag(np.asarray(kern.K(X))),
                        np.asarray(kern.Kdiag(X)), rtol=1e-5)

    def test_host_f64_and_native_gram(self):
        from safeopt_tpu import native
        from safeopt_tpu.gp import MLP
        from safeopt_tpu.gp.host_math import HostFactor, np_kdiag, np_kernel

        rng = np.random.default_rng(8)
        X = rng.uniform(-2, 2, size=(6, 2))
        kern = MLP(2, variance=1.1, weight_variance=[0.9, 1.7],
                   bias_variance=0.6, ARD=True)
        w = np.array([0.9, 1.7])
        num = (X * w) @ X.T + 0.6
        xd = np.sqrt(np.sum(X * X * w, 1) + 1.6)
        ref = 1.1 * (2.0 / np.pi) * np.arcsin(
            np.clip(num / xd[:, None] / xd[None, :], -1, 1))
        assert_allclose(np_kernel(kern, X), ref, rtol=1e-12)
        p = np.sum(X * X * w, 1) + 0.6
        assert_allclose(np_kdiag(kern, X),
                        1.1 * (2.0 / np.pi) * np.arcsin(p / (p + 1.0)),
                        rtol=1e-12)
        if native.available():
            hf = HostFactor(kern, capacity=8, input_dim=2, noise_var=0.01)
            assert hf._native_kind == "mlp"
            assert_allclose(hf._gram(X, X), ref, rtol=1e-12)


    def test_trajectory_lockstep(self):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, MLP

        from reference_impl import RefGP, RefMLP, RefSafeOpt

        kern = MLP(1, variance=2.0, weight_variance=1.0,
                   bias_variance=1.0)
        rkern = RefMLP(1, variance=2.0, weight_variance=1.0,
                       bias_variance=1.0)

        def f(x):
            x = np.atleast_2d(x)
            return 1.0 + 0.8 * np.tanh(1.5 * x[:, 0])

        x0 = np.array([[0.0]])
        y0 = np.array([[float(f(x0)[0])]])
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 120)
        gp = GPRegression(x0, y0, kern, noise_var=1e-4)
        rgp = RefGP(x0, y0, rkern, noise_var=1e-4)
        opt = SafeOpt(gp, grid, fmin=[0.0], beta=2.0)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], beta=2.0)
        for it in range(6):
            x = np.asarray(opt.optimize())
            x_ref = np.asarray(ref.optimize())
            assert_allclose(x, x_ref, atol=1e-9,
                            err_msg=f"diverged at iteration {it}")
            y = np.array([[float(f(x)[0])]])
            opt.add_new_data_point(x, y)
            ref.add_new_data_point(x, y)

    def test_hyperopt_fits_weight_variance(self):
        import jax

        from safeopt_tpu.gp import GPRegression, MLP
        from safeopt_tpu.gp.hyperopt import log_marginal_likelihood

        rng = np.random.default_rng(9)
        X = rng.uniform(-2, 2, size=(35, 1))
        Y = np.tanh(3.0 * X) + 0.02 * rng.normal(size=(35, 1))
        gp = GPRegression(X, Y, MLP(1, variance=0.3,
                                    weight_variance=0.1,
                                    bias_variance=1.0),
                          noise_var=0.02 ** 2)
        with jax.enable_x64(True):
            lml0 = float(log_marginal_likelihood(gp.kern, X, Y, 4e-4))
        lml = gp.optimize_hyperparameters(steps=200)
        assert lml > lml0

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu import SafeOpt, linearly_spaced_combinations
        from safeopt_tpu.gp import GPRegression, MLP
        from safeopt_tpu.utils import checkpoint

        kern = MLP(1, variance=1.5, weight_variance=0.7,
                   bias_variance=0.4)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.0]]), kern,
                          noise_var=1e-3)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 40)
        opt = SafeOpt(gp, grid, fmin=[0.0])
        path = str(tmp_path / "mlp.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        k = opt2.gps[0].kern
        assert type(k).__name__ == "MLP"
        assert_allclose(float(np.asarray(k.weight_variance)), 0.7)
        assert_allclose(float(np.asarray(k.bias_variance)), 0.4)
        np.testing.assert_array_equal(np.asarray(opt2.optimize()),
                                      np.asarray(opt.optimize()))
