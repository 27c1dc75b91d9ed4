"""Sparse (DTC) GP: math, device-state masquerade, SafeOpt integration."""

import numpy as np
import pytest
from numpy.testing import assert_allclose

from safeopt_tpu import SafeOpt, linearly_spaced_combinations
from safeopt_tpu.gp import GPRegression, RBF
from safeopt_tpu.gp.sparse import SparseGPRegression
from safeopt_tpu.gp.regression import gp_predict

from reference_impl import RefRBF

def _data(n=60, seed=13):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, size=(n, 1))
    y = np.sin(X[:, 0]) + 0.05 * rng.normal(size=n)
    return X, y[:, None]


def test_dtc_matches_dense_formula():
    """Posterior equals the direct dense DTC computation."""
    X, Y = _data(40)
    kern = RBF(1, variance=2.0, lengthscale=1.0)
    s2 = 0.01
    gp = SparseGPRegression(X, Y, kern, noise_var=s2, inducing=10)
    Z = gp.Z
    Xq = np.linspace(-4, 4, 15)[:, None]

    # dense reference
    rk = RefRBF(1, variance=2.0, lengthscale=1.0)
    Kzz = rk.K(Z) + 1e-8 * np.eye(len(Z))
    Kzx = rk.K(Z, X)
    Kzq = rk.K(Z, Xq)
    A = Kzz + Kzx @ Kzx.T / s2
    alpha = np.linalg.solve(A, Kzx @ Y[:, 0]) / s2
    mu_ref = Kzq.T @ alpha
    B = np.linalg.inv(Kzz) - np.linalg.inv(A)
    var_ref = rk.Kdiag(Xq) - np.einsum("mq,mk,kq->q", Kzq, B, Kzq)

    mu, var = gp.predict_noiseless(Xq)
    assert_allclose(mu[:, 0], mu_ref, rtol=1e-7, atol=1e-9)
    assert_allclose(var[:, 0], np.maximum(var_ref, 0), rtol=1e-6,
                    atol=1e-8)


def test_device_state_matches_host_posterior():
    """The GPState masquerade reproduces the host DTC posterior through
    the same jitted gp_predict the fused step uses."""
    X, Y = _data(50)
    kern = RBF(1, variance=2.0)
    gp = SparseGPRegression(X, Y, kern, noise_var=0.01, inducing=12)
    Xq = np.linspace(-4, 4, 23)[:, None]
    mu_h, var_h = gp.predict_noiseless(Xq)
    mu_d, var_d = gp_predict(kern, gp.state, Xq)
    assert_allclose(np.asarray(mu_d), mu_h[:, 0], rtol=1e-8, atol=1e-10)
    assert_allclose(np.asarray(var_d), var_h[:, 0], rtol=1e-7, atol=1e-9)


def test_inducing_equals_data_recovers_exact_gp():
    """With Z = X the DTC posterior is the exact GP posterior."""
    X, Y = _data(20)
    kern = RBF(1, variance=2.0)
    sparse = SparseGPRegression(X, Y, kern, noise_var=0.01, inducing=X)
    exact = GPRegression(X, Y, kern, noise_var=0.01)
    Xq = np.linspace(-4, 4, 17)[:, None]
    mu_s, var_s = sparse.predict_noiseless(Xq)
    mu_e, var_e = exact.predict_noiseless(Xq)
    assert_allclose(mu_s, np.asarray(mu_e), rtol=1e-5, atol=1e-7)
    assert_allclose(var_s, np.asarray(var_e), rtol=1e-4, atol=1e-6)


def test_safeopt_runs_on_sparse_gp():
    """SafeOpt consumes a sparse GP through the same fused pipeline."""
    rk = RefRBF(1, variance=2.0)

    def f(x):
        return rk.K(np.atleast_2d(x), [[0.0], [2.0]]) @ np.array([2.0, 1.0])

    X0 = np.array([[0.0], [0.3], [-0.3]])
    Y0 = f(X0)[:, None]
    gp = SparseGPRegression(X0, Y0, RBF(1, variance=2.0), noise_var=1e-3,
                            inducing=8)
    grid = linearly_spaced_combinations([(-5.0, 5.0)], 120)
    opt = SafeOpt(gp, grid, fmin=[0.0], threshold=0.1)
    for _ in range(5):
        x = opt.optimize()
        assert -5.0 <= float(x[0]) <= 5.0
        opt.add_new_data_point(x, float(f(x[None, :])[0]))
    assert gp.num_data == 8          # data grew
    assert gp.num_inducing == 8      # factor size bounded
    x_best, lb = opt.get_maximum()
    assert np.isfinite(lb)


def test_safeoptswarm_runs_on_sparse_gp():
    """SafeOptSwarm (fused path) on a sparse model: greedy specials
    must come from the observation store, not the inducing points."""
    import jax

    from safeopt_tpu import SafeOptSwarm

    rng = np.random.default_rng(3)
    X0 = rng.uniform(-0.5, 0.5, size=(6, 2))
    Y0 = (2.0 * np.exp(-0.5 * np.sum(X0 ** 2, axis=1)))[:, None]
    gp = SparseGPRegression(X0, Y0, RBF(2, variance=2.0), noise_var=1e-3,
                            inducing=5)
    opt = SafeOptSwarm(gp, fmin=[0.0], bounds=[(-2.0, 2.0)] * 2,
                       swarm_size=10, key=jax.random.key(1))
    for _ in range(3):
        x = opt.optimize()
        assert np.all(np.abs(x) <= 2.0)
        y = float(2.0 * np.exp(-0.5 * np.sum(x ** 2)))
        opt.add_new_data_point(x, y)
    assert gp.num_data == 9
    assert gp.num_inducing == 5


def test_incremental_append_matches_full_rebuild():
    """Rank-1 information updates reproduce the from-scratch build
    (VERDICT r2 weak #6: append must not be O(m^2 n))."""
    X, Y = _data(40)
    kern = RBF(1, variance=2.0, lengthscale=1.0)
    inc = SparseGPRegression(X, Y, kern, noise_var=0.01, inducing=10)
    rng = np.random.default_rng(5)
    for _ in range(12):
        x = rng.uniform(-4, 4, size=(1,))
        y = float(np.sin(x[0]) + 0.05 * rng.normal())
        inc.append_data(x, y)
    full = SparseGPRegression(inc.X, inc.Y, kern, noise_var=0.01,
                              inducing=inc.Z)
    Xq = np.linspace(-4, 4, 21)[:, None]
    mu_i, var_i = inc.predict_noiseless(Xq)
    mu_f, var_f = full.predict_noiseless(Xq)
    assert_allclose(mu_i, mu_f, rtol=1e-9, atol=1e-11)
    assert_allclose(var_i, var_f, rtol=1e-8, atol=1e-10)


def test_incremental_pop_matches_full_rebuild():
    X, Y = _data(30)
    kern = RBF(1, variance=2.0)
    gp = SparseGPRegression(X, Y, kern, noise_var=0.01, inducing=8)
    Xq = np.linspace(-4, 4, 11)[:, None]
    mu0, var0 = gp.predict_noiseless(Xq)
    gp.append_data(np.array([1.2]), 0.9)
    gp.append_data(np.array([-2.1]), -0.8)
    gp.pop_data()
    gp.pop_data()
    mu1, var1 = gp.predict_noiseless(Xq)
    assert_allclose(mu1, mu0, rtol=1e-9, atol=1e-11)
    assert_allclose(var1, var0, rtol=1e-8, atol=1e-10)
    assert gp.num_data == 30


def test_set_XY_incremental_paths():
    """Pure append and pure truncate ride the rank-1 path; replacement
    rebuilds — all three must agree with a from-scratch model."""
    X, Y = _data(25)
    kern = RBF(1, variance=2.0)
    gp = SparseGPRegression(X, Y, kern, noise_var=0.01, inducing=8)
    Z = gp.Z
    rng = np.random.default_rng(11)
    X2 = np.vstack([X, rng.uniform(-4, 4, size=(5, 1))])
    Y2 = np.vstack([Y, rng.normal(size=(5, 1))])
    gp.set_XY(X2, Y2)                       # pure append
    assert gp.num_data == 30
    gp.set_XY(X2[:27], Y2[:27])             # pure truncate
    assert gp.num_data == 27
    ref = SparseGPRegression(X2[:27], Y2[:27], kern, noise_var=0.01,
                             inducing=Z)
    Xq = np.linspace(-4, 4, 13)[:, None]
    assert_allclose(gp.predict_noiseless(Xq)[0],
                    ref.predict_noiseless(Xq)[0], rtol=1e-9, atol=1e-11)
    # replacement (different data) -> full rebuild still correct
    Xr, Yr = _data(18, seed=21)
    gp.set_XY(Xr, Yr)
    ref2 = SparseGPRegression(Xr, Yr, kern, noise_var=0.01, inducing=Z)
    assert_allclose(gp.predict_noiseless(Xq)[0],
                    ref2.predict_noiseless(Xq)[0], rtol=1e-9, atol=1e-11)


def test_refit_every_triggers_full_rebuild():
    X, Y = _data(10)
    gp = SparseGPRegression(X, Y, RBF(1, variance=2.0), noise_var=0.01,
                            inducing=6, refit_every=3)
    rng = np.random.default_rng(2)
    for i in range(7):
        gp.append_data(rng.uniform(-4, 4, size=(1,)), float(rng.normal()))
    # pending counter never reaches refit_every without wrapping
    assert gp._pending < 3


def test_sparse_hyperopt_improves_dtc_lml():
    from safeopt_tpu.gp.hyperopt import sparse_log_marginal_likelihood

    import jax

    X, Y = _data(80, seed=3)
    kern0 = RBF(1, variance=0.2, lengthscale=0.2)     # deliberately off
    gp = SparseGPRegression(X, Y, kern0, noise_var=0.3, inducing=12)
    with jax.enable_x64(True):
        lml0 = float(sparse_log_marginal_likelihood(
            kern0, X, Y, gp.Z, 0.3))
    lml = gp.optimize_hyperparameters(steps=250)
    assert lml > lml0 + 5.0
    assert 0.3 < float(np.asarray(gp.kern.lengthscale)) < 5.0
    # the refit state is consistent with the new hyperparameters
    full = SparseGPRegression(gp.X, gp.Y, gp.kern, noise_var=gp.noise_var,
                              inducing=gp.Z)
    Xq = np.linspace(-4, 4, 9)[:, None]
    assert_allclose(gp.predict_noiseless(Xq)[0],
                    full.predict_noiseless(Xq)[0], rtol=1e-8, atol=1e-10)


def test_sparse_lml_matches_dense_lml_when_z_equals_x():
    """DTC LML with Z = X equals the exact GP LML."""
    import jax

    from safeopt_tpu.gp.hyperopt import (log_marginal_likelihood,
                                         sparse_log_marginal_likelihood)

    X, Y = _data(15, seed=8)
    kern = RBF(1, variance=2.0, lengthscale=1.3)
    with jax.enable_x64(True):
        dense = float(log_marginal_likelihood(kern, X, Y, 0.05))
        sparse = float(sparse_log_marginal_likelihood(kern, X, Y, X, 0.05))
    assert_allclose(sparse, dense, rtol=1e-5)


def test_pseudo_factor_is_lower_triangular():
    """The GPState contract: the pseudo-factor must be
    LOWER-TRIANGULAR like the exact model's inverse Cholesky factor (a
    blocked multiply that skips strictly-upper tiles would silently
    lose half of a dense root). R^T R must still equal B (any such
    factor preserves the posterior)."""
    X, Y = _data(80, seed=5)
    kern = RBF(1, variance=2.0, lengthscale=1.0)
    gp = SparseGPRegression(X, Y, kern, noise_var=0.01, inducing=20)
    m = gp.num_inducing
    R = gp._R
    assert_allclose(R, np.tril(R), atol=1e-12)
    linv = np.asarray(gp.state.Linv)
    assert_allclose(linv, np.tril(linv), atol=1e-10)

    # R^T R == B, rebuilt exactly as _recompute_posterior does (a
    # fully dense independent inversion differs at ~1e-4 relative on
    # this conditioning, which would mask a real factor bug)
    import scipy.linalg

    sigma = scipy.linalg.cho_solve(
        scipy.linalg.cho_factor(gp._A, lower=True), np.eye(m))
    kzz_inv = scipy.linalg.cho_solve(gp._Kzz_cho, np.eye(m))
    B = 0.5 * ((kzz_inv - sigma) + (kzz_inv - sigma).T)
    evals, evecs = np.linalg.eigh(B)
    B = (evecs * np.maximum(evals, 0.0)) @ evecs.T
    assert_allclose(R.T @ R, B, rtol=1e-8,
                    atol=1e-10 * np.abs(B).max())


def test_optimize_inducing_moves_z_to_informative_locations():
    """Joint Z optimization (GPy sparse optimize() semantics): with an
    under-resourced inducing budget (m=4 for 1.3 periods of a sine),
    moving Z along the DTC-LML gradient must clearly beat the same fit
    with Z frozen, and the optimized locations must land on the
    informative structure (the sine extrema at +-pi/2).

    Gradient-flow caveat (measured): an inducing point several
    lengthscales from the data it should explain gets exponentially
    small LML gradients — a pathological corner init does NOT escape
    by gradient alone (GPy's Z optimization has the same physics).
    This test exercises the regime the feature is for: refining a
    reasonable init.
    """
    import jax

    from safeopt_tpu.gp.hyperopt import sparse_log_marginal_likelihood

    X, Y = _data(80, seed=5)
    # evenly spread but offset from the sine extrema, and too few
    Z0 = (np.linspace(-3.5, 3.5, 4) + 0.4)[:, None]
    kern = RBF(1, variance=1.5, lengthscale=1.0)

    frozen = SparseGPRegression(X, Y, kern.copy(), noise_var=0.05,
                                inducing=Z0.copy())
    lml_frozen = frozen.optimize_hyperparameters(steps=300)

    moved = SparseGPRegression(X, Y, kern.copy(), noise_var=0.05,
                               inducing=Z0.copy())
    lml_moved = moved.optimize_hyperparameters(steps=300,
                                               optimize_inducing=True)

    assert lml_moved > lml_frozen + 20.0        # measured gain ~61 nats
    # two of the four points migrate onto the interior extrema +-pi/2
    z = np.sort(moved.Z[:, 0])
    assert np.min(np.abs(z - (-np.pi / 2))) < 0.3
    assert np.min(np.abs(z - (np.pi / 2))) < 0.3
    # and the refit state reflects the new Z
    with jax.enable_x64(True):
        lml_check = float(sparse_log_marginal_likelihood(
            moved.kern, X, Y, moved.Z, moved.noise_var))
    assert_allclose(lml_check, lml_moved, rtol=1e-6)

    # posterior mean tracks the exact GP better than the frozen fit
    Xq = np.linspace(-3.5, 3.5, 15)[:, None]
    ref = GPRegression(X, Y, moved.kern.copy(),
                       noise_var=moved.noise_var)
    mu_exact = ref.predict_noiseless(Xq)[0]
    err_moved = float(np.mean(np.abs(
        moved.predict_noiseless(Xq)[0] - mu_exact)))
    err_frozen = float(np.mean(np.abs(
        frozen.predict_noiseless(Xq)[0] - mu_exact)))
    assert err_moved < err_frozen


def test_optimize_inducing_restarts_perturb_only_hypers():
    """Restart fan-out with inducing optimization: every run shares the
    initial Z (locations are not log-space hyperparameters), and the
    best finite LML still wins."""
    X, Y = _data(50, seed=6)
    gp = SparseGPRegression(X, Y, RBF(1, variance=0.3, lengthscale=0.3),
                            noise_var=0.2, inducing=10)
    lml = gp.optimize_hyperparameters(steps=150, restarts=2, seed=1,
                                      optimize_inducing=True)
    assert np.isfinite(lml)
    assert gp.Z.shape == (10, 1)
    # state stays consistent after the joint fit + refit
    Xq = np.linspace(-3, 3, 7)[:, None]
    mu, var = gp.predict_noiseless(Xq)
    assert np.all(np.isfinite(mu)) and np.all(np.asarray(var) >= 0)


# ---------------------------------------------------------------------------
# conservative variance floor (round 4: bounded optimistic drift)
# ---------------------------------------------------------------------------


class TestConservativeFloor:
    """`conservative=c` adds a calibrated constant latent-variance
    floor (White summand on the effective kernel): the mean is
    untouched, lower confidence bounds can only drop, and knife-edge
    OPTIMISTIC drift vs the exact GP (the dangerous direction for safe
    BO) is suppressed. Guards /root/reference/safeopt/gp_opt.py:478-481
    (compute_safe_set is the entire point of the framework)."""

    def _models(self, n=220, m=24, c=1.0, seed=3):
        rng = np.random.default_rng(seed)
        X = rng.uniform(-4, 4, size=(n, 2))
        Y = (2.0 * np.exp(-0.5 * np.sum(X ** 2, axis=1))
             + 0.05 * rng.normal(size=n))[:, None]
        kern = RBF(2, variance=2.0, lengthscale=1.0)
        plain = SparseGPRegression(X, Y, kern, noise_var=0.05 ** 2,
                                   inducing=m)
        cons = SparseGPRegression(X, Y, kern, noise_var=0.05 ** 2,
                                  inducing=m, conservative=c)
        return X, Y, kern, plain, cons

    def test_mean_unchanged_var_floored(self):
        X, Y, kern, plain, cons = self._models()
        rng = np.random.default_rng(0)
        Xq = rng.uniform(-5, 5, size=(50, 2))
        mu0, v0 = plain.predict_f64(Xq)
        mu1, v1 = cons.predict_f64(Xq)
        assert cons._floor > 0.0
        assert_allclose(mu1, mu0, atol=0)
        assert_allclose(v1, v0 + cons._floor, rtol=1e-12)

    def test_device_state_matches_host_oracle(self):
        """The f64 host oracle and the device state agree under the
        floored kernel (f64 session) — certification stays coherent."""
        import jax.numpy as jnp

        from safeopt_tpu.algorithms.safe_opt_core import _posterior_with_V

        _, _, _, _, cons = self._models()
        rng = np.random.default_rng(1)
        Xq = rng.uniform(-5, 5, size=(30, 2))
        mu_h, v_h = cons.predict_f64(Xq)
        mu_d, v_d, _ = _posterior_with_V(cons.kern, cons.state,
                                         jnp.asarray(Xq))
        assert_allclose(np.asarray(mu_d), mu_h, atol=1e-12)
        assert_allclose(np.asarray(v_d), v_h, atol=1e-12)

    def test_suppresses_optimistic_drift(self):
        """vs the exact GP on a dense grid: c=1 zeroes the optimistic
        flips the plain DTC makes on this config."""
        import scipy.linalg

        from safeopt_tpu.gp.host_math import np_kdiag, np_kernel

        X, Y, kern, plain, cons = self._models(n=800, m=64, seed=11)
        grid = np.asarray(linearly_spaced_combinations(
            [(-5.0, 5.0), (-5.0, 5.0)], 120))
        beta, fmin, noise = 2.0, 0.2, 0.05 ** 2
        K = np_kernel(kern, X) + noise * np.eye(len(X))
        cho = scipy.linalg.cho_factor(K, lower=True)
        kv = np_kernel(kern, X, grid)
        mu_e = kv.T @ scipy.linalg.cho_solve(cho, Y[:, 0])
        v = scipy.linalg.solve_triangular(cho[0], kv, lower=True)
        var_e = np.maximum(np_kdiag(kern, grid) - np.sum(v * v, axis=0),
                           0.0)
        S_e = (mu_e - beta * np.sqrt(var_e)) > fmin

        mu0, v0 = plain.predict_f64(grid)
        mu1, v1 = cons.predict_f64(grid)
        S0 = (mu0 - beta * np.sqrt(v0)) > fmin
        S1 = (mu1 - beta * np.sqrt(v1)) > fmin
        opt0 = int(np.count_nonzero(S0 & ~S_e))
        opt1 = int(np.count_nonzero(S1 & ~S_e))
        assert opt0 > 0, "config must exhibit plain-DTC optimistic drift"
        assert opt1 == 0, f"floor left {opt1} optimistic flips"
        # lower bounds only drop
        assert np.all(mu1 - beta * np.sqrt(v1)
                      <= mu0 - beta * np.sqrt(v0) + 1e-12)

    def test_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu.utils import checkpoint

        _, _, _, _, cons = self._models()
        grid = linearly_spaced_combinations([(-2.0, 2.0), (-2.0, 2.0)],
                                            15)
        opt = SafeOpt(cons, grid, fmin=[0.2], exact_boundaries=True)
        path = str(tmp_path / "cons.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        g = opt2.gps[0]
        assert g.conservative == cons.conservative
        assert_allclose(g._floor, cons._floor, rtol=1e-12)
        rng = np.random.default_rng(2)
        Xq = rng.uniform(-4, 4, size=(20, 2))
        assert_allclose(g.predict_f64(Xq)[1], cons.predict_f64(Xq)[1],
                        atol=0)

    def test_safeopt_runs_certified_on_conservative_model(self):
        _, _, _, _, cons = self._models()
        grid = linearly_spaced_combinations([(-3.0, 3.0), (-3.0, 3.0)],
                                            25)
        opt = SafeOpt(cons, grid, fmin=[0.2], exact_boundaries=True)
        x = opt.optimize()
        assert np.isfinite(np.asarray(x)).all()
        assert opt.S.any()

    def test_hyperopt_fits_base_kernel(self):
        """LML targets the data-model kernel; the floored view is
        rebuilt (and recalibrated) after the fit."""
        X, Y, kern, _, cons = self._models(n=150, m=16)
        lml = cons.optimize_hyperparameters(steps=40)
        assert np.isfinite(lml)
        from safeopt_tpu.gp.kernels import Sum, White
        assert isinstance(cons.kern, Sum)
        assert any(isinstance(p, White) for p in cons.kern.parts)
        assert not isinstance(cons.kern_base, Sum)

    def test_quantile_calibration_trims_outlier_floor(self):
        """The p99 statistic floors to the bulk of the mean-convergence
        error, not its single worst outlier: floor(p99) <= floor(max),
        with the mean still untouched and the variance still floored by
        exactly the (smaller) calibrated constant. VERDICT r4 #5: the
        max statistic forfeited 47% of the exact safe set on the bench
        configuration."""
        X, Y, kern, _, cons_max = self._models()
        cons_p99 = SparseGPRegression(X, Y, kern, noise_var=0.05 ** 2,
                                      inducing=24, conservative=1.0,
                                      calibration=0.99)
        assert 0.0 < cons_p99._floor <= cons_max._floor
        rng = np.random.default_rng(0)
        Xq = rng.uniform(-5, 5, size=(30, 2))
        mu0, v0 = cons_max.predict_f64(Xq)
        mu1, v1 = cons_p99.predict_f64(Xq)
        assert_allclose(mu1, mu0, atol=0)
        assert_allclose(v1, v0 - cons_max._floor + cons_p99._floor,
                        rtol=1e-10)

    def test_calibration_validation(self):
        X, Y, kern, _, _ = self._models(n=60, m=8)
        with pytest.raises(ValueError, match="calibration"):
            SparseGPRegression(X, Y, kern, inducing=8,
                               conservative=1.0, calibration=1.5)
        with pytest.raises(ValueError, match="calibration"):
            SparseGPRegression(X, Y, kern, inducing=8,
                               conservative=1.0, calibration=0.0)

    def test_calibration_checkpoint_roundtrip(self, tmp_path):
        from safeopt_tpu.utils.checkpoint import load, save
        X, Y, kern, _, _ = self._models(n=120, m=12)
        cons = SparseGPRegression(X, Y, kern, noise_var=0.05 ** 2,
                                  inducing=12, conservative=0.5,
                                  calibration=0.99)
        grid = linearly_spaced_combinations([(-3.0, 3.0), (-3.0, 3.0)],
                                            15)
        opt = SafeOpt(cons, grid, fmin=[0.2], exact_boundaries=True)
        path = tmp_path / "ck.npz"
        save(opt, path)
        opt2 = load(path)
        g2 = opt2.gps[0]
        assert g2.calibration == 0.99
        assert g2.conservative == 0.5
        assert_allclose(g2._floor, cons._floor, rtol=1e-12)
