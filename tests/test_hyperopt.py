"""Marginal-likelihood hyperparameter fitting."""

import numpy as np
from numpy.testing import assert_allclose

from safeopt_tpu.gp import GPRegression, RBF
from safeopt_tpu.gp.hyperopt import fit_hyperparameters, \
    log_marginal_likelihood

RNG = np.random.default_rng(9)


def _data(lengthscale=1.5, variance=2.0, noise=0.05, n=40):
    X = np.sort(RNG.uniform(-5, 5, size=(n, 1)), axis=0)
    K = variance * np.exp(-0.5 * ((X - X.T) / lengthscale) ** 2)
    L = np.linalg.cholesky(K + 1e-10 * np.eye(n))
    f = L @ RNG.normal(size=n)
    Y = (f + noise * RNG.normal(size=n))[:, None]
    return X, Y


def test_lml_matches_direct_formula():
    import jax.numpy as jnp

    X, Y = _data()
    kern = RBF(1, variance=2.0, lengthscale=1.5)
    lml = float(log_marginal_likelihood(kern, jnp.asarray(X),
                                        jnp.asarray(Y), 0.05 ** 2))
    # direct dense formula
    K = 2.0 * np.exp(-0.5 * ((X - X.T) / 1.5) ** 2) + 0.05 ** 2 * np.eye(
        len(X))
    sign, logdet = np.linalg.slogdet(K)
    expected = (-0.5 * Y[:, 0] @ np.linalg.solve(K, Y[:, 0])
                - 0.5 * logdet - 0.5 * len(X) * np.log(2 * np.pi))
    assert_allclose(lml, expected, rtol=1e-8)


def test_fit_improves_lml_and_recovers_scale():
    X, Y = _data(lengthscale=1.5, variance=2.0, noise=0.05)
    kern0 = RBF(1, variance=0.3, lengthscale=0.3)   # deliberately off
    import jax.numpy as jnp

    lml0 = float(log_marginal_likelihood(kern0, jnp.asarray(X),
                                         jnp.asarray(Y), 0.3))
    kern, noise, lml = fit_hyperparameters(kern0, X, Y, 0.3, steps=300,
                                           learning_rate=0.05)
    assert lml > lml0 + 5.0
    assert 0.5 < float(kern.lengthscale) < 4.0
    assert noise < 0.05  # learned noise variance shrinks toward truth


def test_gp_method_updates_model():
    X, Y = _data()
    gp = GPRegression(X, Y, RBF(1, variance=0.5, lengthscale=0.5),
                      noise_var=0.2)
    mu_before, _ = gp.predict_noiseless(X[:5])
    lml = gp.optimize_hyperparameters(steps=200)
    assert np.isfinite(lml)
    # the refit model interpolates the data better
    mu_after, _ = gp.predict_noiseless(X[:5])
    err_before = np.abs(np.asarray(mu_before) - Y[:5]).mean()
    err_after = np.abs(np.asarray(mu_after) - Y[:5]).mean()
    assert err_after <= err_before + 1e-6


def test_fit_ard_and_product():
    from safeopt_tpu.gp import Matern32

    X = RNG.uniform(-2, 2, size=(30, 2))
    Y = np.sin(X[:, :1]) + 0.1 * RNG.normal(size=(30, 1))
    kern = RBF(2, variance=1.0, lengthscale=[1.0, 1.0], ARD=True)
    k2, noise, lml = fit_hyperparameters(kern, X, Y, 0.1, steps=100)
    assert np.isfinite(lml)
    assert k2.lengthscale.shape == (2,)

    prod = (RBF(1, active_dims=[0]) * Matern32(1, active_dims=[1]))
    k3, _, lml2 = fit_hyperparameters(prod, X, Y, 0.1, steps=50)
    assert np.isfinite(lml2)


def test_fit_is_float64_under_f32_session():
    """The fit must survive an ill-conditioned gram in an f32 session
    (jax_enable_x64 off): near-duplicate inputs push kappa(K) high
    enough that an f32 Cholesky NaNs out (ADVICE.md round 1)."""
    import jax

    rng = np.random.default_rng(0)
    base = rng.uniform(-1, 1, size=(12, 1))
    X = np.vstack([base, base + 1e-9])          # near-duplicates
    Y = np.sin(2 * X) + 1e-4 * rng.normal(size=X.shape)

    with jax.enable_x64(False):
        kern, noise, lml = fit_hyperparameters(
            RBF(1, variance=1.0, lengthscale=1.0), X, Y,
            noise_var=1e-6, steps=60, noise_floor=1e-6)
    assert np.isfinite(lml)
    for leaf in jax.tree_util.tree_leaves(kern):
        assert np.all(np.isfinite(np.asarray(leaf)))
    assert np.isfinite(noise) and noise > 0


def test_nonfinite_fit_keeps_input_hyperparameters(monkeypatch, caplog):
    """A diverged optimization must not corrupt the model."""
    import logging

    import safeopt_tpu.gp.hyperopt as hyperopt_mod

    X = np.linspace(-1, 1, 8)[:, None]
    Y = np.sin(X)
    kern_in = RBF(1, variance=2.0, lengthscale=0.7)
    # absurd learning rate reliably blows the Adam trajectory up
    with caplog.at_level(logging.WARNING):
        kern, noise, lml = hyperopt_mod.fit_hyperparameters(
            kern_in, X, Y, noise_var=0.01, steps=400, learning_rate=1e6)
    if any("non-finite" in r.message for r in caplog.records):
        # fell back: inputs returned unchanged
        assert float(np.asarray(kern.variance)) == 2.0
        assert noise == 0.01
        assert np.isfinite(lml)
    else:
        # if the optimizer somehow stayed finite, results must be finite
        assert np.isfinite(lml)


def test_gpy_style_optimize_alias():
    """gp.optimize(max_iters=...) — GPy's spelling — fits and returns
    the LML; GPy-only kwargs are accepted and ignored."""
    import numpy as np

    from safeopt_tpu.gp import GPRegression, RBF
    from safeopt_tpu.gp.hyperopt import log_marginal_likelihood

    rng = np.random.default_rng(4)
    X = np.linspace(-3, 3, 30)[:, None]
    true = RBF(1, variance=2.0, lengthscale=0.5)
    from safeopt_tpu.gp.host_math import np_kernel
    K = np_kernel(true, X) + 0.01 * np.eye(30)
    Y = np.linalg.cholesky(K) @ rng.normal(size=(30, 1))

    gp = GPRegression(X, Y, RBF(1, variance=1.0, lengthscale=2.0),
                      noise_var=0.01)
    lml0 = float(log_marginal_likelihood(gp.kern, X, Y, gp.noise_var))
    lml = gp.optimize(max_iters=80, messages=False, optimizer="lbfgs")
    assert lml > lml0


def test_restarts_escape_bad_initialization():
    """Multi-start fitting (VERDICT r2 weak #7): from a deliberately
    terrible init with a step budget too small to descend, the
    perturbed restarts must find a materially better LML. Restart run
    0 is the unperturbed run, so best-of can never be worse."""
    rng = np.random.default_rng(12)
    X = np.sort(rng.uniform(-3, 3, size=(50, 1)), axis=0)
    true = RBF(1, variance=2.0, lengthscale=0.25)     # short-scale truth
    from safeopt_tpu.gp.host_math import np_kernel
    K = np_kernel(true, X) + 1e-4 * np.eye(50)
    Y = np.linalg.cholesky(K) @ rng.normal(size=(50, 1))

    bad = RBF(1, variance=1e-3, lengthscale=50.0)     # hopeless start
    # polish=False isolates the restart mechanism: the BFGS polish is
    # strong enough to rescue even this init on its own (test below)
    _, _, lml_single = fit_hyperparameters(bad, X, Y, 1.0, steps=30,
                                           polish=False)
    # deterministic per seed: this configuration lands a restart in the
    # short-lengthscale basin (lml ~ -64 vs ~ -103 for the stuck run)
    k_multi, _, lml_multi = fit_hyperparameters(
        bad, X, Y, 1.0, steps=30, restarts=12, seed=0, restart_scale=3.0,
        polish=False)
    assert lml_multi >= lml_single - 1e-9
    assert lml_multi > lml_single + 20.0
    assert float(np.asarray(k_multi.lengthscale)) < 1.0


def test_optimize_restarts_gpy_alias():
    X, Y = _data()
    gp = GPRegression(X, Y, RBF(1, variance=0.5, lengthscale=8.0),
                      noise_var=0.5)
    lml = gp.optimize_restarts(num_restarts=4, max_iters=60,
                               messages=False)
    assert np.isfinite(lml)
    assert np.all(np.isfinite(np.asarray(gp.kern.lengthscale)))


def test_restarts_preserve_ard_and_product_structure():
    from safeopt_tpu.gp import Matern32

    X = RNG.uniform(-2, 2, size=(25, 2))
    Y = np.sin(X[:, :1]) + 0.1 * RNG.normal(size=(25, 1))
    kern = RBF(2, variance=1.0, lengthscale=[1.0, 1.0], ARD=True)
    k2, _, lml = fit_hyperparameters(kern, X, Y, 0.1, steps=40,
                                     restarts=3)
    assert np.isfinite(lml)
    assert k2.lengthscale.shape == (2,)

    prod = (RBF(1, active_dims=[0]) * Matern32(1, active_dims=[1]))
    k3, _, lml2 = fit_hyperparameters(prod, X, Y, 0.1, steps=30,
                                      restarts=3)
    assert np.isfinite(lml2)
    assert type(k3).__name__ == "Product"


def test_bfgs_polish_improves_or_keeps():
    """The quasi-Newton polish (GPy's optimizer family) never returns a
    worse LML than the Adam result, and typically sharpens a stalled
    fit (few Adam steps on a stiff surface)."""
    X, Y = _data(lengthscale=1.5, variance=2.0, noise=0.05)
    kern0 = RBF(1, variance=0.3, lengthscale=0.3)
    _, _, lml_raw = fit_hyperparameters(kern0, X, Y, 0.3, steps=40,
                                        polish=False)
    k, nv, lml_pol = fit_hyperparameters(kern0, X, Y, 0.3, steps=40,
                                         polish=True)
    assert lml_pol >= lml_raw - 1e-9
    assert np.isfinite(float(np.asarray(k.lengthscale)))
    assert nv > 0


def test_lml_gradients_match_finite_differences_new_kernels():
    """jax.grad of the exact LML vs central finite differences for the
    round-3b kernel families (validates every _K_of_r2 / dot-product
    gram through the Cholesky differentiation)."""
    import jax

    from safeopt_tpu.gp import MLP, Cosine, Poly
    from safeopt_tpu.gp.hyperopt import log_marginal_likelihood

    rng = np.random.default_rng(12)
    X1 = rng.uniform(-2, 2, size=(9, 1))
    Y1 = np.sin(1.3 * X1) + 0.1
    cases = [
        (Cosine(1, variance=1.4, lengthscale=0.9), X1, Y1),
        (Poly(1, variance=0.6, scale=0.3, bias=0.8, order=3.0), X1, Y1),
        (MLP(1, variance=1.2, weight_variance=0.7, bias_variance=0.5),
         X1, Y1),
    ]
    with jax.enable_x64(True):
        for kern, X, Y in cases:
            Xd = jax.numpy.asarray(X, jax.numpy.float64)
            Yd = jax.numpy.asarray(Y, jax.numpy.float64)
            leaves, treedef = jax.tree_util.tree_flatten(kern)

            def lml(leaves_):
                k = jax.tree_util.tree_unflatten(treedef, leaves_)
                return log_marginal_likelihood(k, Xd, Yd, 1e-3)

            grads = jax.grad(lml)([jax.numpy.asarray(v, jax.numpy.float64)
                                   for v in leaves])
            eps = 1e-6
            for i in range(len(leaves)):
                base = [np.asarray(v, dtype=np.float64).copy()
                        for v in leaves]
                up = [v.copy() for v in base]
                dn = [v.copy() for v in base]
                up[i] = up[i] + eps
                dn[i] = dn[i] - eps
                fd = (float(lml([jax.numpy.asarray(v) for v in up]))
                      - float(lml([jax.numpy.asarray(v) for v in dn]))) \
                    / (2 * eps)
                assert_allclose(float(np.asarray(grads[i])), fd,
                                rtol=2e-5, atol=1e-7,
                                err_msg=f"{type(kern).__name__} leaf {i}")


def test_sparse_lml_gradient_wrt_inducing_matches_fd():
    """d(DTC LML)/dZ — the inducing-point optimization gradient —
    against central finite differences."""
    import jax

    from safeopt_tpu.gp import RBF
    from safeopt_tpu.gp.hyperopt import sparse_log_marginal_likelihood

    rng = np.random.default_rng(13)
    X = rng.uniform(-2, 2, size=(25, 1))
    Y = np.sin(X) + 0.05 * rng.normal(size=(25, 1))
    Z = np.linspace(-1.8, 1.8, 5)[:, None]
    kern = RBF(1, variance=1.5, lengthscale=0.8)

    with jax.enable_x64(True):
        def lml(Zv):
            return sparse_log_marginal_likelihood(
                kern, X, Y, Zv, 0.01)

        g = np.asarray(jax.grad(lml)(jax.numpy.asarray(Z)))
        eps = 1e-6
        for i in (0, 2, 4):
            up = Z.copy(); up[i, 0] += eps
            dn = Z.copy(); dn[i, 0] -= eps
            fd = (float(lml(jax.numpy.asarray(up)))
                  - float(lml(jax.numpy.asarray(dn)))) / (2 * eps)
            assert_allclose(g[i, 0], fd, rtol=2e-5, atol=1e-7,
                            err_msg=f"inducing row {i}")


def test_accel_restarts_refused():
    """device='accel' with restarts>0 (the vmapped restart batch) has
    not been run on the GPU yet; the API refuses it."""
    import numpy as np
    import pytest

    from safeopt_tpu.gp import RBF
    from safeopt_tpu.gp.hyperopt import fit_hyperparameters

    X = np.random.default_rng(0).uniform(-1, 1, size=(20, 1))
    Y = X ** 2
    with pytest.raises(ValueError, match="accel"):
        fit_hyperparameters(RBF(1), X, Y, 0.01, steps=5, restarts=2,
                            device="accel")
    with pytest.raises(ValueError, match="device"):
        fit_hyperparameters(RBF(1), X, Y, 0.01, steps=5, device="gpu")
