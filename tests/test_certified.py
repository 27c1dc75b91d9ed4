"""Boundary-certified safe-set decisions (SafeOpt exact_boundaries).

Accelerator f32 interval bounds carry ~1e-4 noise; a candidate whose
true margin to ``fmin`` is inside that band can be classified either
way (docs/design.md "f32 decision ambiguity band"). ``exact_boundaries``
recomputes those candidates in host float64 and overrides their safe
bits — these tests pin the machinery with engineered knife-edge points
whose truth is computed independently with scipy.
"""

import jax
import numpy as np
import pytest
import scipy.linalg
from numpy.testing import assert_allclose
from scipy.spatial.distance import cdist

from safeopt_tpu import SafeOpt, linearly_spaced_combinations
from safeopt_tpu.gp import GPRegression, RBF, SparseGPRegression

from reference_impl import RefGP, RefRBF, RefSafeOpt


def _f64_lower_bound(X, Y, noise_var, variance, ls, beta, xq):
    """Independent scipy float64 posterior lower bound at ``xq``."""
    K = variance * np.exp(-0.5 * cdist(X / ls, X / ls, "sqeuclidean"))
    cho = scipy.linalg.cho_factor(K + noise_var * np.eye(len(X)),
                                  lower=True)
    kv = variance * np.exp(-0.5 * cdist(X / ls, np.atleast_2d(xq) / ls,
                                        "sqeuclidean"))
    mu = kv.T @ scipy.linalg.cho_solve(cho, Y[:, 0])
    v = scipy.linalg.solve_triangular(cho[0], kv, lower=True)
    var = np.maximum(variance - np.sum(v * v, axis=0), 0.0)
    return float(mu[0] - beta * np.sqrt(var[0]))


class TestKnifeEdgeCertification:
    """Engineered margin of ±1e-9 around fmin: far below any f32 noise
    floor, so only the f64-certified path can decide it correctly."""

    def _setup(self, fmin_offset):
        rng = np.random.default_rng(2)
        X = rng.uniform(-1.5, 1.5, size=(10, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        grid = linearly_spaced_combinations([(-3.0, 3.0)], 200)
        j = 150                      # probe point away from the data
        beta = 2.0
        l64 = _f64_lower_bound(X, Y, 1e-4, 2.0, 1.0, beta, grid[j])
        fmin = l64 + fmin_offset
        gp = GPRegression(X, Y, RBF(1, variance=2.0, lengthscale=1.0),
                          noise_var=1e-4)
        opt = SafeOpt(gp, grid, fmin=[fmin], beta=beta,
                      exact_boundaries=True, boundary_band=1e-3)
        return opt, j

    @pytest.mark.parametrize("offset,expect_safe", [(-1e-9, True),
                                                    (1e-9, False)])
    def test_f32_session_decides_by_f64_truth(self, offset, expect_safe):
        with jax.enable_x64(False):
            opt, j = self._setup(offset)
            opt.optimize()
            assert bool(opt.S[j]) is expect_safe

    @pytest.mark.parametrize("offset,expect_safe", [(-1e-9, True),
                                                    (1e-9, False)])
    def test_f64_session_agrees(self, offset, expect_safe):
        opt, j = self._setup(offset)
        opt.optimize()
        assert bool(opt.S[j]) is expect_safe


class TestCertifiedMatchesPlainInF64:
    def test_trajectory_identical(self):
        kern = RBF(1, variance=2.0)
        rkern = RefRBF(1, variance=2.0)

        def f(x):
            x = np.atleast_2d(x)
            return (rkern.K(x, np.array([[0.0], [2.0]]))
                    @ np.array([2.0, 1.0]))

        x0 = np.array([[0.0]])
        grid = linearly_spaced_combinations([(-4.0, 4.0)], 150)
        gp1 = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-4)
        gp2 = GPRegression(x0, f(x0)[:, None], kern.copy(), noise_var=1e-4)
        rgp = RefGP(x0, f(x0)[:, None], rkern, noise_var=1e-4)
        plain = SafeOpt(gp1, grid, fmin=[0.0], threshold=0.1)
        cert = SafeOpt(gp2, grid, fmin=[0.0], threshold=0.1,
                       exact_boundaries=True)
        ref = RefSafeOpt(rgp, grid, fmin=[0.0], threshold=0.1)

        for _ in range(6):
            xp = np.asarray(plain.optimize())
            xc = np.asarray(cert.optimize())
            xr = np.asarray(ref.optimize())
            assert_allclose(xp, xr, atol=1e-9)
            assert_allclose(xc, xr, atol=1e-9)
            np.testing.assert_array_equal(cert.S, plain.S)
            np.testing.assert_array_equal(cert.M, plain.M)
            np.testing.assert_array_equal(cert.G, plain.G)
            y = np.array([[float(f(xp)[0])]])
            plain.add_new_data_point(xp, y)
            cert.add_new_data_point(xc, y)
            ref.add_new_data_point(xr, y)


class TestOptimisticStepping:
    """The certified path pays its second dispatch ONLY when the f64
    oracle actually overturns an f32 verdict (VERDICT r2 weak #3)."""

    def _mk(self, fmin, band=1e-3, **kw):
        rng = np.random.default_rng(7)
        X = rng.uniform(-1.5, 1.5, size=(8, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        grid = linearly_spaced_combinations([(-3.0, 3.0)], 150)
        gp = GPRegression(X, Y, RBF(1, variance=2.0, lengthscale=1.0),
                          noise_var=1e-4)
        return SafeOpt(gp, grid, fmin=[fmin], beta=2.0,
                       exact_boundaries=True, boundary_band=band, **kw)

    def test_empty_band_skips_oracle_and_pass2(self, monkeypatch):
        import safeopt_tpu.algorithms.safe_opt as so

        calls = []
        orig = so.safeopt_step_from_Q
        monkeypatch.setattr(so, "safeopt_step_from_Q",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        opt = self._mk(fmin=-50.0)       # nothing remotely near the band
        opt.optimize()
        assert opt._band_population == 0
        assert opt._certified_corrections == 0
        assert calls == []               # pass 1 stood; no correction pass

    def test_confirmed_band_skips_pass2(self, monkeypatch):
        """In-band candidates whose f32 verdicts the f64 oracle CONFIRMS
        also stay single-dispatch (x64 session: device == host math)."""
        import safeopt_tpu.algorithms.safe_opt as so

        calls = []
        orig = so.safeopt_step_from_Q
        monkeypatch.setattr(so, "safeopt_step_from_Q",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        opt = self._mk(fmin=0.9, band=0.5)    # wide band, many candidates
        opt.optimize()
        assert opt._band_population > 0
        assert opt._certified_corrections == 0
        assert calls == []

    def test_flip_triggers_correction_pass(self, monkeypatch):
        """A wrong f32 verdict inside the band dispatches pass 2 (the
        knife-edge scenario of TestKnifeEdgeCertification, instrumented)."""
        import safeopt_tpu.algorithms.safe_opt as so

        with jax.enable_x64(False):
            rng = np.random.default_rng(2)
            X = rng.uniform(-1.5, 1.5, size=(10, 1))
            Y = 1.0 + np.exp(-0.5 * X ** 2)
            grid = linearly_spaced_combinations([(-3.0, 3.0)], 200)
            j = 150
            l64 = _f64_lower_bound(X, Y, 1e-4, 2.0, 1.0, 2.0, grid[j])
            gp = GPRegression(X, Y, RBF(1, variance=2.0, lengthscale=1.0),
                              noise_var=1e-4)
            # fmin a hair above the f64 truth: the f32 l at j may say
            # safe; the oracle must say unsafe. Either way the band is
            # populated and the decision must equal the f64 truth.
            opt = SafeOpt(gp, grid, fmin=[l64 + 1e-9], beta=2.0,
                          exact_boundaries=True, boundary_band=1e-3)
            opt.optimize()
            assert opt._band_population > 0
            assert bool(opt.S[j]) is False
            # corrections are data-dependent (f32 may land right by
            # luck); when one happened the counter must say so
            if opt._certified_corrections:
                assert opt._certified_corrections >= 1


class TestReducedPrecisionIntervals:
    def test_requires_exact_boundaries(self):
        # an EXPLICIT exact_boundaries=False with reduced precision is
        # the unsound combination and still raises; leaving it unset
        # now implies certification (TestAutoCertifiedPolicy)
        gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                          RBF(1, variance=2.0), noise_var=1e-4)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 50)
        with pytest.raises(ValueError, match="exact_boundaries"):
            SafeOpt(gp, grid, fmin=[0.0], interval_precision="default",
                    exact_boundaries=False)

    def test_same_trajectory_as_plain(self):
        """Reduced-precision certified mode preserves the reference
        trajectory (on CPU precision is a no-op, so this pins the
        refine/scatter plumbing: _refine_Q must be IDENTITY-safe —
        recomputed rows exactly replace equal values)."""
        kern = RBF(1, variance=2.0)

        def f(x):
            x = np.atleast_2d(x)
            k = 2.0 * np.exp(-0.5 * (x - np.array([[0.0], [2.0]]).T) ** 2)
            return k @ np.array([2.0, 1.0])

        x0 = np.array([[0.0]])
        grid = linearly_spaced_combinations([(-4.0, 4.0)], 150)
        gp1 = GPRegression(x0, f(x0)[:, None], kern, noise_var=1e-4)
        gp2 = GPRegression(x0, f(x0)[:, None], kern.copy(), noise_var=1e-4)
        plain = SafeOpt(gp1, grid, fmin=[0.0], threshold=0.1)
        fast = SafeOpt(gp2, grid, fmin=[0.0], threshold=0.1,
                       exact_boundaries=True, boundary_band=1e-2,
                       interval_precision="default", refine_k=64,
                       refine_band=2e-2)
        for _ in range(5):
            xp = np.asarray(plain.optimize())
            xf = np.asarray(fast.optimize())
            assert_allclose(xf, xp, atol=1e-12)
            np.testing.assert_array_equal(fast.S, plain.S)
            y = np.array([[float(f(xp)[0])]])
            plain.add_new_data_point(xp, y)
            fast.add_new_data_point(xf, y)

    def test_checkpoint_roundtrip_keeps_precision_flags(self, tmp_path):
        from safeopt_tpu.utils import checkpoint

        gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                          RBF(1, variance=2.0), noise_var=1e-4)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 50)
        opt = SafeOpt(gp, grid, fmin=[0.0], exact_boundaries=True,
                      interval_precision="high", refine_k=32)
        path = str(tmp_path / "rp.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        assert opt2._interval_precision == "high"
        assert opt2._refine_k == 32


class TestBudgetAndValidation:
    def test_band_overflow_warns_and_runs(self, caplog):
        import logging

        gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                          RBF(1, variance=2.0), noise_var=1e-4)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 100)
        opt = SafeOpt(gp, grid, fmin=[0.0], exact_boundaries=True,
                      boundary_band=100.0, boundary_k=8)
        with caplog.at_level(logging.WARNING):
            x = opt.optimize()
        assert any("triage budget" in r.message for r in caplog.records)
        assert np.isfinite(np.asarray(x)).all()

    def test_requires_f64_oracle(self):
        """exact_boundaries accepts any model with a ``predict_f64``
        host oracle — sparse DTC models included (round 3c) — and only
        rejects oracle-less models (pinned by
        test_unsupported_model_named_in_error)."""
        from safeopt_tpu.gp.sparse import SparseGPRegression

        X = np.linspace(-1, 1, 12)[:, None]
        Y = 1.0 + np.exp(-X ** 2)
        gp = SparseGPRegression(X, Y, RBF(1, variance=2.0), noise_var=1e-4,
                                inducing=6)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 50)
        opt = SafeOpt(gp, grid, fmin=[0.0], exact_boundaries=True)
        x = opt.optimize()
        assert np.isfinite(np.asarray(x)).all()

    def test_checkpoint_roundtrip_keeps_flags(self, tmp_path):
        from safeopt_tpu.utils import checkpoint

        gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                          RBF(1, variance=2.0), noise_var=1e-4)
        grid = linearly_spaced_combinations([(-2.0, 2.0)], 50)
        opt = SafeOpt(gp, grid, fmin=[0.0], exact_boundaries=True,
                      boundary_band=2e-3, boundary_k=16)
        path = str(tmp_path / "cert.npz")
        checkpoint.save(opt, path)
        opt2 = checkpoint.load(path)
        assert opt2._exact_boundaries is True
        assert opt2._boundary_band == 2e-3
        assert opt2._boundary_k == 16


def test_refine_head_is_safe_masked(monkeypatch):
    """The combined refine head must rank SAFE rows only: maximizers,
    expander candidates and the selection argmax all live inside S,
    while unexplored rows at prior-level sigma fill the global top of
    the width order (measured on the cap512 bench: the first expander
    ranks ~427,000th globally but 0th among candidates — a global head
    never reaches it and golden-trajectory identity breaks)."""
    from safeopt_tpu.algorithms import safe_opt_core as core

    gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                      RBF(1, variance=2.0), noise_var=1e-4)
    grid = np.linspace(-2.0, 2.0, 16)[:, None]
    dtype = gp.state.X.dtype
    grid_dev = jax.numpy.asarray(grid, dtype)

    # Hand-built Q: rows 0-7 unsafe (l < fmin) with HUGE widths, rows
    # 8-15 safe with small, increasing widths.
    l = np.concatenate([np.full(8, -5.0), np.linspace(0.5, 0.9, 8)])
    u = np.concatenate([np.full(8, 5.0), np.linspace(0.6, 1.2, 8)])
    Q = jax.numpy.asarray(np.stack([l, u], axis=1), dtype)

    keys = []
    orig = core.partial_top_k

    def spy(key, k):
        keys.append(np.asarray(key))
        return orig(key, k)

    monkeypatch.setattr(core, "partial_top_k", spy)
    core._refine_Q((gp.kern,), (gp.state,), grid_dev, Q,
                   jax.numpy.asarray([0.0], dtype),
                   jax.numpy.asarray(2.0, dtype),
                   jax.numpy.asarray([1.0], dtype),
                   jax.numpy.ones(16, bool), rk=4, band_k=4,
                   refine_band=jax.numpy.asarray(5e-3, dtype))
    # ONE unified top_k: key = max(-margin, combined head), the head
    # (width / incumbent / maximizer proximity scores) over SAFE rows
    # only — on unsafe rows the key falls back to the pure safety
    # margin (they must stay rankable for the refinement band)
    assert len(keys) == 1
    key = keys[0]
    Qn = np.asarray(Q)
    margin = np.abs(Qn[:, 0] - 0.0)          # fmin=0, scaling=1
    np.testing.assert_allclose(
        key[:8], -margin[:8],
        err_msg="unsafe rows must rank by safety margin alone "
                "(head masked)")
    assert np.all(key[8:] >= -margin[8:] - 1e-12), \
        "safe rows must rank at least as high as their margin score"
    # each criterion's own boundary row must sit at the TOP of the
    # combined order: the widest safe row, the incumbent best-l row
    # and the row whose u is closest to best_l all score exactly 0
    widths = Qn[:, 1] - Qn[:, 0]
    best_l = Qn[8:, 0].max()
    top = set(np.argsort(key)[-4:].tolist())
    assert 8 + int(np.argmax(widths[8:])) in top
    assert 8 + int(np.argmax(Qn[8:, 0])) in top
    assert 8 + int(np.argmin(np.abs(Qn[8:, 1] - best_l))) in top


def test_refine_band_must_cover_boundary_band():
    gp = GPRegression(np.array([[0.0]]), np.array([[1.5]]),
                      RBF(1, variance=2.0), noise_var=1e-4)
    grid = linearly_spaced_combinations([(-2.0, 2.0)], 50)
    with pytest.raises(ValueError, match="refine_band"):
        SafeOpt(gp, grid, fmin=[0.0], exact_boundaries=True,
                interval_precision="high", refine_band=1e-4,
                boundary_band=1e-3)


class TestKnifeEdgeWithCompositeKernel:
    """The f64 oracle through a round-3b kernel composition (RBF +
    Poly): the boundary path routes through HostFactor's native grams
    for the new families; truth computed independently with scipy."""

    def _l64(self, X, Y, noise_var, beta, xq):
        def k(A, B):
            g = 2.0 * np.exp(-0.5 * cdist(A, B, "sqeuclidean"))
            return g + 0.1 * (0.05 * (A @ B.T) + 0.5) ** 3

        K = k(X, X)
        cho = scipy.linalg.cho_factor(K + noise_var * np.eye(len(X)),
                                      lower=True)
        kv = k(X, np.atleast_2d(xq))
        mu = kv.T @ scipy.linalg.cho_solve(cho, Y[:, 0])
        v = scipy.linalg.solve_triangular(cho[0], kv, lower=True)
        kdiag = float(k(np.atleast_2d(xq), np.atleast_2d(xq))[0, 0])
        var = np.maximum(kdiag - np.sum(v * v, axis=0), 0.0)
        return float(mu[0] - beta * np.sqrt(var[0]))

    @pytest.mark.parametrize("offset,expect_safe", [(-1e-9, True),
                                                    (1e-9, False)])
    def test_f32_session_decides_by_f64_truth(self, offset, expect_safe):
        from safeopt_tpu.gp import Poly

        rng = np.random.default_rng(3)
        X = rng.uniform(-1.5, 1.5, size=(10, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        grid = linearly_spaced_combinations([(-3.0, 3.0)], 200)
        j = 150
        beta = 2.0
        l64 = self._l64(X, Y, 1e-4, beta, grid[j])
        with jax.enable_x64(False):
            kern = RBF(1, variance=2.0, lengthscale=1.0) \
                + Poly(1, variance=0.1, scale=0.05, bias=0.5, order=3.0)
            gp = GPRegression(X, Y, kern, noise_var=1e-4)
            opt = SafeOpt(gp, grid, fmin=[l64 + offset], beta=beta,
                          exact_boundaries=True, boundary_band=1e-3)
            opt.optimize()
            assert bool(opt.S[j]) is expect_safe


def _dtc_lower_bound(X, Y, Z, noise_var, variance, ls, jitter, beta, xq):
    """Independent scipy float64 DTC posterior lower bound at ``xq``.

    mu = k_z(x)^T A^{-1} K_ZX y / s2,  A = K_ZZ + K_ZX K_XZ / s2
    var = kdiag(x) - k_z(x)^T (K_ZZ^{-1} - A^{-1}) k_z(x)
    """
    def k(A, B):
        return variance * np.exp(-0.5 * cdist(A / ls, B / ls,
                                              "sqeuclidean"))

    Kzz = k(Z, Z) + jitter * np.eye(len(Z))
    Kzx = k(Z, X)
    A = Kzz + Kzx @ Kzx.T / noise_var
    alpha = scipy.linalg.solve(A, Kzx @ Y[:, 0], assume_a="pos") / noise_var
    kq = k(Z, np.atleast_2d(xq))
    mu = float((kq.T @ alpha).item())
    B = np.linalg.inv(Kzz) - np.linalg.inv(A)
    var = max(float(variance - (kq.T @ B @ kq).item()), 0.0)
    return mu - beta * np.sqrt(var)


class TestSparseKnifeEdgeCertification:
    """exact_boundaries certifies SPARSE models too (round-3c): the
    oracle is the host-f64 DTC posterior (``predict_f64``) — exact for
    the model — so the f32 device pseudo-factor never flips knife-edge
    bits. Truth computed independently with scipy."""

    def _setup(self, fmin_offset):
        rng = np.random.default_rng(7)
        X = rng.uniform(-1.5, 1.5, size=(40, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        Z = np.linspace(-1.4, 1.4, 8)[:, None]
        grid = linearly_spaced_combinations([(-3.0, 3.0)], 200)
        j = 150
        beta = 2.0
        jitter = 1e-8
        l64 = _dtc_lower_bound(X, Y, Z, 1e-4, 2.0, 1.0, jitter, beta,
                               grid[j])
        gp = SparseGPRegression(
            X, Y, RBF(1, variance=2.0, lengthscale=1.0),
            noise_var=1e-4, inducing=Z, jitter=jitter)
        opt = SafeOpt(gp, grid, fmin=[l64 + fmin_offset], beta=beta,
                      exact_boundaries=True, boundary_band=1e-3)
        return opt, j

    @pytest.mark.parametrize("offset,expect_safe", [(-1e-9, True),
                                                    (1e-9, False)])
    def test_f32_session_decides_by_f64_truth(self, offset, expect_safe):
        with jax.enable_x64(False):
            opt, j = self._setup(offset)
            opt.optimize()
            assert bool(opt.S[j]) is expect_safe

    @pytest.mark.parametrize("offset,expect_safe", [(-1e-9, True),
                                                    (1e-9, False)])
    def test_f64_session_agrees(self, offset, expect_safe):
        opt, j = self._setup(offset)
        opt.optimize()
        assert bool(opt.S[j]) is expect_safe

    def test_certified_matches_plain_sparse_in_f64(self):
        """In an x64 session device == oracle: the certified sparse
        trajectory must be identical to the plain sparse one."""
        rng = np.random.default_rng(11)
        X = rng.uniform(-1.0, 1.0, size=(30, 1))
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        kern = RBF(1, variance=2.0, lengthscale=1.0)
        grid = linearly_spaced_combinations([(-3.0, 3.0)], 150)
        gps = [SparseGPRegression(X, Y, kern.copy(), noise_var=1e-4,
                                  inducing=10) for _ in range(2)]
        plain = SafeOpt(gps[0], grid, fmin=[0.0], threshold=0.1)
        cert = SafeOpt(gps[1], grid, fmin=[0.0], threshold=0.1,
                       exact_boundaries=True)
        for _ in range(4):
            xp = np.asarray(plain.optimize())
            xc = np.asarray(cert.optimize())
            assert_allclose(xc, xp, atol=0)
            np.testing.assert_array_equal(cert.S, plain.S)
            y = np.array([[float(1.0 + np.exp(-0.5 * xp[0] ** 2))]])
            plain.add_new_data_point(xp, y)
            cert.add_new_data_point(xc, y)

    def test_unsupported_model_named_in_error(self):
        """A model without the f64 oracle is rejected by name."""
        class OracleLess:
            def __init__(self, gp):
                self._gp = gp

            def __getattr__(self, name):
                if name == "predict_f64":
                    raise AttributeError(name)
                return getattr(self._gp, name)

        gp = GPRegression(np.zeros((1, 1)), np.ones((1, 1)),
                          RBF(1), noise_var=1e-4)
        grid = linearly_spaced_combinations([(-1.0, 1.0)], 20)
        with pytest.raises(ValueError, match="OracleLess"):
            SafeOpt(OracleLess(gp), grid, fmin=[0.0],
                    exact_boundaries=True)


@pytest.fixture
def on_gpu(monkeypatch):
    """Make the platform helper report the GPU (the CPU still executes)."""
    from safeopt_tpu import config

    monkeypatch.setattr(config, "platform", lambda: "gpu")


class TestAutoCertifiedPolicy:
    """interval_precision='auto' (the default) resolves to the plain
    path on every backend: the reduced-precision promotion was a
    crossover of the retired chip, and on the GPU reduced precision
    means TF32, whose interval noise ceiling has not been measured.
    These tests pin the resolution matrix."""

    def _gp(self, capacity=16):
        X = np.array([[0.0], [0.5], [1.0]])
        Y = 1.0 + np.exp(-0.5 * X ** 2)
        return GPRegression(X, Y, RBF(1, variance=2.0, lengthscale=1.0),
                            noise_var=1e-4, capacity=capacity)

    def _grid(self):
        return linearly_spaced_combinations([(-2.0, 2.0)], 50)

    def test_cpu_default_resolves_plain(self):
        opt = SafeOpt(self._gp(capacity=512), self._grid(), fmin=[0.0])
        assert opt._interval_precision is None
        assert opt._exact_boundaries is False

    def test_gpu_large_cap_stays_plain(self, on_gpu):
        opt = SafeOpt(self._gp(capacity=512), self._grid(), fmin=[0.0])
        assert opt._interval_precision is None
        assert opt._exact_boundaries is False
        assert opt._refine_k == 0

    @pytest.mark.parametrize("precision", ["high", "default"])
    @pytest.mark.parametrize("capacity", [64, 512])
    def test_gpu_refuses_reduced_precision(self, on_gpu, precision,
                                           capacity):
        with pytest.raises(ValueError, match="not been measured"):
            SafeOpt(self._gp(capacity=capacity), self._grid(),
                    fmin=[0.0], interval_precision=precision)

    @pytest.mark.parametrize("gpu", [False, True], ids=["cpu", "gpu"])
    @pytest.mark.parametrize("capacity", [64, 512])
    def test_no_promotion(self, monkeypatch, gpu, capacity):
        from safeopt_tpu import config

        if gpu:
            monkeypatch.setattr(config, "platform", lambda: "gpu")
        opt = SafeOpt(self._gp(capacity=capacity), self._grid(),
                      fmin=[0.0], interval_precision="auto")
        assert opt._interval_precision is None
        assert opt._exact_boundaries is False
        assert opt._boundary_k == 50          # min(1024, N)

    def test_explicit_precision_implies_certification(self):
        # explicit reduced precision with exact_boundaries left unset
        # resolves to certified rather than raising (CPU only)
        opt = SafeOpt(self._gp(), self._grid(), fmin=[0.0],
                      interval_precision="high")
        assert opt._exact_boundaries is True
        assert opt._interval_precision == "high"

    def test_explicit_false_with_precision_still_raises(self):
        with pytest.raises(ValueError, match="exact_boundaries"):
            SafeOpt(self._gp(), self._grid(), fmin=[0.0],
                    interval_precision="high", exact_boundaries=False)

    def test_gpu_default_step_runs(self, on_gpu):
        """The GPU resolution must execute (the CPU backend stands in as
        the executor): plain path, device oracle when certified."""
        opt = SafeOpt(self._gp(capacity=512), self._grid(), fmin=[0.0])
        x = opt.optimize()
        assert np.isfinite(x).all()
        cert = SafeOpt(self._gp(capacity=512), self._grid(), fmin=[0.0],
                       exact_boundaries=True)
        assert cert._oracle == "device"
        assert np.isfinite(cert.optimize()).all()


class TestDeviceOracle:
    """On-device float64 settlement (oracle='device'): the same f64
    factors the host oracle uses, evaluated by the accelerator, with
    corrections applied in-program (safe_opt_core.device_oracle /
    certified_settle). Must reproduce the host-oracle path's
    trajectory and sets."""

    def _gps(self, sparse=False):
        rng = np.random.default_rng(2)
        X = rng.uniform(-2.0, 2.0, size=(60, 2))
        Y = (1.0 + np.exp(-0.5 * np.sum(X ** 2, axis=1))
             + 0.01 * rng.normal(size=60))[:, None]
        kern = RBF(2, variance=2.0, lengthscale=1.0)
        if sparse:
            return SparseGPRegression(X, Y, kern, noise_var=1e-4,
                                      inducing=16)
        return GPRegression(X, Y, kern, noise_var=1e-4)

    def _grid(self):
        return linearly_spaced_combinations(
            [(-2.0, 2.0), (-2.0, 2.0)], 30)

    @pytest.mark.parametrize("sparse", [False, True])
    def test_matches_host_oracle_path(self, sparse):
        grid = self._grid()
        host = SafeOpt(self._gps(sparse), grid, fmin=[1.0],
                       exact_boundaries=True, oracle="host")
        dev = SafeOpt(self._gps(sparse), grid, fmin=[1.0],
                      exact_boundaries=True, oracle="device")
        x_h = host.optimize()
        x_d = dev.optimize()
        np.testing.assert_array_equal(x_d, x_h)
        np.testing.assert_array_equal(dev.S, host.S)
        np.testing.assert_array_equal(dev.M, host.M)
        np.testing.assert_array_equal(dev.G, host.G)
        assert dev._band_population == host._band_population
        assert dev._certified_corrections == host._certified_corrections

    def test_oracle_state_matches_host_factors(self):
        gp = self._gps()
        st, kind = gp.device_oracle_state()
        assert kind == "exact"
        assert st.X.dtype == np.float64 and st.F.dtype == np.float64
        np.testing.assert_array_equal(np.asarray(st.F), gp._host.Linv)
        np.testing.assert_array_equal(np.asarray(st.w), gp._host.w)
        # cache invalidates on model update
        gp.append_data(np.array([0.3, -0.2]), 1.4)
        st2, _ = gp.device_oracle_state()
        assert int(st2.count) == int(st.count) + 1

    def test_interval_scan_plus_finish_equals_certified_scan(self):
        """The device-oracle pipeline's pass 1+3 (interval_scan ->
        certified_finish with NO fixes) must reproduce certified_scan's
        classification exactly — they are the same math with
        classification moved after the oracle. And manufactured flips
        through certified_finish equal a direct safeopt_step_from_Q."""
        import jax.numpy as jnp

        from safeopt_tpu.algorithms.safe_opt_core import (
            certified_finish, certified_scan, interval_scan,
            safeopt_step_from_Q)
        from safeopt_tpu.config import default_dtype

        gp = self._gps()
        grid = jnp.asarray(self._grid(), default_dtype())
        dtype = default_dtype()
        fmin = jnp.asarray([1.0], dtype)
        beta = jnp.asarray(2.0, dtype)
        scaling = jnp.asarray([np.sqrt(2.0)], dtype)
        threshold = jnp.asarray([0.0], dtype)
        k = 64
        res, packed = certified_scan(
            (gp.kern,), (gp.state,), grid, fmin, beta, scaling,
            threshold, jnp.asarray(1e-3, dtype), k=k, chunk=16)
        Q, packed_t = interval_scan(
            (gp.kern,), (gp.state,), grid, fmin, beta, scaling,
            jnp.asarray(1e-3, dtype), k=k)
        np.testing.assert_array_equal(np.asarray(Q), np.asarray(res.Q))
        # triage halves agree: [total, refine_pop, idx(k), within(k)]
        np.testing.assert_array_equal(np.asarray(packed_t),
                                      np.asarray(packed)[5:5 + 2 + 2 * k])

        p = np.asarray(packed_t)
        idx = p[2:2 + k]
        within = p[2 + k:2 + 2 * k].astype(bool)
        assert within.any(), "test config must have band rows"

        zero = jnp.asarray(0, jnp.int32)
        no_fix = jnp.full((k,), -1, jnp.int32)
        out0, diag0 = certified_finish(
            (gp.kern,), (gp.state,), grid, Q, packed_t, no_fix,
            jnp.zeros((k,), bool), zero, zero,
            fmin, beta, scaling, threshold, chunk=16)
        np.testing.assert_array_equal(np.asarray(out0.S),
                                      np.asarray(res.S))
        np.testing.assert_array_equal(np.asarray(out0.M),
                                      np.asarray(res.M))
        np.testing.assert_array_equal(np.asarray(out0.G),
                                      np.asarray(res.G))
        assert int(out0.next_idx) == int(res.next_idx)
        assert diag0.shape == (9,)

        # manufactured flips == direct from_Q
        s32 = np.asarray(res.S)[idx]
        fix_bits = np.where(within, ~s32, False)
        fix_idx = np.where(within, idx, -1).astype(np.int32)
        out, diag9 = certified_finish(
            (gp.kern,), (gp.state,), grid, Q, packed_t,
            jnp.asarray(fix_idx), jnp.asarray(fix_bits),
            jnp.asarray(int(within.sum()), jnp.int32),
            jnp.asarray(int(within.sum()), jnp.int32),
            fmin, beta, scaling, threshold, chunk=16)
        ref = safeopt_step_from_Q(
            (gp.kern,), (gp.state,), grid, Q, jnp.asarray(fix_idx),
            jnp.asarray(fix_bits), fmin, beta, scaling, threshold,
            chunk=16)
        np.testing.assert_array_equal(np.asarray(out.S),
                                      np.asarray(ref.S))
        assert int(out.next_idx) == int(ref.next_idx)
        assert int(diag9[5]) == int(within.sum())

    def test_auto_resolves_host_on_cpu(self):
        opt = SafeOpt(self._gps(), self._grid(), fmin=[1.0],
                      exact_boundaries=True)
        assert opt._oracle == "host"

    def test_validation(self):
        with pytest.raises(ValueError, match="oracle"):
            SafeOpt(self._gps(), self._grid(), fmin=[1.0],
                    oracle="nonsense")

    def test_reduced_precision_with_device_oracle(self):
        grid = self._grid()
        host = SafeOpt(self._gps(), grid, fmin=[1.0],
                       interval_precision="high", oracle="host")
        dev = SafeOpt(self._gps(), grid, fmin=[1.0],
                      interval_precision="high", oracle="device")
        x_h = host.optimize()
        x_d = dev.optimize()
        np.testing.assert_array_equal(x_d, x_h)
        np.testing.assert_array_equal(dev.S, host.S)

    def test_auto_boundary_k(self, on_gpu):
        """boundary_k=None resolves to 1024 on every backend; an
        explicit value wins."""
        gp = self._gps()
        grid = linearly_spaced_combinations(
            [(-2.0, 2.0), (-2.0, 2.0)], 40)
        plain = SafeOpt(gp, grid, fmin=[1.0])
        assert plain._boundary_k == min(1024, 1600)
        explicit = SafeOpt(gp, grid, fmin=[1.0], boundary_k=256)
        assert explicit._boundary_k == 256

    def test_auto_resolves_device_on_gpu(self, on_gpu):
        opt = SafeOpt(self._gps(), self._grid(), fmin=[1.0],
                      exact_boundaries=True)
        assert opt._oracle == "device"
