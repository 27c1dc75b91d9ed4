"""GP hyperparameter learning by marginal-likelihood gradient ascent.

The reference consumes GPy models with *fixed* hyperparameters (its
notebooks never call GPy's ``optimize()``), but real users tune
kernels. This module provides that capability natively: the log
marginal likelihood is differentiable through the Cholesky, so
``jax.grad`` + optax Adam on log-transformed parameters handles any
kernel pytree (including ARD vectors and product compositions)
without per-kernel code.

Numerics: the objective factorizes the (tiny) n x n gram, so the whole
optimization runs on the host CPU backend **in float64**, forced via
``jax.enable_x64`` regardless of the session's x64 flag —
an f32 Cholesky of an ill-conditioned gram (repeated query points push
kappa to ~1e7) NaNs out and silently corrupts the fit (see
host_math.py and CLAUDE.md's invariant). Non-finite results are
rejected: the input hyperparameters are returned unchanged.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["log_marginal_likelihood", "sparse_log_marginal_likelihood",
           "fit_hyperparameters"]


def log_marginal_likelihood(kernel, X: jnp.ndarray, Y: jnp.ndarray,
                            noise_var) -> jnp.ndarray:
    """Exact GP log marginal likelihood log p(Y | X, theta).

    ``-0.5 y^T K^-1 y - sum(log diag L) - n/2 log(2 pi)`` with
    ``K = kern(X) + noise * I``.
    """
    n = X.shape[0]
    K = kernel.K(X) + noise_var * jnp.eye(n, dtype=X.dtype)
    L = jnp.linalg.cholesky(K)
    alpha = jax.scipy.linalg.cho_solve((L, True), Y[:, 0])
    return (-0.5 * jnp.dot(Y[:, 0], alpha)
            - jnp.sum(jnp.log(jnp.diag(L)))
            - 0.5 * n * jnp.log(2.0 * jnp.pi))


def sparse_log_marginal_likelihood(kernel, X, Y, Z, noise_var):
    """DTC log marginal likelihood in O(m^2 n).

    ``log N(y; 0, K_xz K_zz^-1 K_zx + s2 I)`` via the Woodbury
    identity with ``A = K_zz + K_zx K_xz / s2``:

        logdet = n log s2 + logdet A - logdet K_zz
        quad   = (y.y - (K_zx y)^T A^-1 (K_zx y) / s2) / s2

    Differentiable through both Choleskys — in the kernel
    hyperparameters AND in the inducing locations ``Z`` — so the same
    log-space Adam machinery fits sparse models (``lml_fn`` hook of
    ``fit_hyperparameters``), and passing ``inducing=`` there optimizes
    ``Z`` jointly (GPy's sparse ``optimize()`` semantics).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y).reshape(X.shape[0], -1)
    Z = jnp.asarray(Z)
    n, m = X.shape[0], Z.shape[0]
    s2 = noise_var
    Kzz = kernel.K(Z) + 1e-8 * jnp.eye(m, dtype=X.dtype)
    Kzx = kernel.K(Z, X)
    A = Kzz + Kzx @ Kzx.T / s2
    La = jnp.linalg.cholesky(A)
    Lz = jnp.linalg.cholesky(Kzz)
    logdet = (n * jnp.log(s2)
              + 2.0 * jnp.sum(jnp.log(jnp.diag(La)))
              - 2.0 * jnp.sum(jnp.log(jnp.diag(Lz))))
    y = Y[:, 0]
    b = Kzx @ y
    c = jax.scipy.linalg.cho_solve((La, True), b)
    quad = (jnp.dot(y, y) - jnp.dot(b, c) / s2) / s2
    return -0.5 * (quad + logdet + n * jnp.log(2.0 * jnp.pi))


def fit_hyperparameters(kernel, X, Y, noise_var: float, *,
                        steps: int = 200, learning_rate: float = 0.05,
                        optimize_noise: bool = True,
                        noise_floor: float = 1e-6,
                        restarts: int = 0, restart_scale: float = 1.5,
                        seed: int = 0, lml_fn=None, polish: bool = True,
                        inducing=None, device: str = "auto") -> Tuple:
    """Maximize the marginal likelihood over kernel params (+ noise).

    All kernel pytree leaves (variances, lengthscales — scalar or ARD,
    through product compositions) are optimized in log space with Adam.

    ``restarts`` adds that many extra runs from log-space-perturbed
    initial points (``restart_scale`` standard deviations in log space,
    deterministic per ``seed``) — the GPy ``optimize_restarts`` idiom
    for multimodal LML surfaces. All runs are vmapped into ONE compiled
    program; the best finite result wins, then a BFGS ``polish`` pass
    (GPy's optimizer family) sharpens it — kept only when finite and
    better. ``lml_fn(kernel, noise_var) -> scalar`` overrides the
    objective (used by the sparse DTC model).

    ``inducing``: an (m, d) array of inducing locations to optimize
    JOINTLY with the hyperparameters (GPy's sparse ``optimize()``
    semantics: Z is a model parameter). Locations move in raw input
    space (no log transform); restarts perturb only the log-space
    hyperparameters, every run sharing the initial Z. Requires an
    ``lml_fn(kernel, noise_var, Z) -> scalar`` objective; the return
    becomes ``(kernel, noise_var, Z, best_lml)``.

    Returns ``(kernel, noise_var, best_lml)``. If every run produces a
    non-finite marginal likelihood or non-finite parameters (e.g. a
    degenerate gram collapsed the Cholesky), the input hyperparameters
    are returned unchanged together with their own LML.
    """
    import logging

    import optax

    from ..config import default_dtype

    # The session's float width, captured BEFORE the x64 island: the
    # fitted kernel leaves are cast back to it so an f32 session does
    # not end up tracing f64 numpy hyperparameters (dtype-truncation
    # warnings on every subsequent jit).
    session_dtype = np.dtype(default_dtype())

    # Float64 island (CLAUDE.md invariant): the whole optimization —
    # gram, Cholesky, Adam state — runs in f64 even when the session
    # default is f32 (GPU sessions leave jax_enable_x64 off).
    with jax.enable_x64(True):
        X = jnp.asarray(np.asarray(X, dtype=np.float64), jnp.float64)
        Y = jnp.asarray(np.asarray(Y, dtype=np.float64).reshape(-1, 1),
                        jnp.float64)
        if inducing is not None and lml_fn is None:
            raise ValueError(
                "inducing= requires an lml_fn(kernel, noise_var, Z) "
                "objective (e.g. sparse_log_marginal_likelihood); the "
                "default exact-GP objective has no inducing points")
        if lml_fn is None:
            def lml_fn(kern, nv):
                return log_marginal_likelihood(kern, X, Y, nv)

        leaves, treedef = jax.tree_util.tree_flatten(kernel)
        params = {
            "kern": [jnp.log(jnp.maximum(jnp.asarray(leaf, jnp.float64),
                                         1e-10)) for leaf in leaves],
            "noise": jnp.log(jnp.asarray(max(noise_var, noise_floor),
                                         jnp.float64)),
        }
        if inducing is not None:
            params["Z"] = jnp.asarray(
                np.atleast_2d(np.asarray(inducing, dtype=np.float64)),
                jnp.float64)

        def unpack(p):
            kern = jax.tree_util.tree_unflatten(
                treedef, [jnp.exp(v) for v in p["kern"]])
            nv = (jnp.exp(p["noise"]) + noise_floor if optimize_noise
                  else jnp.asarray(noise_var, X.dtype))
            return kern, nv

        def loss(p):
            kern, nv = unpack(p)
            if "Z" in p:
                return -lml_fn(kern, nv, p["Z"])
            return -lml_fn(kern, nv)

        opt = optax.adam(learning_rate)

        @jax.jit
        def run(params):
            state = opt.init(params)

            def step(carry, _):
                params, state = carry
                val, grads = jax.value_and_grad(loss)(params)
                # a NaN loss poisons Adam state permanently; freeze
                # that restart instead so diverged inits fail cleanly
                grads = jax.tree_util.tree_map(
                    lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads)
                updates, state = opt.update(grads, state)
                params = optax.apply_updates(params, updates)
                return (params, state), val

            (params, _), vals = jax.lax.scan(step, (params, state), None,
                                             length=steps)
            return params, -loss(params)

        # Restart fan-out: run 0 starts from the CURRENT hyperparameters
        # (preserving the single-run behavior); runs 1..r perturb every
        # log-space coordinate. One vmapped program, not r compiles.
        r = int(restarts)
        if r > 0:
            key = jax.random.key(seed)
            # deterministic distinct keys per leaf position; inducing
            # locations are raw coordinates, not log hyperparameters —
            # restarts leave them at the shared initial Z (scale 0)
            flat_p, tdef = jax.tree_util.tree_flatten_with_path(params)
            scales = [0.0 if (p and getattr(p[0], "key", None) == "Z")
                      else restart_scale for p, _ in flat_p]
            flat = [f for _, f in flat_p]
            keys = jax.random.split(key, len(flat))
            pert = [jax.random.normal(keys[i], (r,) + jnp.shape(f),
                                      jnp.float64) * scales[i]
                    for i, f in enumerate(flat)]
            stacked = [jnp.concatenate(
                [jnp.broadcast_to(f, (1,) + jnp.shape(f)),
                 f[None] + p], axis=0) for f, p in zip(flat, pert)]
            params_b = jax.tree_util.tree_unflatten(tdef, stacked)
            runner = jax.jit(jax.vmap(run))
        else:
            params_b = jax.tree_util.tree_map(lambda v: v[None], params)
            runner = jax.jit(jax.vmap(run))

        # Device routing: the LML objective is (n, n) factor math and
        # an Adam scan of hundreds of tiny steps, so per-step dispatch
        # overheads dominate any compute win on an accelerator at BO
        # shapes (n<=512); the GPU route has not been measured yet.
        # 'auto' therefore routes to the CPU when one is registered;
        # 'accel' leaves the backend default in charge.
        if device not in ("auto", "cpu", "accel"):
            raise ValueError("device must be 'auto', 'cpu' or 'accel', "
                             f"got {device!r}")
        if device == "accel" and restarts > 0:
            # The vmapped (restarts+1)-way LML scan batch (a batched
            # Cholesky inside a scan) has not been run on the GPU yet;
            # refuse it until it is measured there.
            raise ValueError(
                "device='accel' with restarts>0 batches the LML scans "
                "via vmap, which has not yet been run on this device; "
                "use device='auto'/'cpu' or loop single accel fits "
                "manually")
        cpu = None
        if device in ("auto", "cpu"):
            try:
                cpu = jax.devices("cpu")[0]
            except RuntimeError:
                cpu = None
        if cpu is not None:
            with jax.default_device(cpu):
                params_b, lmls = runner(params_b)
        else:
            params_b, lmls = runner(params_b)

        params_b = jax.device_get(params_b)
        lmls = np.asarray(lmls)
        leaves_b = jax.tree_util.tree_leaves(params_b)
        finite_params = np.array([
            all(np.all(np.isfinite(np.asarray(v)[i])) for v in leaves_b)
            for i in range(lmls.shape[0])])
        ok = np.isfinite(lmls) & finite_params
        if not ok.any():
            logging.warning(
                "hyperparameter fit produced non-finite LML/params in "
                "all %d run(s); keeping the input hyperparameters",
                lmls.shape[0])
            kern0, nv0 = unpack(params)
            if inducing is not None:
                lml0 = float(lml_fn(kern0, nv0, params["Z"]))
                return (kernel, float(noise_var),
                        np.asarray(params["Z"], dtype=np.float64), lml0)
            lml0 = float(lml_fn(kern0, nv0))
            return kernel, float(noise_var), lml0

        best = int(np.argmax(np.where(ok, lmls, -np.inf)))
        params = jax.tree_util.tree_map(lambda v: v[best], params_b)
        lml = float(lmls[best])

        if polish:
            # BFGS polish from the best Adam iterate — GPy's
            # ``optimize()`` is (L-)BFGS; Adam finds the basin, a
            # quasi-Newton pass sharpens convergence (Adam's fixed step
            # stalls ~1e-2 from the optimum on stiff LML surfaces).
            # Kept only when finite AND better.
            from jax.flatten_util import ravel_pytree
            from jax.scipy.optimize import minimize as _jmin

            v0, unravel = ravel_pytree(params)

            def vec_loss(v):
                return loss(unravel(v))

            try:
                if cpu is not None:
                    with jax.default_device(cpu):
                        res = _jmin(vec_loss, v0, method="BFGS",
                                    options={"maxiter": 100})
                else:
                    res = _jmin(vec_loss, v0, method="BFGS",
                                options={"maxiter": 100})
                v1 = np.asarray(res.x)
                lml1 = -float(res.fun)
                if np.all(np.isfinite(v1)) and np.isfinite(lml1) \
                        and lml1 > lml:
                    params = jax.device_get(unravel(jnp.asarray(v1)))
                    lml = lml1
            except Exception:   # pragma: no cover - BFGS is best-effort
                logging.debug("BFGS polish failed; keeping Adam result",
                              exc_info=True)

        kern, nv = unpack(params)
        # Hand back host numpy leaves at the SESSION float width: live
        # f64 jnp leaves (or f64 numpy) would clash with an f32 session
        # once the x64 context exits.
        kern = jax.tree_util.tree_map(
            lambda v: np.asarray(v, dtype=session_dtype), kern)
    if inducing is not None:
        # inducing coordinates feed host-f64 factor math, not traces
        return (kern, float(nv),
                np.asarray(params["Z"], dtype=np.float64), lml)
    return kern, float(nv), lml
