"""Independent NumPy float64 reference implementation for golden tests.

GPy is not installable in this environment, so parity targets are
recorded from this minimal, from-scratch NumPy implementation of the
exact same math the reference delegates to GPy (full refit per data
change, scipy Cholesky solves). It deliberately shares no code with
``safeopt_tpu`` — gram matrices via scipy ``cdist``, posteriors via
``cho_solve`` — so agreement is meaningful.

Semantics mirrored from the reference:
- predict_noiseless: latent posterior, no likelihood noise in var
  (/root/reference/safeopt/gp_opt.py:469)
- set_XY-style full refit on every data change
  (/root/reference/safeopt/gp_opt.py:227-228)
"""

import numpy as np
import scipy.linalg
from scipy.spatial.distance import cdist


class RefRBF:
    def __init__(self, input_dim, variance=1.0, lengthscale=1.0, ARD=False,
                 active_dims=None):
        self.input_dim = input_dim
        self.variance = float(variance)
        self.lengthscale = np.atleast_1d(np.asarray(lengthscale, dtype=float))
        self.ARD = ARD
        self.active_dims = (np.arange(input_dim) if active_dims is None
                            else np.asarray(active_dims))

    def _sliced(self, X):
        return np.atleast_2d(X)[:, self.active_dims] / self.lengthscale

    def K(self, X, X2=None):
        Xs = self._sliced(X)
        Zs = Xs if X2 is None else self._sliced(X2)
        r2 = cdist(Xs, Zs, metric="sqeuclidean")
        return self.variance * np.exp(-0.5 * r2)

    def Kdiag(self, X):
        return self.variance * np.ones(np.atleast_2d(X).shape[0])

    def __mul__(self, other):
        return RefProduct(self, other)

    def __add__(self, other):
        return RefSum(self, other)


class RefMatern32(RefRBF):
    def K(self, X, X2=None):
        Xs = self._sliced(X)
        Zs = Xs if X2 is None else self._sliced(X2)
        r = cdist(Xs, Zs, metric="euclidean")
        s3r = np.sqrt(3.0) * r
        return self.variance * (1.0 + s3r) * np.exp(-s3r)


class RefMatern52(RefRBF):
    def K(self, X, X2=None):
        Xs = self._sliced(X)
        Zs = Xs if X2 is None else self._sliced(X2)
        r2 = cdist(Xs, Zs, metric="sqeuclidean")
        r = np.sqrt(r2)
        s5r = np.sqrt(5.0) * r
        return self.variance * (1.0 + s5r + (5.0 / 3.0) * r2) \
            * np.exp(-s5r)


class RefProduct:
    def __init__(self, k1, k2):
        self.k1, self.k2 = k1, k2

    @property
    def input_dim(self):
        return int(max(self.k1.active_dims.max(),
                       self.k2.active_dims.max())) + 1

    def K(self, X, X2=None):
        return self.k1.K(X, X2) * self.k2.K(X, X2)

    def Kdiag(self, X):
        return self.k1.Kdiag(X) * self.k2.Kdiag(X)

    def __mul__(self, other):
        return RefProduct(self, other)

    def __add__(self, other):
        return RefSum(self, other)


class RefExponential(RefRBF):
    """Matern-1/2 / OU mirror of safeopt_tpu.Exponential."""

    def K(self, X, X2=None):
        Xs = self._sliced(X)
        Zs = Xs if X2 is None else self._sliced(X2)
        r = cdist(Xs, Zs, metric="euclidean")
        return self.variance * np.exp(-r)


class RefBias(RefRBF):
    """Constant-kernel mirror of safeopt_tpu.Bias."""

    def K(self, X, X2=None):
        n = np.atleast_2d(X).shape[0]
        m = n if X2 is None else np.atleast_2d(X2).shape[0]
        return self.variance * np.ones((n, m))


class RefWhite(RefRBF):
    """White-noise mirror of safeopt_tpu.White (GPy semantics: var*I on
    one set, zero across two sets)."""

    def K(self, X, X2=None):
        n = np.atleast_2d(X).shape[0]
        if X2 is None:
            return self.variance * np.eye(n)
        return np.zeros((n, np.atleast_2d(X2).shape[0]))


class RefRatQuad(RefRBF):
    """Rational-quadratic mirror of safeopt_tpu.RatQuad."""

    def __init__(self, input_dim, variance=1.0, lengthscale=1.0, power=2.0,
                 ARD=False, active_dims=None):
        super().__init__(input_dim, variance=variance,
                         lengthscale=lengthscale, ARD=ARD,
                         active_dims=active_dims)
        self.power = float(power)

    def K(self, X, X2=None):
        Xs = self._sliced(X)
        Zs = Xs if X2 is None else self._sliced(X2)
        r2 = cdist(Xs, Zs, metric="sqeuclidean")
        return self.variance * (1.0 + 0.5 * r2) ** (-self.power)


class RefCosine(RefRBF):
    """Cosine mirror of safeopt_tpu.Cosine (GPy.kern.Cosine)."""

    def K(self, X, X2=None):
        Xs = self._sliced(X)
        Zs = Xs if X2 is None else self._sliced(X2)
        r = cdist(Xs, Zs, metric="euclidean")
        return self.variance * np.cos(r)


class RefPoly:
    """Polynomial mirror of safeopt_tpu.Poly (GPy.kern.Poly)."""

    def __init__(self, input_dim, variance=1.0, scale=1.0, bias=1.0,
                 order=3.0, active_dims=None):
        self.input_dim = input_dim
        self.variance = float(variance)
        self.scale = float(scale)
        self.bias = float(bias)
        self.order = float(order)
        self.active_dims = (np.arange(input_dim) if active_dims is None
                            else np.asarray(active_dims))

    def K(self, X, X2=None):
        Xa = np.atleast_2d(X)[:, self.active_dims]
        Za = Xa if X2 is None else np.atleast_2d(X2)[:, self.active_dims]
        return self.variance * (self.scale * (Xa @ Za.T)
                                + self.bias) ** self.order

    def Kdiag(self, X):
        Xa = np.atleast_2d(X)[:, self.active_dims]
        dot = np.sum(Xa * Xa, axis=1)
        return self.variance * (self.scale * dot + self.bias) ** self.order

    def __mul__(self, other):
        return RefProduct(self, other)

    def __add__(self, other):
        return RefSum(self, other)


class RefMLP:
    """Arcsine mirror of safeopt_tpu.MLP (GPy.kern.MLP)."""

    def __init__(self, input_dim, variance=1.0, weight_variance=1.0,
                 bias_variance=1.0, ARD=False, active_dims=None):
        self.input_dim = input_dim
        self.variance = float(variance)
        self.weight_variance = np.atleast_1d(
            np.asarray(weight_variance, dtype=float))
        self.bias_variance = float(bias_variance)
        self.ARD = ARD
        self.active_dims = (np.arange(input_dim) if active_dims is None
                            else np.asarray(active_dims))

    def _wprod(self, X, X2=None):
        if X2 is None:
            return (np.sum(X * X * self.weight_variance, axis=1)
                    + self.bias_variance)
        return (X * self.weight_variance) @ X2.T + self.bias_variance

    def K(self, X, X2=None):
        Xa = np.atleast_2d(X)[:, self.active_dims]
        Za = Xa if X2 is None else np.atleast_2d(X2)[:, self.active_dims]
        xd = np.sqrt(self._wprod(Xa) + 1.0)
        zd = xd if X2 is None else np.sqrt(self._wprod(Za) + 1.0)
        cos = np.clip(self._wprod(Xa, Za) / xd[:, None] / zd[None, :],
                      -1.0, 1.0)
        return self.variance * (2.0 / np.pi) * np.arcsin(cos)

    def Kdiag(self, X):
        Xa = np.atleast_2d(X)[:, self.active_dims]
        p = self._wprod(Xa)
        return self.variance * (2.0 / np.pi) * np.arcsin(p / (p + 1.0))

    def __mul__(self, other):
        return RefProduct(self, other)

    def __add__(self, other):
        return RefSum(self, other)


class RefLinear:
    """Dot-product mirror of safeopt_tpu.Linear (GPy.kern.Linear)."""

    def __init__(self, input_dim, variances=1.0, ARD=False,
                 active_dims=None):
        self.input_dim = input_dim
        self.variances = np.atleast_1d(np.asarray(variances, dtype=float))
        self.ARD = ARD
        self.active_dims = (np.arange(input_dim) if active_dims is None
                            else np.asarray(active_dims))

    def K(self, X, X2=None):
        Xa = np.atleast_2d(X)[:, self.active_dims]
        Za = Xa if X2 is None else np.atleast_2d(X2)[:, self.active_dims]
        return (Xa * self.variances) @ Za.T

    def Kdiag(self, X):
        Xa = np.atleast_2d(X)[:, self.active_dims]
        return np.sum(Xa * Xa * self.variances, axis=1)

    def __mul__(self, other):
        return RefProduct(self, other)

    def __add__(self, other):
        return RefSum(self, other)


class RefSum(RefProduct):
    """Sum-composition mirror of safeopt_tpu.Sum."""

    def K(self, X, X2=None):
        return self.k1.K(X, X2) + self.k2.K(X, X2)

    def Kdiag(self, X):
        return self.k1.Kdiag(X) + self.k2.Kdiag(X)


class RefGP:
    """Full-refit exact GP regression (what GPy does under set_XY)."""

    def __init__(self, X, Y, kernel=None, noise_var=1.0):
        self.X = np.atleast_2d(np.asarray(X, dtype=float)).copy()
        self.Y = np.asarray(Y, dtype=float).reshape(self.X.shape[0], 1).copy()
        self.kern = kernel if kernel is not None else RefRBF(self.X.shape[1])
        self.noise_var = float(noise_var)
        self._refit()

    @property
    def input_dim(self):
        return self.X.shape[1]

    def _refit(self):
        n = self.X.shape[0]
        K = self.kern.K(self.X) + self.noise_var * np.eye(n)
        self._cho = scipy.linalg.cho_factor(K, lower=True)
        self._alpha = scipy.linalg.cho_solve(self._cho, self.Y)

    def set_XY(self, X, Y):
        self.X = np.atleast_2d(np.asarray(X, dtype=float)).copy()
        self.Y = np.asarray(Y, dtype=float).reshape(self.X.shape[0], 1).copy()
        self._refit()

    def predict_noiseless(self, Xq):
        Xq = np.atleast_2d(Xq)
        kvec = self.kern.K(self.X, Xq)               # (n, m)
        mu = kvec.T @ self._alpha                    # (m, 1)
        v = scipy.linalg.solve_triangular(self._cho[0], kvec, lower=True)
        var = self.kern.Kdiag(Xq) - np.sum(v * v, axis=0)
        return mu, np.maximum(var, 0.0)[:, None]

    _raw_predict = predict_noiseless


class RefSafeOpt:
    """Sequential-loop float64 SafeOpt, mirroring the reference algorithm
    (/root/reference/safeopt/gp_opt.py:281-712) on top of RefGP.

    Used to record golden trajectories that the fused device implementation
    must reproduce.
    """

    def __init__(self, gps, parameter_set, fmin, lipschitz=None, beta=2,
                 num_contexts=0, threshold=0, scaling="auto"):
        self.gps = gps if isinstance(gps, list) else [gps]
        self.gp = self.gps[0]
        self.fmin = np.atleast_1d(np.asarray(
            fmin if isinstance(fmin, list) else [fmin] * len(self.gps),
            dtype=float).squeeze())
        self.beta = beta if callable(beta) else (lambda t: beta)
        if isinstance(scaling, str):
            self.scaling = np.sqrt(np.array(
                [gp.kern.Kdiag(np.zeros((1, gp.input_dim)))[0]
                 for gp in self.gps]))
        else:
            self.scaling = np.asarray(scaling, dtype=float)
        self.threshold = threshold
        self.num_contexts = num_contexts

        parameter_set = np.asarray(parameter_set, dtype=float)
        if num_contexts > 0:
            self.inputs = np.hstack(
                (parameter_set, np.zeros((parameter_set.shape[0],
                                          num_contexts))))
        else:
            self.inputs = parameter_set

        self.lipschitz = lipschitz
        if self.lipschitz is not None:
            if not isinstance(self.lipschitz, list):
                self.lipschitz = [self.lipschitz] * len(self.gps)
            self.lipschitz = np.atleast_1d(
                np.asarray(self.lipschitz, dtype=float).squeeze())
        self.use_lipschitz = self.lipschitz is not None

        N = self.inputs.shape[0]
        self.Q = np.zeros((N, 2 * len(self.gps)))
        self.S = np.zeros(N, dtype=bool)
        self.M = np.zeros(N, dtype=bool)
        self.G = np.zeros(N, dtype=bool)
        self._t = self.gp.X.shape[0]

    @property
    def t(self):
        return self._t

    def add_new_data_point(self, x, y, context=None):
        x = np.atleast_2d(np.asarray(x, dtype=float))
        y = np.atleast_2d(np.asarray(y, dtype=float))
        if self.num_contexts:
            ctx = np.atleast_2d(np.asarray(context, dtype=float))
            x = np.hstack([x, np.broadcast_to(ctx, (x.shape[0],
                                                    ctx.shape[1]))])
        for i, gp in enumerate(self.gps):
            keep = ~np.isnan(y[:, i])
            if np.any(keep):
                gp.set_XY(np.vstack([gp.X, x[keep]]),
                          np.vstack([gp.Y, y[keep][:, [i]]]))
        self._t += x.shape[0]

    def set_context(self, context):
        if self.num_contexts:
            self.inputs[:, -self.num_contexts:] = context

    def update_confidence_intervals(self, context=None):
        beta = self.beta(self.t)
        self.set_context(context)
        for i, gp in enumerate(self.gps):
            mu, var = gp.predict_noiseless(self.inputs)
            sd = np.sqrt(var.squeeze())
            self.Q[:, 2 * i] = mu.squeeze() - beta * sd
            self.Q[:, 2 * i + 1] = mu.squeeze() + beta * sd

    def compute_safe_set(self):
        self.S[:] = np.all(self.Q[:, ::2] > self.fmin, axis=1)

    def compute_sets(self, full_sets=False):
        beta = self.beta(self.t)
        self.compute_safe_set()
        l0 = self.Q[:, 0]
        u0 = self.Q[:, 1]
        self.M[:] = False
        self.G[:] = False
        if not np.any(self.S):
            return
        self.M[self.S] = u0[self.S] >= np.max(l0[self.S])
        max_var = np.max(u0[self.M] - l0[self.M]) / self.scaling[0]

        l = self.Q[:, ::2]
        u = self.Q[:, 1::2]
        if full_sets:
            s = self.S.copy()
        else:
            s = np.logical_and(self.S, ~self.M)
            s[s] = np.max((u[s] - l[s]) / self.scaling, axis=1) > max_var
            s[s] = np.any(u[s] - l[s] > self.threshold * beta, axis=1)
            if not np.any(s):
                return

        cand_idx = np.flatnonzero(s)
        widths = np.max(u[cand_idx] - l[cand_idx], axis=1)
        if full_sets:
            order = range(len(cand_idx))
        else:
            order = np.argsort(widths, kind="stable")[::-1]

        G_safe = np.zeros(len(cand_idx), dtype=bool)
        for index in order:
            gi = cand_idx[index]
            if self.use_lipschitz:
                dvec = np.linalg.norm(
                    self.inputs[~self.S] - self.inputs[gi], axis=1)
                for i in range(len(self.gps)):
                    if self.fmin[i] == -np.inf:
                        continue
                    G_safe[index] = np.any(
                        u[gi, i] - self.lipschitz[i] * dvec >= self.fmin[i])
                    if not G_safe[index]:
                        break
            else:
                for i, gp in enumerate(self.gps):
                    if self.fmin[i] == -np.inf:
                        continue
                    X_saved, Y_saved = gp.X.copy(), gp.Y.copy()
                    gp.set_XY(np.vstack([gp.X, self.inputs[[gi]]]),
                              np.vstack([gp.Y, [[u[gi, i]]]]))
                    mu2, var2 = gp.predict_noiseless(self.inputs[~self.S])
                    gp.set_XY(X_saved, Y_saved)
                    l2 = mu2.squeeze() - beta * np.sqrt(var2.squeeze())
                    G_safe[index] = np.any(np.atleast_1d(l2) >= self.fmin[i])
                    if not G_safe[index]:
                        break
            if G_safe[index] and not full_sets:
                break
        self.G[cand_idx] = G_safe

    def get_new_query_point(self, ucb=False):
        if not np.any(self.S):
            raise EnvironmentError("There are no safe points to evaluate.")
        if ucb:
            value = np.where(self.S, self.Q[:, 1], -np.inf)
        else:
            l = self.Q[:, ::2]
            u = self.Q[:, 1::2]
            MG = self.M | self.G
            value = np.where(MG, np.max((u - l) / self.scaling, axis=1),
                             -np.inf)
        x = self.inputs[np.argmax(value)]
        return x[: -self.num_contexts] if self.num_contexts else x

    def optimize(self, context=None, ucb=False):
        self.update_confidence_intervals(context=context)
        if ucb:
            self.compute_safe_set()
        else:
            self.compute_sets()
        return self.get_new_query_point(ucb=ucb)

    def get_maximum(self, context=None):
        self.update_confidence_intervals(context=context)
        self.compute_safe_set()
        if not np.any(self.S):
            return None
        value = np.where(self.S, self.Q[:, 0], -np.inf)
        idx = np.argmax(value)
        return (self.inputs[idx, : -self.num_contexts or None],
                value[idx])


def ref_penalty(slack):
    """Piecewise slack penalty (reference gp_opt.py:874-899)."""
    slack = np.atleast_1d(np.asarray(slack, dtype=float))
    pen = np.clip(slack, None, 0.0)
    pen[(slack < 0) & (slack > -0.001)] *= 2
    pen[(slack <= -0.001) & (slack > -0.1)] *= 5
    pen[(slack <= -0.1) & (slack > -1)] *= 10
    deep = slack < -1
    pen[deep] = -300 * pen[deep] ** 2
    return pen


def ref_particle_fitness(swarm_type, gps, beta, fmin, scaling,
                         best_lower_bound, particles):
    """NumPy mirror of the reference swarm fitness (gp_opt.py:901-1013)."""
    from scipy.special import expit
    from scipy.stats import norm

    mu, var = gps[0].predict_noiseless(particles)
    mu = mu.squeeze()
    sd = np.sqrt(var.squeeze())
    lower = np.atleast_1d(mu - beta * sd)
    upper = np.atleast_1d(mu + beta * sd)

    if swarm_type == "greedy":
        return lower, np.ones(len(lower), dtype=bool)

    values = sd / scaling[0]
    if swarm_type == "expanders":
        interest = len(gps) * np.ones_like(values)
    elif swarm_type == "maximizers":
        interest = expit(10 * (upper - best_lower_bound) / scaling[0])
    else:
        interest = None

    safe = np.ones(particles.shape[0], dtype=bool)
    penalty = np.zeros(particles.shape[0])
    for i, gp in enumerate(gps):
        if i > 0:
            mu, var = gp.predict_noiseless(particles)
            sd = np.sqrt(var.squeeze())
            lower = mu.squeeze() - beta * sd
            values = np.maximum(values, sd / scaling[i])
        if fmin[i] == -np.inf:
            continue
        slack = np.atleast_1d(lower - fmin[i])
        safe &= slack >= 0
        if swarm_type == "safe_set":
            continue
        slack = slack / scaling[i]
        penalty += ref_penalty(slack)
        if swarm_type == "expanders":
            interest = interest * norm.pdf(slack, scale=0.2)

    if swarm_type == "safe_set":
        return lower, safe
    return (values + penalty) * interest, safe


def ref_pso(fitness, positions, velocities, r_stream, velocity_scale,
            bounds=None, c1=1.0, c2=1.0, initial_inertia=1.0,
            final_inertia=0.1):
    """NumPy PSO loop mirroring the reference (swarm.py:66-146) with an
    injected randomness stream (max_iter, 2, S, d)."""
    positions = np.array(positions, dtype=float)
    velocities = np.array(velocities, dtype=float)
    max_velocity = 10 * velocity_scale
    max_iter = r_stream.shape[0]
    inertia = initial_inertia
    step = (final_inertia - initial_inertia) / max_iter

    values, _ = fitness(positions)
    best_positions = positions.copy()
    best_values = np.array(values, dtype=float)
    global_best = best_positions[np.argmax(values)].copy()

    for it in range(max_iter):
        r1, r2 = r_stream[it, 0], r_stream[it, 1]
        velocities = inertia * velocities + (
            c1 * r1 * (best_positions - positions) +
            c2 * r2 * (global_best - positions)) / velocity_scale
        inertia += step
        velocities = np.clip(velocities, -max_velocity, max_velocity)
        positions = positions + velocities
        if bounds is not None:
            positions = np.clip(positions, bounds[:, 0], bounds[:, 1])
        values, safe = fitness(positions)
        improve = (values > best_values) & safe
        best_values[improve] = values[improve]
        best_positions[improve] = positions[improve]
        global_best = best_positions[np.argmax(best_values)].copy()
    return positions, velocities, best_positions, best_values, global_best


def ref_optimal_velocities(gps, scaling):
    """NumPy mirror of SafeOptSwarm.optimize_particle_velocity
    (reference gp_opt.py:818-872): per GP and dimension, bisect the
    step whose normalized kernel correlation lands in (0.94, 0.95)."""
    d = gps[0].input_dim
    origin = np.zeros((1, d))
    velocities = np.empty((len(gps), d))
    for i, gp in enumerate(gps):
        for j in range(d):
            tmp = np.zeros((1, d))
            upper, lower = 1000.0, 0.0
            while True:
                mid = (upper + lower) / 2
                tmp[0, j] = mid
                cov = gp.kern.K(origin, tmp).squeeze() / scaling[i] ** 2
                not_too_fast = cov < 0.95
                enough = cov > 0.94
                if not_too_fast:
                    upper = mid
                elif enough:
                    lower = mid
                if (not_too_fast and enough) or upper - lower < 1e-5:
                    break
            velocities[i, j] = mid
    return np.min(velocities, axis=0) / np.sqrt(d)


class RefSafeOptSwarm:
    """Sequential float64 SafeOptSwarm orchestration mirror
    (reference gp_opt.py:715-1192) on top of RefGP / ref_pso.

    Independent of the product package: posteriors via RefGP
    (cdist + cho_solve), PSO via ref_pso, fitness via
    ref_particle_fitness. Randomness is injected through
    ``draw_uniform(shape) -> U[0,1) array`` so lockstep parity tests
    can feed the identical streams to the stepwise and fused device
    paths. Index draws map uniforms to ``floor(u * safe_size)``
    (the convention all three implementations share; the reference
    itself uses the unseeded global-RNG ``np.random.randint``,
    gp_opt.py:1067,1080 — no stream to match, SURVEY.md section 3.5).
    """

    def __init__(self, gps, fmin, bounds, beta=2, threshold=0,
                 scaling="auto", swarm_size=20, max_iters=100,
                 draw_uniform=None):
        self.gps = gps if isinstance(gps, list) else [gps]
        self.gp = self.gps[0]
        self.fmin = np.atleast_1d(np.asarray(
            fmin if isinstance(fmin, list) else [fmin] * len(self.gps),
            dtype=float).squeeze())
        self.beta = beta if callable(beta) else (lambda t: beta)
        if isinstance(scaling, str):
            self.scaling = np.sqrt(np.array(
                [gp.kern.Kdiag(np.zeros((1, gp.input_dim)))[0]
                 for gp in self.gps]))
        else:
            self.scaling = np.asarray(scaling, dtype=float)
        self.threshold = threshold
        self.swarm_size = int(swarm_size)
        self.max_iters = int(max_iters)

        d = self.gp.input_dim
        if not isinstance(bounds, list):
            bounds = [bounds] * d
        self.bounds = np.asarray(bounds, dtype=float)

        self.S = np.asarray(self.gp.X, dtype=float).copy()
        self.best_lower_bound = -np.inf
        self.greedy_point = self.S[0, :].copy()
        self.optimal_velocities = ref_optimal_velocities(self.gps,
                                                         self.scaling)
        self._draw = draw_uniform
        self._t = self.gp.X.shape[0]

    @property
    def t(self):
        return self._t

    def add_new_data_point(self, x, y):
        x = np.atleast_2d(np.asarray(x, dtype=float))
        y = np.atleast_2d(np.asarray(y, dtype=float))
        for i, gp in enumerate(self.gps):
            keep = ~np.isnan(y[:, i])
            if np.any(keep):
                gp.set_XY(np.vstack([gp.X, x[keep]]),
                          np.vstack([gp.Y, y[keep][:, [i]]]))
        self._t += x.shape[0]

    def get_new_query_point(self, swarm_type):
        """Mirror of reference gp_opt.py:1015-1134."""
        beta = self.beta(self.t)

        # 1. re-validate / prune the stored safe set (1044-1062)
        _, safe = ref_particle_fitness("safe_set", self.gps, beta,
                                       self.fmin, self.scaling,
                                       self.best_lower_bound, self.S)
        num_safe = safe.sum()
        if num_safe == 0:
            raise RuntimeError("The safe set is empty.")
        if num_safe >= self.swarm_size and num_safe != len(safe):
            self.S = self.S[safe]
        safe_size = self.S.shape[0]

        # 2. init particles (1064-1081)
        if swarm_type == "greedy":
            n_random = self.swarm_size - 3
        else:
            n_random = self.swarm_size
        u = np.asarray(self._draw((n_random,)))
        random_id = np.minimum((u * safe_size).astype(int), safe_size - 1)
        particles = self.S[random_id, :]
        if swarm_type == "greedy":
            X = np.asarray(self.gp.X, dtype=float)
            best_sampled = int(np.argmax(np.asarray(self.gp.Y)[:, 0]))
            particles = np.vstack((particles, self.greedy_point,
                                   X[-1, :], X[best_sampled, :]))

        # 3. run the swarm (1084-1086; swarm.py:66-146)
        d = self.gp.input_dim
        u_vel = np.asarray(self._draw((self.swarm_size, d)))
        velocities = u_vel * self.optimal_velocities
        r_stream = np.asarray(
            self._draw((self.max_iters, 2, self.swarm_size, d)))

        def fitness(p):
            return ref_particle_fitness(swarm_type, self.gps, beta,
                                        self.fmin, self.scaling,
                                        self.best_lower_bound, p)

        _, _, best_positions, best_values, global_best = ref_pso(
            fitness, particles, velocities, r_stream,
            self.optimal_velocities, self.bounds)

        if swarm_type != "greedy":
            # 4. covariance-dedup safe-set growth (1089-1114)
            covariance = self.gp.kern.K(
                best_positions, np.vstack((self.S, best_positions)))
            covariance = covariance / self.scaling[0] ** 2
            initial_safe = len(self.S)
            n, m = covariance.shape
            mask = np.zeros(m, dtype=bool)
            mask[:initial_safe] = True
            for j in range(n):
                if np.all(covariance[j, mask] <= 0.95):
                    self.S = np.vstack((self.S, best_positions[[j], :]))
                    mask[initial_safe + j] = True
        else:
            # 4'. move the greedy estimate on improvement (1116-1123)
            mean, var = self.gp.predict_noiseless(
                self.greedy_point[None, :])
            lower_bound = float(mean.squeeze()
                                - beta * np.sqrt(var.squeeze()))
            if lower_bound < np.max(best_values):
                self.greedy_point = global_best.copy()

        if swarm_type == "greedy":
            return global_best.copy(), np.max(best_values)

        var = np.empty(len(self.gps))
        for i, gp in enumerate(self.gps):
            var[i] = float(np.asarray(
                gp.predict_noiseless(global_best[None, :])[1]).squeeze())
        return global_best, np.sqrt(var)

    def optimize(self, ucb=False):
        """Mirror of reference gp_opt.py:1136-1177."""
        self.greedy, self.best_lower_bound = self.get_new_query_point(
            "greedy")
        x_maxi, std_maxi = self.get_new_query_point("maximizers")
        if ucb:
            return x_maxi
        x_exp, std_exp = self.get_new_query_point("expanders")

        std_exp = std_exp.copy()
        std_exp[(std_exp < self.threshold) | (self.fmin == -np.inf)] = 0
        std_exp = std_exp / self.scaling
        std_exp = np.max(std_exp)
        std_maxi = std_maxi[0] / self.scaling[0]

        if std_maxi > std_exp:
            return x_maxi
        return x_exp

    def get_maximum(self):
        Y = np.asarray(self.gp.Y)
        maxi = int(np.argmax(Y[:, 0]))
        return np.asarray(self.gp.X)[maxi, :], Y[maxi]
