"""SafeOptSwarm: scalable safe Bayesian optimization via particle swarms.

Accelerator-native re-implementation of the reference swarm variant
(/root/reference/safeopt/gp_opt.py:715-1192, Duivenvoorden et al. 2017).
No grid: the safe set is an explicit, growing set of points, and three
constrained particle swarms (greedy / maximizers / expanders) search the
continuous domain.

Accelerator-first redesign of the hot path: the reference runs 3 swarms x 101
Python-level fitness evaluations per ``optimize()`` (~300+ GPy posterior
calls, SURVEY.md section 3.3). Here each swarm run — PSO dynamics plus
the multi-GP posterior fitness — is ONE fused ``lax.scan`` program
(``swarm_core.swarm_scan`` with the fitness inlined), and by default
the ENTIRE ``optimize()`` — all three swarms plus safe-set maintenance
— is a single device program (swarm_opt_fused.py): one dispatch, one
result pull. ``optimize(fused=False)`` keeps the stepwise
reference-shaped orchestration.

Semantics preserved from the reference:
- particle fitness per swarm type (gp_opt.py:901-1013): greedy = lower
  bound; maximizers/expanders = max scaled posterior std across GPs,
  plus piecewise slack penalties (gp_opt.py:874-899); expander interest
  = num_gps * prod_i N(slack_i; 0, 0.2) (prefers constraint
  boundaries); maximizer interest = sigmoid(10 * (u - best_lower_bound)
  / scaling[0]);
- safe-set pruning never below swarm_size, with a warning
  (gp_opt.py:1051-1062); empty safe set raises RuntimeError
  (gp_opt.py:1045-1049);
- safe-set growth: accept a swarm's best positions whose normalized
  kernel covariance to all previously accepted points is <= 0.95,
  sequential greedy dedup (gp_opt.py:1089-1114);
- optimal particle velocities by bisecting the kernel correlation into
  (0.94, 0.95), min across GPs, / sqrt(input_dim)
  (gp_opt.py:818-872, stationary kernels only);
- final maximizer-vs-expander choice by larger max scaled std with the
  threshold / -inf zeroing (gp_opt.py:1161-1177).
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import default_dtype, with_matmul_precision
from ..gp.regression import gp_predict
from .base import GaussianProcessOptimization
from .swarm import SwarmOptimization
from .swarm_core import swarm_scan

__all__ = ["SafeOptSwarm", "PendingSwarmIteration"]


@jax.jit
def _chain_pack(head, diag):
    """Assemble the fused pack buffer [beta, blb, last_x, best_x,
    greedy] from a host-built head [beta, _, last_x, best_x] and the
    still-in-flight previous iteration's diag (device slices 5d = best
    lower bound, 4d:5d = greedy point) — no device->host pull."""
    d = (head.shape[0] - 2) // 2
    return jnp.concatenate([head[:1], diag[5 * d:5 * d + 1], head[2:],
                            diag[4 * d:5 * d]])


class PendingSwarmIteration:
    """Handle for an in-flight fused iteration (``optimize_async``).

    ``result()`` blocks on the single diagnostics pull, commits the
    host-side state exactly like the blocking ``optimize()``, and
    returns the next query point. Idempotent. Finalize pendings in
    dispatch order; the reference's empty-safe-set RuntimeError
    (gp_opt.py:1049) surfaces here.
    """

    def __init__(self, opt, out, ucb: bool):
        self._opt, self._out, self._ucb = opt, out, ucb
        self._x = None
        self._done = False
        # start the device->host copy of the diagnostics as soon as
        # the program produces them, so result()'s pull overlaps the
        # NEXT iteration's compute instead of paying the round trip
        # synchronously (no-op where unsupported)
        try:
            out.diag.copy_to_host_async()
        except (AttributeError, RuntimeError):  # pragma: no cover
            pass

    def result(self) -> np.ndarray:
        """Block on the diagnostics pull, commit host state, and
        return the next query point (idempotent)."""
        if not self._done:
            self._x = self._opt._commit_fused(self._out, ucb=self._ucb)
            self._done = True
        return self._x

_SWARM_TYPES = ("greedy", "maximizers", "expanders")


# ---------------------------------------------------------------------------
# fused fitness + swarm runs (pure, jitted)
# ---------------------------------------------------------------------------

def _penalty(slack: jnp.ndarray) -> jnp.ndarray:
    """Piecewise slack penalty (reference gp_opt.py:874-899).

    Nonzero only for violated constraints; steeper the deeper the
    violation (x2 / x5 / x10 bands, then -300*slack^2).
    """
    pen = jnp.clip(slack, None, 0.0)
    pen = jnp.where((slack < 0) & (slack > -0.001), pen * 2, pen)
    pen = jnp.where((slack <= -0.001) & (slack > -0.1), pen * 5, pen)
    pen = jnp.where((slack <= -0.1) & (slack > -1), pen * 10, pen)
    pen = jnp.where(slack < -1, -300.0 * pen * pen, pen)
    return pen


def _norm_pdf(x: jnp.ndarray, scale: float) -> jnp.ndarray:
    inv = 1.0 / (scale * jnp.sqrt(2.0 * jnp.pi))
    return inv * jnp.exp(-0.5 * (x / scale) ** 2)


def _particle_fitness(swarm_type: str, kernels, states, beta, fmin, scaling,
                      best_lower_bound, particles):
    """Multi-GP swarm fitness (reference gp_opt.py:901-1013), traceable.

    Returns (values, safe_mask). ``swarm_type`` is trace-static.
    """
    num_gps = len(kernels)
    mu, var = gp_predict(kernels[0], states[0], particles)
    std = jnp.sqrt(var)
    lower = mu - beta * std
    upper = mu + beta * std

    if swarm_type == "greedy":
        return lower, jnp.ones(particles.shape[0], dtype=bool)

    values = std / scaling[0]
    if swarm_type == "expanders":
        interest = float(num_gps) * jnp.ones_like(values)
    elif swarm_type == "maximizers":
        improvement = upper - best_lower_bound
        interest = jax.nn.sigmoid(10.0 * improvement / scaling[0])
    elif swarm_type == "safe_set":
        interest = None
    else:
        raise AssertionError("Invalid swarm type")

    safe = jnp.ones(particles.shape[0], dtype=bool)
    total_penalty = jnp.zeros_like(values)

    for i in range(num_gps):
        if i > 0:
            mu, var = gp_predict(kernels[i], states[i], particles)
            std = jnp.sqrt(var)
            lower = mu - beta * std
            values = jnp.maximum(values, std / scaling[i])

        constrained = fmin[i] > -jnp.inf
        slack = lower - fmin[i]                      # +inf when -inf fmin
        safe &= jnp.where(constrained, slack >= 0, True)

        if swarm_type == "safe_set":
            continue

        slack_n = slack / scaling[i]
        total_penalty += jnp.where(constrained, _penalty(slack_n), 0.0)
        if swarm_type == "expanders":
            interest = interest * jnp.where(constrained,
                                            _norm_pdf(slack_n, 0.2), 1.0)

    if swarm_type == "safe_set":
        return lower, safe

    return (values + total_penalty) * interest, safe


@partial(jax.jit, static_argnames=("swarm_type",))
@with_matmul_precision
def _run_swarm_fused(kernels, states, particles, velocities, r_stream,
                     velocity_scale, bounds, beta, fmin, scaling,
                     best_lower_bound, *, swarm_type: str):
    """One complete PSO run with the GP fitness fused into the scan."""
    fitness = partial(_particle_fitness, swarm_type, kernels, states, beta,
                      fmin, scaling, best_lower_bound)
    return swarm_scan(fitness, particles, velocities, r_stream,
                      velocity_scale, bounds)


@jax.jit
@with_matmul_precision
def _safe_set_check(kernels, states, points, n_valid, beta, fmin, scaling):
    """Safety mask of the stored safe-set points (gp_opt.py:1045).

    ``points`` is a shape-bucketed padded buffer (the safe set grows
    every iteration; without bucketing each growth step would trigger
    a fresh compile); rows at index >= n_valid report unsafe.
    """
    _, safe = _particle_fitness("safe_set", kernels, states, beta, fmin,
                                scaling, jnp.asarray(0.0), points)
    return safe & (jnp.arange(points.shape[0]) < n_valid)


@jax.jit
@with_matmul_precision
def _dedup_covariance(kernel, candidates, existing, scaling0):
    """Normalized covariance of candidates vs [existing; candidates].

    Used by the safe-set growth dedup (gp_opt.py:1092-1096).
    """
    stacked = jnp.concatenate([existing, candidates], axis=0)
    return kernel.K(candidates, stacked) / (scaling0 ** 2)


def _bisect_velocity_impl(kernel, scaling_i, d, dtype, num_iters=40):
    """Per-dimension optimal velocity by kernel-correlation bisection.

    Vectorized over dimensions (one ``kern.K(0, diag(mid))`` evaluates
    every axis step at once); replicates the reference's termination
    rule — stop when correlation lands in (0.94, 0.95) or the bracket
    width drops below 1e-5, keeping the midpoint of the final iteration
    (gp_opt.py:843-861).
    """
    zero = jnp.zeros((1, d), dtype=dtype)

    def body(carry, _):
        lower, upper, mid, done = carry
        new_mid = (upper + lower) / 2.0
        mid = jnp.where(done, mid, new_mid)
        cov = kernel.K(zero, jnp.diag(mid))[0] / (scaling_i ** 2)
        not_too_fast = cov < 0.95
        enough = cov > 0.94
        upper = jnp.where(~done & not_too_fast, mid, upper)
        lower = jnp.where(~done & ~not_too_fast & enough, mid, lower)
        done = done | (not_too_fast & enough) | (upper - lower < 1e-5)
        return (lower, upper, mid, done), None

    init = (jnp.zeros(d, dtype), jnp.full((d,), 1000.0, dtype),
            jnp.zeros(d, dtype), jnp.zeros(d, bool))
    carry, _ = jax.lax.scan(body, init, None, length=num_iters)
    return carry[2]


_bisect_velocity_jit = jax.jit(with_matmul_precision(_bisect_velocity_impl),
                               static_argnames=("d", "dtype", "num_iters"))


@jax.jit
@with_matmul_precision
def _predict_stack(kernels, states, x):
    """Per-GP posterior (mu, var) at a single point, stacked."""
    mus, vars_ = [], []
    for kern, st in zip(kernels, states):
        mu, var = gp_predict(kern, st, x)
        mus.append(mu[0])
        vars_.append(var[0])
    return jnp.stack(mus), jnp.stack(vars_)


# ---------------------------------------------------------------------------
# public class
# ---------------------------------------------------------------------------

class SafeOptSwarm(GaussianProcessOptimization):
    """Safe Bayesian optimization for high-dimensional problems.

    Swarm-based variant: instead of classifying a discrete grid, three
    particle swarms search for the greedy estimate, potential
    maximizers, and potential expanders; the safe set is an explicit
    growing set of points. Supports neither Lipschitz constants nor
    contexts (like the reference, gp_opt.py:717-719).

    Parameters
    ----------
    gp : GPRegression or list
        Objective first, then safety-constraint GPs.
    fmin : float or list of floats
        Safety thresholds (``-inf`` = unconstrained).
    bounds : pair or list of pairs
        Domain box (per dimension, or one pair broadcast to all).
    beta : float or callable
    scaling : 'auto' or list of floats
    threshold : float or list of floats
    swarm_size : int
        Particles per swarm (default 20).
    key : jax PRNG key, optional
        Randomness source; the reference uses the unseeded global NumPy
        RNG (SURVEY.md section 3.5), explicit keys are a new capability.

    Examples
    --------
    >>> import numpy as np
    >>> from safeopt_tpu import SafeOptSwarm
    >>> from safeopt_tpu.gp import GPRegression
    >>> gp = GPRegression(np.array([[0.]]), np.array([[1.]]),
    ...                   noise_var=0.01 ** 2)
    >>> opt = SafeOptSwarm(gp, fmin=[0.], bounds=[[-1., 1.]])
    >>> next_parameters = opt.optimize()
    >>> performance = np.array([[1.]])
    >>> opt.add_new_data_point(next_parameters, performance)
    """

    def __init__(self, gp, fmin, bounds, beta=2, scaling="auto", threshold=0,
                 swarm_size: int = 20, key: Optional[jax.Array] = None,
                 max_iters: int = 100):
        super().__init__(gp, fmin=fmin, beta=beta, num_contexts=0,
                         threshold=threshold, scaling=scaling)

        # Safe set: explicit points, seeded with the objective's data.
        # Backed by a device-resident buffer in fused mode (the host
        # mirror materializes lazily; see the ``S`` property).
        self._S_host = None
        self._S_dev = None          # SwarmIterState or None
        self._count = 0
        self._count_ub = 0          # worst-case count while pipelining
        self._dev_consts = None
        self.S = np.asarray(self.gp.X_host, dtype=float).copy()

        self.swarm_size = int(swarm_size)
        self.max_iters = int(max_iters)   # swarm iterations per run

        if not isinstance(bounds, list):
            self.bounds = [bounds] * self.S.shape[1]
        else:
            self.bounds = bounds
        self._bounds_arr = np.asarray(self.bounds, dtype=float)

        self.best_lower_bound = -np.inf
        self.greedy_point = self.S[0, :].copy()

        self._key = key if key is not None else jax.random.key(0)
        self.optimal_velocities = self.optimize_particle_velocity()

        # Public swarm objects for API parity / custom use; the hot path
        # runs through the fused scan, not these.
        self.swarms = {
            swarm_type: SwarmOptimization(
                self.swarm_size, self.optimal_velocities,
                partial(self._compute_particle_fitness, swarm_type),
                bounds=self.bounds)
            for swarm_type in _SWARM_TYPES}

    # -- safe-set storage (device-resident in fused mode) ---------------------

    @property
    def S(self) -> np.ndarray:
        """Current safe-set points (host view).

        In fused mode the canonical buffer lives on the device between
        iterations; the host mirror is pulled lazily on first access
        (a pull is a full device round trip, so ``_optimize_fused``
        never touches this property).
        """
        if self._S_host is None:
            buf = np.asarray(jax.device_get(self._S_dev.S))
            self._S_host = np.asarray(buf[: self._count], dtype=float)
        return self._S_host

    @S.setter
    def S(self, value) -> None:
        self._S_host = np.asarray(value, dtype=float)
        self._count = self._S_host.shape[0]
        self._S_dev = None          # host now canonical

    # -- plumbing -------------------------------------------------------------

    @staticmethod
    def _host_device():
        """CPU device for RNG generation.

        PRNG splits/draws are tiny; issuing them on the accelerator
        costs one dispatch round-trip each (~40 per optimize()). Keys
        live on
        the host CPU backend; the streams ship to the accelerator as
        inputs of the fused swarm call.
        """
        try:
            return jax.devices("cpu")[0]
        except RuntimeError:
            return None

    def _split(self) -> jax.Array:
        dev = self._host_device()
        if dev is not None:
            with jax.default_device(dev):
                self._key, sub = jax.random.split(self._key)
        else:
            self._key, sub = jax.random.split(self._key)
        return sub

    def _draw_uniform(self, shape) -> np.ndarray:
        """U[0,1) host draw — the single gate for stepwise randomness.

        Every stochastic choice of the stepwise path (particle-init
        indices, initial velocities, the PSO r1/r2 stream) flows
        through here, in a fixed per-swarm order (idx, vel, r), so
        lockstep parity tests can override it with recorded streams
        shared with ``RefSafeOptSwarm`` and the fused program. The
        reference's equivalent is the unseeded global NumPy RNG
        (SURVEY.md section 3.5).
        """
        dev = self._host_device()
        if dev is not None:
            with jax.default_device(dev):
                return np.asarray(jax.random.uniform(
                    self._split(), shape, dtype=default_dtype()))
        return np.asarray(jax.random.uniform(self._split(), shape,
                                             dtype=default_dtype()))

    def _model_args(self):
        return (tuple(g.kern for g in self.gps),
                tuple(g.state for g in self.gps))

    def _common_scalars(self):
        dtype = default_dtype()
        return (jnp.asarray(self.beta(self.t), dtype),
                jnp.asarray(self.fmin, dtype),
                jnp.asarray(self.scaling, dtype))

    # -- reference API -------------------------------------------------------

    def optimize_particle_velocity(self) -> np.ndarray:
        """Optimal per-dimension particle velocities.

        Bisects each kernel's correlation length so one velocity step
        keeps ~0.94-0.95 correlation; min across GPs, scaled by
        1/sqrt(input_dim) (reference gp_opt.py:818-872). Only sensible
        for stationary kernels.
        """
        dtype = default_dtype()
        d = self.gp.input_dim
        per_gp = []
        for g, scale in zip(self.gps, self.scaling):
            vel = _bisect_velocity_jit(g.kern, jnp.asarray(scale, dtype),
                                       d=d, dtype=dtype)
            per_gp.append(np.asarray(vel))
        velocities = np.min(np.stack(per_gp), axis=0)
        return velocities / np.sqrt(d)

    def _compute_particle_fitness(self, swarm_type: str, particles):
        """Swarm fitness of a particle batch (traceable; public for the
        ``swarms`` objects)."""
        kernels, states = self._model_args()
        beta, fmin, scaling = self._common_scalars()
        return _particle_fitness(swarm_type, kernels, states, beta, fmin,
                                 scaling,
                                 jnp.asarray(self.best_lower_bound),
                                 jnp.atleast_2d(particles))

    @staticmethod
    def _padded(arr: np.ndarray, bucket: int = 128) -> np.ndarray:
        """Pad rows up to the next bucket multiple (stable jit shapes)."""
        n = arr.shape[0]
        pad = (-n) % bucket
        if pad == 0:
            return arr
        return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])

    def _validate_safe_set(self) -> None:
        """Re-check stored safe points; prune model violations.

        Never prunes below swarm_size (reference gp_opt.py:1051-1062);
        raises RuntimeError when nothing is safe.
        """
        kernels, states = self._model_args()
        beta, fmin, scaling = self._common_scalars()
        padded = self._padded(self.S)
        safe = np.asarray(_safe_set_check(
            kernels, states, jnp.asarray(padded, default_dtype()),
            jnp.asarray(self.S.shape[0], jnp.int32), beta,
            fmin, scaling))[: self.S.shape[0]]
        num_safe = int(safe.sum())
        if num_safe == 0:
            raise RuntimeError("The safe set is empty.")
        if num_safe >= self.swarm_size and num_safe != len(safe):
            logging.warning(
                "Warning: %d unsafe points removed. Model might be violated",
                int(np.count_nonzero(~safe)))
            self.S = self.S[safe]

    def _init_particles(self, swarm_type: str) -> np.ndarray:
        """Seed particles uniformly from the safe set.

        The greedy swarm swaps its last three particles for the previous
        greedy estimate, the most recent observation, and the best
        observation (reference gp_opt.py:1064-1081).
        """
        safe_size = self.S.shape[0]
        if swarm_type == "greedy":
            n_random = self.swarm_size - 3
        else:
            n_random = self.swarm_size
        # floor(u * size): the index convention shared with the fused
        # program and RefSafeOptSwarm so identical uniform streams give
        # identical particle seeds on all three paths.
        u = self._draw_uniform((n_random,))
        random_id = np.minimum((u * safe_size).astype(int), safe_size - 1)
        particles = self.S[random_id, :]
        if swarm_type == "greedy":
            X = np.asarray(self.gp.X_host, dtype=float)
            Y = np.asarray(self.gp.Y_host, dtype=float)
            best_sampled = int(np.argmax(Y[:, 0]))
            particles = np.vstack((particles, self.greedy_point,
                                   X[-1, :], X[best_sampled, :]))
        return particles

    def _grow_safe_set(self, best_positions: np.ndarray) -> None:
        """Greedy covariance dedup growth (reference gp_opt.py:1089-1114).

        A swarm best is added if its normalized covariance to every
        previously accepted safe point (including those just added) is
        at most 0.95.
        """
        dtype = default_dtype()
        padded = self._padded(self.S)
        cov_p = np.asarray(_dedup_covariance(
            self.gp.kern, jnp.asarray(best_positions, dtype),
            jnp.asarray(padded, dtype),
            jnp.asarray(self.scaling[0], dtype)))
        # drop padded columns: layout is [S_padded | best_positions]
        cov = np.concatenate([cov_p[:, : len(self.S)],
                              cov_p[:, len(padded):]], axis=1)

        initial_safe = len(self.S)
        m = cov.shape[1]
        mask = np.zeros(m, dtype=bool)
        mask[:initial_safe] = True

        accepted = []
        for j in range(best_positions.shape[0]):
            if np.all(cov[j, mask] <= 0.95):
                accepted.append(best_positions[j])
                mask[initial_safe + j] = True
        if accepted:
            self.S = np.vstack([self.S] + [a[None, :] for a in accepted])
        logging.debug("%d points were appended to the safeset",
                      len(accepted))

    def get_new_query_point(self, swarm_type: str):
        """Run one swarm and return its best point.

        Returns ``(x, max_best_value)`` for the greedy swarm, else
        ``(x, per-GP posterior std at x)`` (reference
        gp_opt.py:1015-1134).
        """
        if swarm_type not in _SWARM_TYPES:
            raise ValueError(f"unknown swarm type: {swarm_type!r}")
        dtype = default_dtype()
        kernels, states = self._model_args()
        beta, fmin, scaling = self._common_scalars()

        self._validate_safe_set()
        particles = jnp.asarray(self._init_particles(swarm_type), dtype)

        d = self.gp.input_dim
        u = jnp.asarray(self._draw_uniform((self.swarm_size, d)), dtype)
        velocities = u * jnp.asarray(self.optimal_velocities, dtype)
        r_stream = jnp.asarray(
            self._draw_uniform((self.max_iters, 2, self.swarm_size, d)),
            dtype)

        result = _run_swarm_fused(
            kernels, states, particles, velocities, r_stream,
            jnp.asarray(self.optimal_velocities, dtype),
            jnp.asarray(self._bounds_arr, dtype), beta, fmin, scaling,
            jnp.asarray(self.best_lower_bound, dtype),
            swarm_type=swarm_type)

        global_best = np.asarray(result.global_best)

        if swarm_type != "greedy":
            self._grow_safe_set(np.asarray(result.best_positions))
            mus, vars_ = _predict_stack(kernels, states,
                                        jnp.asarray(global_best[None, :],
                                                    dtype))
            return global_best, np.sqrt(np.asarray(vars_))

        # Greedy: move the running estimate if the swarm beat it.
        mu, var = gp_predict(kernels[0], states[0],
                             jnp.asarray(self.greedy_point[None, :], dtype))
        lower_bound = float(mu[0] - beta * jnp.sqrt(var[0]))
        best_val = float(jnp.max(result.best_values))
        if lower_bound < best_val:
            self.greedy_point = global_best.copy()
        return global_best.copy(), best_val

    def optimize(self, ucb: bool = False, fused: Optional[bool] = None
                 ) -> np.ndarray:
        """One SafeOptSwarm iteration: run the three swarms and pick the
        maximizer or expander with the larger scaled uncertainty
        (reference gp_opt.py:1136-1177).

        ``fused=True`` (the default) executes the entire iteration as a
        single device program (one dispatch + one result pull);
        ``fused=False`` uses the
        stepwise ``get_new_query_point`` path, which mirrors the
        reference's host orchestration call-for-call.
        """
        if fused is None:
            fused = True
        if fused:
            return self._optimize_fused(ucb=ucb)
        self.greedy, self.best_lower_bound = self.get_new_query_point(
            "greedy")

        x_maxi, std_maxi = self.get_new_query_point("maximizers")
        if ucb:
            logging.info("Using ucb criterion.")
            return x_maxi

        x_exp, std_exp = self.get_new_query_point("expanders")

        std_exp = std_exp.copy()
        std_exp[(std_exp < self.threshold) | (self.fmin == -np.inf)] = 0
        std_exp = np.max(std_exp / self.scaling)
        std_maxi = float(std_maxi[0]) / self.scaling[0]

        logging.info("The best maximizer has std. dev. %f", std_maxi)
        logging.info("The best expander has std. dev. %f", std_exp)
        logging.info("The greedy estimate of lower bound has value %f",
                     self.best_lower_bound)

        if std_maxi > std_exp:
            return x_maxi
        return x_exp

    def _fused_streams(self, ucb: bool = False):
        """Uniform streams for the fused program, or None.

        Default None: the fused program draws its randomness on device
        from the split key. Parity tests override this to inject the
        streams shared with the stepwise path and ``RefSafeOptSwarm``
        (dict keys ``{greedy,maximizers,expanders}_{idx,vel,r}``).
        """
        return None

    def _device_consts(self) -> dict:
        """Iteration-invariant operands, shipped to the device ONCE.

        Each host->device transfer is a blocking round trip;
        re-shipping these every iteration would add one per operand.
        """
        if self._dev_consts is None:
            dtype = default_dtype()
            self._dev_consts = dict(
                vel=jnp.asarray(self.optimal_velocities, dtype),
                bounds=jnp.asarray(self._bounds_arr, dtype),
                fmin=jnp.asarray(self.fmin, dtype),
                scaling=jnp.asarray(self.scaling, dtype),
                threshold=jnp.asarray(
                    np.broadcast_to(np.asarray(self.threshold, dtype=float),
                                    (len(self.gps),)), dtype))
        return self._dev_consts

    def _fused_args(self, ucb: bool = False):
        """Assemble the operands of one fused iteration.

        Steady state ships exactly TWO fresh buffers — the PRNG key and
        one packed scalar vector [beta, best_lower_bound, last_x,
        best_x, greedy] — because the safe-set buffer stays
        device-resident between iterations and everything else is
        cached by ``_device_consts``. Split out of ``_optimize_fused``
        so benchmarks can re-dispatch the compiled program on fixed
        operands to measure device compute alone.
        """
        from .swarm_opt_fused import SwarmIterState

        dtype = default_dtype()
        kernels, states = self._model_args()
        consts = self._device_consts()

        need = self._count + 2 * self.swarm_size + 8
        if self._S_dev is not None and self._S_dev.S.shape[0] >= need:
            dev_state = self._S_dev
        else:
            # (re)build the padded buffer with growth headroom
            cap = ((need + 127) // 128) * 128
            S_host = self.S
            S_buf = np.zeros((cap, S_host.shape[1]))
            S_buf[: S_host.shape[0]] = S_host
            dev_state = SwarmIterState(
                S=jnp.asarray(S_buf, dtype),
                count=jnp.asarray(S_host.shape[0], jnp.int32),
                greedy=jnp.asarray(self.greedy_point, dtype))

        # greedy specials from the host data store: most recent and
        # best observations (device GP state may be a sparse
        # pseudo-factor whose X/Y are not the observations)
        Xh = np.asarray(self.gp.X_host, dtype=float)
        Yh = np.asarray(self.gp.Y_host, dtype=float)
        d = Xh.shape[1]
        pack = np.empty(2 + 3 * d)
        pack[0] = float(self.beta(self.t))
        pack[1] = self.best_lower_bound
        pack[2:2 + d] = Xh[-1]
        pack[2 + d:2 + 2 * d] = Xh[int(np.argmax(Yh[:, 0]))]
        pack[2 + 2 * d:] = self.greedy_point

        # raw key data: a committed CPU key would block the dispatch on
        # a synchronous transfer (see fused_swarm_optimize)
        key_raw = np.asarray(jax.random.key_data(self._split()))

        args = (kernels, states, dev_state, key_raw,
                consts["vel"], consts["bounds"], consts["fmin"],
                consts["scaling"], consts["threshold"],
                jnp.asarray(pack, dtype), self._fused_streams(ucb=ucb))
        kwargs = dict(swarm_size=self.swarm_size, max_iters=self.max_iters,
                      ucb=ucb)
        return args, kwargs

    def _fused_args_after(self, out_prev, ucb: bool = False):
        """Operands of one fused iteration CHAINED on a still-in-flight
        previous iteration — nothing here blocks on a device->host
        pull.

        The three values the unchained path takes from the previous
        iteration's *committed host mirrors* (the safe-set buffer, the
        best lower bound, the greedy point) are taken directly from the
        previous ``SwarmIterOut``'s device arrays instead: the state
        rides ``out_prev.state`` and the two pack scalars are sliced
        out of ``out_prev.diag`` on device (``_chain_pack``), which is
        exactly what ``_commit_fused`` would have written back (diag
        slices 5d and 4d:5d). Everything else — the PRNG key split, the
        GP states, beta(t), the last/best observations — comes from the
        host exactly as in ``_fused_args``, so a lag-aware caller
        (pipeline.py) that adds observations in the same order gets a
        BITWISE-identical trajectory to the blocking loop; pinned by
        tests/test_pipeline.py.

        Capacity is governed by a host-side upper bound (growth is at
        most ``2 * swarm_size`` rows per iteration) because the true
        count is still in flight; ``reserve()`` sizes the buffer for a
        whole pipelined campaign up front.
        """
        dtype = default_dtype()
        kernels, states = self._model_args()
        consts = self._device_consts()
        d = self.gp.input_dim

        self._count_ub += 2 * self.swarm_size
        need = self._count_ub + 2 * self.swarm_size + 8
        if out_prev.state.S.shape[0] < need:
            raise RuntimeError(
                "pipelined dispatch may exceed the device safe-set "
                f"buffer (capacity {out_prev.state.S.shape[0]}, worst-"
                f"case need {need}); call reserve(n_iterations) before "
                "pipelining")

        Xh = np.asarray(self.gp.X_host, dtype=float)
        Yh = np.asarray(self.gp.Y_host, dtype=float)
        head = np.empty(2 + 2 * d)
        head[0] = float(self.beta(self.t))
        head[1] = 0.0                       # blb: filled from diag
        head[2:2 + d] = Xh[-1]
        head[2 + d:] = Xh[int(np.argmax(Yh[:, 0]))]
        pack = _chain_pack(jnp.asarray(head, dtype), out_prev.diag)

        key_raw = np.asarray(jax.random.key_data(self._split()))
        args = (kernels, states, out_prev.state, key_raw,
                consts["vel"], consts["bounds"], consts["fmin"],
                consts["scaling"], consts["threshold"], pack,
                self._fused_streams(ucb=ucb))
        kwargs = dict(swarm_size=self.swarm_size, max_iters=self.max_iters,
                      ucb=ucb)
        return args, kwargs

    def reserve(self, iterations: int) -> None:
        """Pre-grow the device safe-set buffer for ``iterations``
        worst-case growth steps so a pipelined campaign never needs a
        mid-flight rebuild (a rebuild requires pulling the buffer to
        the host, which is exactly what pipelining avoids)."""
        from .swarm_opt_fused import SwarmIterState

        dtype = default_dtype()
        need = (self._count + (int(iterations) + 2) * 2 * self.swarm_size
                + 8)
        if self._S_dev is not None and self._S_dev.S.shape[0] >= need:
            return
        cap = ((need + 127) // 128) * 128
        S_host = self.S                     # pulls if device-canonical
        S_buf = np.zeros((cap, S_host.shape[1]))
        S_buf[: S_host.shape[0]] = S_host
        self._S_dev = SwarmIterState(
            S=jnp.asarray(S_buf, dtype),
            count=jnp.asarray(S_host.shape[0], jnp.int32),
            greedy=jnp.asarray(self.greedy_point, dtype))
        self._S_host = None                 # device canonical again

    def optimize_async(self, ucb: bool = False, after=None):
        """Dispatch one fused iteration WITHOUT waiting for its result.

        Returns a :class:`PendingSwarmIteration`; calling ``.result()``
        pulls the diagnostics and commits host state (the tail of the
        blocking ``optimize()``). With ``after=<previous pending>`` the
        dispatch chains on the in-flight iteration's device state
        (``_fused_args_after``) so the device starts computing
        iteration t+1 while the host is still waiting on iteration t's
        pull — the result-pull overlap the pipelined campaign
        runner (``algorithms/pipeline.py``) is built on. Finalize
        pendings in dispatch order; an empty-safe-set RuntimeError
        surfaces at ``result()`` of the failing iteration.
        """
        from .swarm_opt_fused import fused_swarm_optimize

        if after is None:
            self._count_ub = self._count
            args, kwargs = self._fused_args(ucb=ucb)
        else:
            args, kwargs = self._fused_args_after(after._out, ucb=ucb)
        out = fused_swarm_optimize(*args, **kwargs)
        return PendingSwarmIteration(self, out, ucb)

    def _optimize_fused(self, ucb: bool = False) -> np.ndarray:
        """Single-dispatch iteration (swarm_opt_fused.py).

        One dispatch, one pull: all host-needed outputs come back in
        the single packed ``diag`` buffer; the grown safe set stays on
        the device for the next iteration.
        """
        from .swarm_opt_fused import fused_swarm_optimize

        args, kwargs = self._fused_args(ucb=ucb)
        out = fused_swarm_optimize(*args, **kwargs)
        return self._commit_fused(out, ucb=ucb)

    def _commit_fused(self, out, ucb: bool = False) -> np.ndarray:
        """Pull a fused iteration's diagnostics and commit host state."""
        d = self.gp.input_dim
        diag = np.asarray(jax.device_get(out.diag), dtype=float)
        x_next = diag[0:d]
        x_maxi = diag[d:2 * d]
        x_greedy = diag[3 * d:4 * d]
        greedy_point = diag[4 * d:5 * d]
        blb, std_maxi, std_exp = diag[5 * d:5 * d + 3]
        num_safe = diag[5 * d + 3:5 * d + 6]
        num_pruned = diag[5 * d + 6:5 * d + 9]
        count = int(diag[5 * d + 11])

        if (num_safe == 0).any():
            # do not commit the device state: the stored safe set must
            # survive an aborted iteration (reference gp_opt.py:1049)
            raise RuntimeError("The safe set is empty.")
        for pruned in num_pruned:
            if pruned > 0:
                logging.warning(
                    "Warning: %d unsafe points removed. "
                    "Model might be violated", int(pruned))

        self._S_dev = out.state            # device stays canonical
        self._S_host = None
        self._count = count
        self._count_ub = count
        self.greedy_point = greedy_point
        self.greedy = np.asarray(x_greedy, dtype=float)
        self.best_lower_bound = float(blb)

        if ucb:
            logging.info("Using ucb criterion.")
            return np.asarray(x_maxi, dtype=float)

        logging.info("The best maximizer has std. dev. %f", float(std_maxi))
        logging.info("The best expander has std. dev. %f", float(std_exp))
        logging.info("The greedy estimate of lower bound has value %f",
                     self.best_lower_bound)
        return np.asarray(x_next, dtype=float)

    def get_maximum(self):
        """Best *observed* point (argmax over the objective's data,
        reference gp_opt.py:1179-1192)."""
        Y = np.asarray(self.gp.Y_host, dtype=float)
        X = np.asarray(self.gp.X_host, dtype=float)
        maxi = int(np.argmax(Y[:, 0]))
        return X[maxi, :], Y[maxi]
