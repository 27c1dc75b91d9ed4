import _bootstrap  # noqa: F401  (sys.path for checkout runs)
import numpy as np, time, jax
import jax.numpy as jnp
from safeopt_tpu import linearly_spaced_combinations
from safeopt_tpu.algorithms.safe_opt_core import safeopt_step
from safeopt_tpu.gp import GPRegression, RBF

rng = np.random.default_rng(0)
n_obs = 50
X = rng.uniform(-1.5, 1.5, size=(n_obs, 2))
Yf = (2.0*np.exp(-0.5*np.sum(X**2, axis=1)) + 0.05*rng.normal(size=n_obs))[:, None]
Yg = (1.0 - 0.1*np.sum(X**2, axis=1) + 0.05*rng.normal(size=n_obs))[:, None]
gp_f = GPRegression(X, Yf, RBF(2, variance=2.0), noise_var=0.0025, capacity=64)
gp_g = GPRegression(X, Yg, RBF(2, variance=1.0, lengthscale=1.5), noise_var=0.0025, capacity=64)
kernels = (gp_f.kern, gp_g.kern); states = (gp_f.state, gp_g.state)
dtype = states[0].X.dtype
grid = jnp.asarray(linearly_spaced_combinations([(-5.,5.),(-5.,5.)], 1000), dtype)
fmin = jnp.asarray([0.2, 0.5], dtype); beta = jnp.asarray(2.0, dtype)
scaling = jnp.asarray([np.sqrt(2.0), 1.0], dtype); threshold = jnp.asarray([0.0, 0.0], dtype)

def run(tag, **kw):
    def step():
        return safeopt_step(kernels, states, grid, fmin, beta, scaling, threshold, **kw)
    r = step(); jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(10): r = step()
    jax.block_until_ready(r)
    print(f"{tag}: {(time.perf_counter()-t0)/10*1e3:.2f} ms  (G any={bool(np.asarray(r.G).any())})", flush=True)


run("ucb (no expander walk)", ucb=True)
run("full                  ", ucb=False, chunk=64)
