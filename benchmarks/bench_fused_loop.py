import _bootstrap  # noqa: F401  (sys.path for checkout runs)
import numpy as np, time, jax
import jax.numpy as jnp
from safeopt_tpu import linearly_spaced_combinations
from safeopt_tpu.algorithms.runner import run_safeopt_loop
from safeopt_tpu.gp import GPRegression, RBF

rng = np.random.default_rng(0)
n_obs = 30
X = rng.uniform(-1.5, 1.5, size=(n_obs, 2))
Yf = (2.0*np.exp(-0.5*np.sum(X**2, axis=1)) + 0.02*rng.normal(size=n_obs))[:, None]
Yg = (1.0 - 0.1*np.sum(X**2, axis=1) + 0.02*rng.normal(size=n_obs))[:, None]
gp_f = GPRegression(X, Yf, RBF(2, variance=2.0), noise_var=0.0025, capacity=128)
gp_g = GPRegression(X, Yg, RBF(2, variance=1.0, lengthscale=1.5), noise_var=0.0025, capacity=128)
dtype = gp_f.state.X.dtype
grid = jnp.asarray(linearly_spaced_combinations([(-5.,5.),(-5.,5.)], 1000), dtype)

def f_dev(x):
    return 2.0*jnp.exp(-0.5*jnp.sum(x*x))
def g_dev(x):
    return 1.0 - 0.1*jnp.sum(x*x)

args = dict(
    objectives=(f_dev, g_dev), n_iter=20, noise_std=0.02,
    chunk=64)
call = lambda key: run_safeopt_loop(
    (gp_f.kern, gp_g.kern), (gp_f.state, gp_g.state), grid,
    jnp.asarray([0.2, 0.5], dtype), jnp.asarray(2.0, dtype),
    jnp.asarray([np.sqrt(2.), 1.0], dtype), jnp.asarray([0., 0.], dtype),
    key, **args)
r = call(jax.random.key(0)); jax.block_until_ready(r)
assert bool(np.asarray(r.has_safe).all()), "lost certification"
t0 = time.perf_counter()
for i in range(3):
    r = call(jax.random.key(i))
jax.block_until_ready(r)
per_iter = (time.perf_counter()-t0)/3/20*1e3
print(f"fused on-device loop: {per_iter:.2f} ms per full BO iteration "
      f"(1e6-grid step + observation + exact model update), 20 iters/dispatch", flush=True)
