"""safeopt_tpu — accelerator-native safe Bayesian optimization in JAX.

A from-scratch JAX framework with the capabilities of befelix/SafeOpt:

- ``SafeOpt``: exact safe Bayesian optimization over a discretized
  candidate grid, with multiple safety constraints, contexts and an
  optional Lipschitz expander test. Very large grids run as one fused
  jit program (posterior + interval bookkeeping + safe/maximizer/
  expander classification + query selection) and shard across chips.
- ``SafeOptSwarm``: heuristic swarm-based variant for high-dimensional
  problems; each particle-swarm run is a single fused ``lax.scan``.
- ``SwarmOptimization``: the generic constrained PSO engine.
- An in-repo exact GP engine (``safeopt_tpu.gp``) replacing the
  reference's GPy dependency: RBF / Matern-3/2 / ARD / active-dims /
  product kernels, padded-buffer Cholesky state with exact O(n^2)
  append / remove-last updates, matmul-formulated batch posteriors.
- Utilities: grid construction, GP-prior test-function sampling, and
  matplotlib plotting helpers.

Public API mirrors the reference package
(/root/reference/safeopt/__init__.py:36-39).
"""

from .algorithms import (GaussianProcessOptimization, SafeOpt, SafeOptSwarm,
                         run_lagged_campaign,
                         SwarmOptimization)
from .gp import (GPRegression, Matern32, Matern52, Exponential, RatQuad,
                 Cosine, StdPeriodic, Linear, Poly, MLP, Bias, White,
                 Product, Sum, RBF)
from .utils import (linearly_spaced_combinations, plot_2d_gp, plot_3d_gp,
                    plot_contour_gp, sample_gp_function)

__version__ = "0.1.0"

__all__ = [
    "SafeOpt", "SafeOptSwarm", "SwarmOptimization",
    "GaussianProcessOptimization", "run_lagged_campaign",
    "GPRegression", "RBF", "Matern32", "Matern52", "Exponential",
    "RatQuad", "Cosine", "StdPeriodic", "Linear", "Poly", "MLP",
    "Bias", "White", "Product", "Sum",
    "linearly_spaced_combinations", "sample_gp_function",
    "plot_2d_gp", "plot_3d_gp", "plot_contour_gp",
]
