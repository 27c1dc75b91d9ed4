"""In-repo GP engine (replaces the reference's GPy dependency)."""

from .hyperopt import fit_hyperparameters, log_marginal_likelihood
from .kernels import (RBF, Matern32, Matern52, Exponential, RatQuad,
                      Cosine, StdPeriodic, Linear, Poly, MLP, Bias,
                      White, Product, Sum, Kernel)
from .regression import (GPRegression, GPState, gp_fit, gp_append, gp_pop,
                         gp_predict, predict_from_factors)
from .sparse import SparseGPRegression

__all__ = ["RBF", "Matern32", "Matern52", "Exponential", "RatQuad",
           "Cosine", "StdPeriodic", "Linear", "Poly", "MLP", "Bias",
           "White", "Product", "Sum", "Kernel",
           "GPRegression",
           "GPState", "gp_fit", "gp_append", "gp_pop", "gp_predict",
           "predict_from_factors", "fit_hyperparameters",
           "log_marginal_likelihood", "SparseGPRegression"]
