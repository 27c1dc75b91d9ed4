"""Shared bookkeeping for safe Bayesian optimization algorithms.

Accelerator-native counterpart of the reference base class
(/root/reference/safeopt/gp_opt.py:30-279). Semantics preserved:

- multi-GP container: ``gps[0]`` is the objective, the rest are safety
  constraints (gp_opt.py:63-67);
- ``fmin`` broadcast scalar -> per-GP 1-D array (gp_opt.py:69-72), with
  ``-inf`` meaning "no safety constraint for this GP";
- ``beta`` constant or callable of the time step t = number of rows in
  the global data store (gp_opt.py:74-79,114-117);
- ``scaling='auto'`` = prior standard deviation per kernel,
  ``sqrt(Kdiag(0))`` (gp_opt.py:81-84);
- a global (x, y) store that is the union of all observations, where a
  NaN in column i means "no observation for GP i" and the point is
  routed around GP i (gp_opt.py:119-130,247-251);
- context columns hstacked onto x (gp_opt.py:187-205).

The global store is small host-side NumPy (it only grows by one row per
physical experiment); the per-GP posterior state lives on device inside
the ``GPRegression`` wrappers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..gp.regression import GPRegression

__all__ = ["GaussianProcessOptimization"]


class GaussianProcessOptimization:
    """Base class: data routing and bookkeeping common to both algorithms.

    Parameters
    ----------
    gp : GPRegression or list of GPRegression
        The first GP models the objective; any further GPs model safety
        constraints.
    fmin : float or list of floats
        Safety thresholds, one per GP (scalar broadcasts). Use ``-inf``
        for "no constraint on this GP".
    beta : float or callable
        Confidence-interval scale; a callable receives the time step.
    num_contexts : int
        Number of trailing context columns in the GP inputs.
    threshold : float or list of floats
        Expansion stopping threshold (unscaled).
    scaling : 'auto' or list of floats
        Per-GP uncertainty normalizers; 'auto' uses each kernel's prior
        standard deviation.
    """

    def __init__(self, gp, fmin, beta=2, num_contexts=0, threshold=0,
                 scaling="auto"):
        self.gps: List[GPRegression] = list(gp) if isinstance(gp, list) \
            else [gp]
        self.gp = self.gps[0]

        fmin = fmin if isinstance(fmin, list) else [fmin] * len(self.gps)
        self.fmin = np.atleast_1d(np.asarray(fmin, dtype=float).squeeze())

        self._beta_is_callable = callable(beta)
        if callable(beta):
            self.beta = beta
        else:
            self.beta = lambda t, _b=float(beta): _b

        if isinstance(scaling, str) and scaling == "auto":
            origin = np.zeros((1, self.gps[0].input_dim))
            prior_var = [float(np.asarray(g.kern.Kdiag(origin))[0])
                         for g in self.gps]
            self.scaling = np.sqrt(np.asarray(prior_var))
            if np.any(self.scaling == 0.0):
                # e.g. a Linear-only kernel: Kdiag vanishes at the
                # origin and the width normalizers would divide by zero
                raise ValueError(
                    "scaling='auto' uses the prior std at the origin, "
                    "which is zero for at least one GP (Linear-only "
                    "kernels have no variance there); pass explicit "
                    "scaling values")
        else:
            self.scaling = np.asarray(scaling, dtype=float)
            if self.scaling.shape[0] != len(self.gps):
                raise ValueError(
                    "The number of scaling values should be equal to the "
                    "number of GPs")

        self.threshold = threshold
        self._parameter_set = None
        self.bounds = None
        self.num_samples = 0
        self.num_contexts = num_contexts

        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._init_global_store()

    # -- global data store --------------------------------------------------

    def _init_global_store(self) -> None:
        """Seed the global (x, y) store from the GPs' initial data.

        All GPs must start from identical X (reference requirement,
        gp_opt.py:119-130).
        """
        self._x = np.asarray(self.gp.X_host, dtype=float).copy()
        cols = [np.asarray(self.gp.Y_host, dtype=float)]
        for g in self.gps[1:]:
            if not np.allclose(self._x, np.asarray(g.X_host, dtype=float)):
                raise NotImplementedError(
                    "The GPs have different measurements.")
            cols.append(np.asarray(g.Y_host, dtype=float))
        self._y = np.concatenate(cols, axis=1)

    @property
    def x(self) -> np.ndarray:
        """Global observation inputs (union across GPs; GPy-style)."""
        return self._x

    @property
    def y(self) -> np.ndarray:
        """Global observations, one column per GP (NaN = unobserved)."""
        return self._y

    @property
    def data(self):
        """All observations across GPs (NaN = missing for that GP)."""
        return self._x, self._y

    @property
    def t(self) -> int:
        """Time step = number of rows in the global data store."""
        return self._x.shape[0]

    # -- context plumbing ---------------------------------------------------

    def _add_context(self, x: np.ndarray, context) -> np.ndarray:
        """Append context columns to parameter rows."""
        context = np.atleast_2d(np.asarray(context, dtype=float))
        out = np.empty((x.shape[0], x.shape[1] + context.shape[1]))
        out[:, : x.shape[1]] = x
        out[:, x.shape[1]:] = context
        return out

    # -- data mutation -------------------------------------------------------

    def _add_data_point(self, gp: GPRegression, x, y, context=None) -> None:
        """Append observation(s) to one GP only (global store untouched).

        Used for the virtual-observation expander test; pair with
        ``_remove_last_data_point`` (reference gp_opt.py:207-228).
        """
        x = np.atleast_2d(np.asarray(x, dtype=float))
        if context is not None:
            x = self._add_context(x, context)
        y = np.asarray(y, dtype=float).reshape(x.shape[0], 1)
        for xi, yi in zip(x, y):
            gp.append_data(xi, yi[0])

    def _remove_last_data_point(self, gp: GPRegression) -> None:
        """Drop the most recent observation from one GP only."""
        gp.pop_data()

    def add_new_data_point(self, x, y, context=None) -> None:
        """Record a new physical observation.

        Routes each y-column to its GP, skipping NaN entries, and
        appends the full row to the global store (reference
        gp_opt.py:230-255).
        """
        x = np.atleast_2d(np.asarray(x, dtype=float))
        y = np.atleast_2d(np.asarray(y, dtype=float))
        if self.num_contexts:
            x = self._add_context(x, context)

        for i, gp in enumerate(self.gps):
            not_nan = ~np.isnan(y[:, i])
            if np.any(not_nan):
                self._add_data_point(gp, x[not_nan, :], y[not_nan, i])

        self._x = np.concatenate((self._x, x), axis=0)
        self._y = np.concatenate((self._y, y), axis=0)

    def remove_last_data_point(self) -> None:
        """Undo the most recent ``add_new_data_point``."""
        last_y = self._y[-1]
        for gp, yi in zip(self.gps, last_y):
            if not np.isnan(yi):
                gp.pop_data()
        self._x = self._x[:-1, :]
        self._y = self._y[:-1, :]

    # -- plotting ------------------------------------------------------------

    def plot(self, n_samples, axis=None, figure=None, plot_3d=False,
             **kwargs):
        """Plot the current optimization state (host-side matplotlib).

        Dispatches on dimensionality like the reference
        (gp_opt.py:132-185): 1-D -> band plot per GP, 2-D -> contour or
        3-D surface.
        """
        from ..utils.grids import linearly_spaced_combinations
        from ..utils.plotting import plot_2d_gp, plot_3d_gp, plot_contour_gp

        if self.num_contexts > 0 and "fixed_inputs" not in kwargs:
            kwargs.update(fixed_inputs=self.context_fixed_inputs)

        true_input_dim = self.gp.kern.input_dim - self.num_contexts
        inputs = None
        if true_input_dim == 1 or plot_3d:
            inputs = np.zeros((n_samples ** true_input_dim,
                               self.gp.input_dim))
            inputs[:, :true_input_dim] = linearly_spaced_combinations(
                self.bounds[:true_input_dim], n_samples)

        if not isinstance(n_samples, Sequence):
            n_samples = [n_samples] * len(self.bounds)

        axes = []
        if true_input_dim == 1:
            for gp, fmin in zip(self.gps, self.fmin):
                fmin_arg = None if fmin == -np.inf else fmin
                axes.append(plot_2d_gp(gp, inputs, figure=figure, axis=axis,
                                       fmin=fmin_arg, **kwargs))
            return axes
        if plot_3d:
            for gp in self.gps:
                plot_3d_gp(gp, inputs, figure=figure, axis=axis, **kwargs)
        else:
            for gp in self.gps:
                plot_contour_gp(
                    gp,
                    [np.linspace(self.bounds[0][0], self.bounds[0][1],
                                 n_samples[0]),
                     np.linspace(self.bounds[1][0], self.bounds[1][1],
                                 n_samples[1])],
                    figure=figure, axis=axis)

    # populated by SafeOpt (context-aware subclass); defined here so
    # ``plot`` can reference it uniformly
    context_fixed_inputs = None
