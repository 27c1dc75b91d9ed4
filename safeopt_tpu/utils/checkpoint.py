"""Checkpoint / resume for optimization runs.

The reference has no persistence at all (SURVEY.md section 5): an
experiment "resumes" by manually reconstructing objects from data.
Here the complete algorithm state — per-GP data (exact and sparse
models), the global observation store, safe-set points, swarm
estimates, algorithm settings (``expander_chunk``,
``use_lipschitz``, ``max_iters``), and the PRNG key — serializes to a
single ``.npz`` file, and ``load`` rebuilds a functionally identical
optimizer (Cholesky factors are recomputed rather than stored: they
are derived state, and refactorizing n <= a few hundred points is
microseconds).

Kernels are reconstructed from their pytree spec (class name + static
aux + parameter arrays).

Callable ``beta`` schedules cannot be serialized; ``save`` warns
loudly and stores the *current* value — pass the schedule back via
``load(path, beta=...)`` to resume exactly.
"""

from __future__ import annotations

import json
import logging

import jax
import numpy as np

from ..gp import kernels as _kernels
from ..gp.regression import GPRegression
from ..gp.sparse import SparseGPRegression

__all__ = ["save", "load", "save_state", "load_state"]

_KERNEL_CLASSES = {"RBF": _kernels.RBF, "Matern32": _kernels.Matern32,
                   "Matern52": _kernels.Matern52,
                   "Exponential": _kernels.Exponential,
                   "Cosine": _kernels.Cosine}
# stationary kernels with extra hyperparameter leaves beyond
# (variance, lengthscale): class -> extra leaf names
_EXTRA_PARAM_CLASSES = {"RatQuad": (_kernels.RatQuad, ("power",))}
# constant-variance kernels without a meaningful lengthscale/ARD
_SCALAR_KERNEL_CLASSES = {"Bias": _kernels.Bias, "White": _kernels.White}
_COMPOSITE_CLASSES = {"Product": _kernels.Product, "Sum": _kernels.Sum}


def _kernel_spec(kern, arrays, prefix):
    """Flatten a kernel into (json-able spec, named arrays)."""
    for cname, ccls in _COMPOSITE_CLASSES.items():
        if isinstance(kern, ccls):
            s1 = _kernel_spec(kern.k1, arrays, prefix + "p1_")
            s2 = _kernel_spec(kern.k2, arrays, prefix + "p2_")
            return {"type": cname, "k1": s1, "k2": s2}
    if isinstance(kern, _kernels.StdPeriodic):
        arrays[prefix + "variance"] = np.asarray(kern.variance)
        arrays[prefix + "period"] = np.asarray(kern.period)
        arrays[prefix + "lengthscale"] = np.asarray(kern.lengthscale)
        return {"type": "StdPeriodic", "input_dim": kern.input_dim,
                "ARD1": kern.ARD1, "ARD2": kern.ARD2,
                "active_dims": list(kern.active_dims), "prefix": prefix}
    if isinstance(kern, _kernels.Linear):
        arrays[prefix + "variances"] = np.asarray(kern.variances)
        return {"type": "Linear", "input_dim": kern.input_dim,
                "ARD": kern.ARD, "active_dims": list(kern.active_dims),
                "prefix": prefix}
    if isinstance(kern, _kernels.Poly):
        arrays[prefix + "variance"] = np.asarray(kern.variance)
        arrays[prefix + "scale"] = np.asarray(kern.scale)
        arrays[prefix + "bias"] = np.asarray(kern.bias)
        return {"type": "Poly", "input_dim": kern.input_dim,
                "order": kern.order,
                "active_dims": list(kern.active_dims), "prefix": prefix}
    if isinstance(kern, _kernels.MLP):
        arrays[prefix + "variance"] = np.asarray(kern.variance)
        arrays[prefix + "weight_variance"] = np.asarray(
            kern.weight_variance)
        arrays[prefix + "bias_variance"] = np.asarray(kern.bias_variance)
        return {"type": "MLP", "input_dim": kern.input_dim,
                "ARD": kern.ARD, "active_dims": list(kern.active_dims),
                "prefix": prefix}
    name = type(kern).__name__
    if name in _EXTRA_PARAM_CLASSES:
        _, extras = _EXTRA_PARAM_CLASSES[name]
        arrays[prefix + "variance"] = np.asarray(kern.variance)
        arrays[prefix + "lengthscale"] = np.asarray(kern.lengthscale)
        for p in extras:
            arrays[prefix + p] = np.asarray(getattr(kern, p))
        return {"type": name, "input_dim": kern.input_dim,
                "ARD": kern.ARD, "active_dims": list(kern.active_dims),
                "prefix": prefix}
    if name in _SCALAR_KERNEL_CLASSES:
        arrays[prefix + "variance"] = np.asarray(kern.variance)
        return {"type": name, "input_dim": kern.input_dim,
                "active_dims": list(kern.active_dims), "prefix": prefix}
    if name not in _KERNEL_CLASSES:
        raise TypeError(f"cannot checkpoint kernel type {name}")
    arrays[prefix + "variance"] = np.asarray(kern.variance)
    arrays[prefix + "lengthscale"] = np.asarray(kern.lengthscale)
    return {"type": name, "input_dim": kern.input_dim, "ARD": kern.ARD,
            "active_dims": list(kern.active_dims), "prefix": prefix}


def _kernel_from_spec(spec, arrays):
    if spec["type"] in _COMPOSITE_CLASSES:
        return _COMPOSITE_CLASSES[spec["type"]](
            _kernel_from_spec(spec["k1"], arrays),
            _kernel_from_spec(spec["k2"], arrays))
    p = spec["prefix"]
    if spec["type"] == "StdPeriodic":
        return _kernels.StdPeriodic(
            spec["input_dim"], variance=arrays[p + "variance"],
            period=arrays[p + "period"],
            lengthscale=arrays[p + "lengthscale"], ARD1=spec["ARD1"],
            ARD2=spec["ARD2"], active_dims=spec["active_dims"])
    if spec["type"] == "Linear":
        return _kernels.Linear(
            spec["input_dim"], variances=arrays[p + "variances"],
            ARD=spec["ARD"], active_dims=spec["active_dims"])
    if spec["type"] == "Poly":
        return _kernels.Poly(
            spec["input_dim"], variance=arrays[p + "variance"],
            scale=arrays[p + "scale"], bias=arrays[p + "bias"],
            order=spec["order"], active_dims=spec["active_dims"])
    if spec["type"] == "MLP":
        return _kernels.MLP(
            spec["input_dim"], variance=arrays[p + "variance"],
            weight_variance=arrays[p + "weight_variance"],
            bias_variance=arrays[p + "bias_variance"],
            ARD=spec["ARD"], active_dims=spec["active_dims"])
    if spec["type"] in _EXTRA_PARAM_CLASSES:
        cls, extras = _EXTRA_PARAM_CLASSES[spec["type"]]
        kw = {e: arrays[p + e] for e in extras}
        return cls(spec["input_dim"], variance=arrays[p + "variance"],
                   lengthscale=arrays[p + "lengthscale"], ARD=spec["ARD"],
                   active_dims=spec["active_dims"], **kw)
    if spec["type"] in _SCALAR_KERNEL_CLASSES:
        return _SCALAR_KERNEL_CLASSES[spec["type"]](
            spec["input_dim"], variance=arrays[p + "variance"],
            active_dims=spec["active_dims"])
    cls = _KERNEL_CLASSES[spec["type"]]
    return cls(spec["input_dim"], variance=arrays[p + "variance"],
               lengthscale=arrays[p + "lengthscale"], ARD=spec["ARD"],
               active_dims=spec["active_dims"])


def save(opt, path: str) -> None:
    """Serialize a SafeOpt / SafeOptSwarm run to ``path`` (.npz)."""
    from ..algorithms.safe_opt import SafeOpt
    from ..algorithms.swarm_opt import SafeOptSwarm

    if getattr(opt, "_beta_is_callable", False):
        logging.warning(
            "checkpoint: beta is a callable schedule and cannot be "
            "serialized; storing the current value beta(t=%d)=%s. Pass "
            "the schedule back via load(path, beta=...) to resume "
            "exactly.", opt.t, opt.beta(opt.t))

    arrays = {}
    meta = {
        "algo": type(opt).__name__,
        "fmin": np.asarray(opt.fmin).tolist(),
        "beta": opt.beta(opt.t),   # constant betas roundtrip; callables
                                   # must be re-supplied at load time
        "beta_was_callable": bool(getattr(opt, "_beta_is_callable", False)),
        "threshold": np.asarray(opt.threshold).tolist(),
        "scaling": np.asarray(opt.scaling).tolist(),
        "num_contexts": opt.num_contexts,
        "noise_vars": [g.noise_var for g in opt.gps],
        "kernels": [],
        "gp_models": [],
    }
    for i, g in enumerate(opt.gps):
        if isinstance(g, SparseGPRegression):
            # save the BASE (data-model) kernel: the public g.kern is
            # the conservative-inflated view, which the constructor
            # re-derives from (kern_base, conservative) on load
            meta["kernels"].append(_kernel_spec(g.kern_base, arrays,
                                                f"k{i}_"))
            meta["gp_models"].append("sparse")
            arrays[f"gp{i}_Z"] = np.asarray(g.Z)
            meta.setdefault("sparse_conservative", {})[str(i)] = \
                float(g.conservative)
            meta.setdefault("sparse_calibration", {})[str(i)] = \
                g.calibration
        else:
            meta["kernels"].append(_kernel_spec(g.kern, arrays, f"k{i}_"))
            meta["gp_models"].append("exact")
        arrays[f"gp{i}_X"] = np.asarray(g.X)
        arrays[f"gp{i}_Y"] = np.asarray(g.Y)
    arrays["x"] = opt.x
    arrays["y"] = opt.y

    if isinstance(opt, SafeOpt):
        arrays["parameter_set"] = np.asarray(opt.parameter_set)
        meta["lipschitz"] = (None if opt.lipschitz is None
                             else np.asarray(opt.lipschitz).tolist())
        meta["use_lipschitz"] = bool(opt.use_lipschitz)
        meta["expander_chunk"] = int(opt._expander_chunk)
        meta["exact_boundaries"] = bool(opt._exact_boundaries)
        meta["boundary_band"] = float(opt._boundary_band)
        meta["boundary_k"] = int(opt._boundary_k)
        if opt._interval_precision is not None:
            meta["interval_precision"] = str(opt._interval_precision)
        meta["refine_k"] = int(opt._refine_k)
        meta["refine_band"] = float(opt._refine_band)
        meta["refine_band_k"] = int(opt._refine_band_k)
        meta["oracle"] = str(opt._oracle)
        if opt.num_contexts:
            arrays["context"] = np.asarray(opt.context)
    elif isinstance(opt, SafeOptSwarm):
        arrays["safe_set"] = opt.S
        arrays["greedy_point"] = opt.greedy_point
        meta["best_lower_bound"] = float(opt.best_lower_bound)
        meta["bounds"] = np.asarray(opt.bounds, dtype=float).tolist()
        meta["swarm_size"] = opt.swarm_size
        meta["max_iters"] = int(opt.max_iters)
        arrays["key"] = np.asarray(jax.random.key_data(opt._key))
    else:
        raise TypeError(f"cannot checkpoint {type(opt).__name__}")

    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load(path: str, beta=None):
    """Rebuild an optimizer from a checkpoint.

    ``beta`` overrides the stored constant (required to resume a run
    that used a callable beta schedule — ``save`` stores only the
    schedule's current value and flags it in the metadata).

    Migration note (round 4): checkpoints written before the
    ``refine_band``/``refine_band_k`` metadata existed restore with
    the CURRENT defaults (refine_band=1e-2, refine_band_k=20480), not
    the 5e-3/8192 in effect when they were saved. This is deliberate —
    the old defaults were unsound (a band below the measured 3-pass
    noise ceiling lets knife-edge rows escape both the refinement and
    the f64 oracle) — but it means a resumed legacy
    run refines a wider band than it did before the upgrade. Pass the
    old values explicitly to ``SafeOpt`` after loading only if you
    must reproduce the legacy behavior bit-for-bit.
    """
    from ..algorithms.safe_opt import SafeOpt
    from ..algorithms.swarm_opt import SafeOptSwarm

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    arrays = {k: data[k] for k in data.files if k != "__meta__"}

    if meta.get("beta_was_callable") and beta is None:
        logging.warning(
            "checkpoint: the saved run used a callable beta schedule; "
            "resuming with the frozen value %s. Pass beta=<schedule> to "
            "restore it.", meta["beta"])

    # Build GPs on an identical placeholder row first: NaN-routed
    # observations give GPs differing data, which the constructors'
    # global-store init rejects (reference gp_opt.py:119-130). The
    # true data goes in via set_XY after construction.
    d = arrays["gp0_X"].shape[1]
    placeholder = np.zeros((1, d))
    models = meta.get("gp_models", ["exact"] * len(meta["kernels"]))
    gps = []
    for i, kspec in enumerate(meta["kernels"]):
        kern = _kernel_from_spec(kspec, arrays)
        if models[i] == "sparse":
            gps.append(SparseGPRegression(
                placeholder, np.zeros((1, 1)), kern,
                noise_var=meta["noise_vars"][i],
                inducing=arrays[f"gp{i}_Z"],
                conservative=meta.get("sparse_conservative",
                                      {}).get(str(i), 0.0),
                calibration=meta.get("sparse_calibration",
                                     {}).get(str(i), "max")))
        else:
            gps.append(GPRegression(placeholder, np.zeros((1, 1)), kern,
                                    noise_var=meta["noise_vars"][i]))
    gp_arg = gps if len(gps) > 1 else gps[0]
    beta = beta if beta is not None else meta["beta"]
    threshold = meta["threshold"]
    if isinstance(threshold, list) and len(threshold) == 1:
        threshold = threshold[0]

    if meta["algo"] == "SafeOpt":
        opt = SafeOpt(gp_arg, arrays["parameter_set"], fmin=list(meta["fmin"]),
                      lipschitz=meta["lipschitz"], beta=beta,
                      num_contexts=meta["num_contexts"],
                      threshold=threshold, scaling=meta["scaling"],
                      expander_chunk=meta.get("expander_chunk", 32),
                      exact_boundaries=meta.get("exact_boundaries", False),
                      boundary_band=meta.get("boundary_band", 1e-3),
                      boundary_k=meta.get("boundary_k", 1024),
                      interval_precision=meta.get("interval_precision"),
                      refine_k=meta.get("refine_k", 0),
                      refine_band=meta.get("refine_band", 1e-2),
                      refine_band_k=meta.get("refine_band_k", 20480),
                      oracle=meta.get("oracle", "auto"))
        if "use_lipschitz" in meta:
            opt.use_lipschitz = meta["use_lipschitz"]
        for i, g in enumerate(opt.gps):
            g.set_XY(arrays[f"gp{i}_X"], arrays[f"gp{i}_Y"])
        if meta["num_contexts"]:
            opt.context = arrays["context"]
    elif meta["algo"] == "SafeOptSwarm":
        import jax.random as jrandom

        opt = SafeOptSwarm(gp_arg, fmin=list(meta["fmin"]),
                           bounds=[tuple(b) for b in meta["bounds"]],
                           beta=beta, threshold=threshold,
                           scaling=meta["scaling"],
                           swarm_size=meta["swarm_size"],
                           max_iters=meta.get("max_iters", 100))
        for i, g in enumerate(opt.gps):
            g.set_XY(arrays[f"gp{i}_X"], arrays[f"gp{i}_Y"])
        opt.S = arrays["safe_set"]
        opt.greedy_point = arrays["greedy_point"]
        opt.best_lower_bound = float(meta["best_lower_bound"])
        opt._key = jrandom.wrap_key_data(arrays["key"])
    else:
        raise ValueError(f"unknown algorithm {meta['algo']!r}")

    # Restore the global store exactly (it can contain NaN-masked rows
    # that are not present in any single GP).
    opt._x = arrays["x"]
    opt._y = arrays["y"]
    return opt


# ---------------------------------------------------------------------------
# device loop-state persistence (on-device campaigns / fleets)
# ---------------------------------------------------------------------------
#
# The host-object checkpointing above covers the wrapper classes; the
# on-device loops (algorithms/runner.py) and vmapped fleets
# (parallel/campaigns.py) instead carry their whole state as pytrees of
# device arrays — batched GPStates, SwarmIterState safe-set buffers,
# PRNG key streams, iteration cursors. save_state/load_state serialize
# ANY such pytree (named-tuple structure encoded by field name, PRNG
# keys via key_data) so a fleet that dies mid-campaign resumes exactly:
# checkpoint {states, iter_state, remaining it_keys, cursor}, reload,
# and relaunch the runner on the tail (see run_safeopt_loop's it_keys).


def _state_types():
    from ..algorithms.runner import BOLoopResult, SwarmLoopResult
    from ..algorithms.swarm_opt_fused import SwarmIterState
    from ..gp.regression import GPState

    return {"GPState": GPState, "SwarmIterState": SwarmIterState,
            "BOLoopResult": BOLoopResult, "SwarmLoopResult": SwarmLoopResult}


def _is_prng_key(x) -> bool:
    try:
        return jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
    except (AttributeError, TypeError):
        return False


def _encode_state(obj, arrays, prefix):
    types = _state_types()
    for name, cls in types.items():
        if isinstance(obj, cls):
            return {"type": name, "fields": {
                f: _encode_state(getattr(obj, f), arrays,
                                 f"{prefix}{f}_")
                for f in obj._fields}}
    if isinstance(obj, dict):
        return {"type": "dict", "items": {
            k: _encode_state(v, arrays, f"{prefix}{k}_")
            for k, v in obj.items()}}
    if isinstance(obj, (tuple, list)):
        return {"type": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_encode_state(v, arrays, f"{prefix}{i}_")
                          for i, v in enumerate(obj)]}
    if obj is None:
        return {"type": "none"}
    if _is_prng_key(obj):
        key = prefix + "key"
        arrays[key] = np.asarray(jax.random.key_data(obj))
        return {"type": "prngkey", "key": key}
    if isinstance(obj, (int, float, bool)):
        return {"type": "scalar", "value": obj}
    # arrays (device or host) — pulled to host numpy here
    key = prefix + "a"
    arrays[key] = np.asarray(obj)
    return {"type": "array", "key": key}


def _decode_state(spec, arrays):
    types = _state_types()
    t = spec["type"]
    if t in types:
        cls = types[t]
        return cls(**{f: _decode_state(s, arrays)
                      for f, s in spec["fields"].items()})
    if t == "dict":
        return {k: _decode_state(s, arrays)
                for k, s in spec["items"].items()}
    if t in ("tuple", "list"):
        vals = [_decode_state(s, arrays) for s in spec["items"]]
        return tuple(vals) if t == "tuple" else vals
    if t == "none":
        return None
    if t == "prngkey":
        return jax.random.wrap_key_data(arrays[spec["key"]])
    if t == "scalar":
        return spec["value"]
    return arrays[spec["key"]]


def save_state(path: str, tree) -> None:
    """Serialize a device loop-state pytree to ``path`` (.npz).

    Accepts any nesting of tuples/lists/dicts, the framework's state
    NamedTuples (GPState, SwarmIterState, BOLoopResult,
    SwarmLoopResult), JAX/numpy arrays (batched fleet axes included),
    typed PRNG key arrays and Python scalars. Everything is pulled to
    host numpy; ``load_state`` returns host arrays that feed straight
    back into the jitted runners (which ship them to the device).
    """
    arrays = {}
    spec = _encode_state(tree, arrays, "s_")
    np.savez(path, __state__=json.dumps(spec), **arrays)


def load_state(path: str):
    """Rebuild a device loop-state pytree saved by ``save_state``."""
    data = np.load(path, allow_pickle=False)
    spec = json.loads(str(data["__state__"]))
    arrays = {k: data[k] for k in data.files if k != "__state__"}
    return _decode_state(spec, arrays)
