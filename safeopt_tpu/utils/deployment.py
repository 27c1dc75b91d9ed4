"""AOT export of the fused SafeOpt step for production serving.

``jax.export`` serializes the traced step to a versioned StableHLO
artifact with shape/dtype calling conventions baked in. A serving
process deserializes the blob and calls it — no Python tracing, no
safeopt_tpu import, no retracing drift between the tuned and the
deployed program; the artifact is also the unit you version, review
and roll back. Kernel hyperparameters, GP factor state, the grid and
all scalars remain *runtime arguments*, so a server can hot-swap
observations and hyperparameters without re-exporting.

The reference has no deployment story (a GPy object pickle at best);
this is the accelerator-native equivalent of shipping a compiled model.

Shapes are fixed at export (XLA compilation model): one artifact per
(capacity, grid size, num GPs, chunk) configuration. The padded-state
design means capacity growth is the only reason to re-export during a
campaign.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax

__all__ = ["export_step", "load_step", "export_campaign",
           "export_swarm_campaign"]


def _register_serializations() -> None:
    """Register the framework's pytree types with jax.export.

    The exported calling convention embeds the argument/result pytree
    structure; custom nodes (kernel classes) and NamedTuples (GPState,
    StepResult) need byte-serializable aux data. Idempotent.
    """
    import json

    from jax import export as jexport

    from ..algorithms.safe_opt_core import StepResult
    from ..gp import kernels as K
    from ..gp.regression import GPState

    def _stationary(cls):
        def ser(aux):
            input_dim, ard, active_dims, name = aux
            return json.dumps([input_dim, ard, list(active_dims),
                               name]).encode()

        def de(blob):
            input_dim, ard, active_dims, name = json.loads(blob.decode())
            return (input_dim, ard, tuple(active_dims), name)

        jexport.register_pytree_node_serialization(
            cls, serialized_name=f"safeopt_tpu.{cls.__name__}",
            serialize_auxdata=ser, deserialize_auxdata=de)

    def _composite(cls):
        jexport.register_pytree_node_serialization(
            cls, serialized_name=f"safeopt_tpu.{cls.__name__}",
            serialize_auxdata=lambda aux: b"",
            deserialize_auxdata=lambda blob: None)

    from ..algorithms.runner import BOLoopResult, SwarmLoopResult
    from ..algorithms.swarm_opt_fused import SwarmIterState

    def _once(register, *args, **kw):
        try:
            register(*args, **kw)
        except ValueError:
            pass  # this one already registered; keep going

    # RatQuad's aux is identical to the other stationary kernels (its
    # extra `power` hyperparameter is a traced child leaf, not aux), so
    # the shared serializer covers it unchanged — as are Linear's and
    # MLP's (input_dim, ARD, active_dims, name) with their extra
    # hyperparameters as children, and Poly's (input_dim, order,
    # active_dims, name): the serializer is positional and ``order``
    # (a float) rides the second slot through json unchanged.
    for cls in (K.RBF, K.Matern32, K.Matern52, K.Exponential, K.RatQuad,
                K.Cosine, K.Linear, K.Poly, K.MLP, K.Bias, K.White):
        _once(_stationary, cls)

    def _periodic(cls):
        def ser(aux):
            input_dim, ard1, ard2, active_dims, name = aux
            return json.dumps([input_dim, ard1, ard2, list(active_dims),
                               name]).encode()

        def de(blob):
            input_dim, ard1, ard2, active_dims, name = json.loads(
                blob.decode())
            return (input_dim, ard1, ard2, tuple(active_dims), name)

        jexport.register_pytree_node_serialization(
            cls, serialized_name=f"safeopt_tpu.{cls.__name__}",
            serialize_auxdata=ser, deserialize_auxdata=de)

    _once(_periodic, K.StdPeriodic)
    for cls in (K.Product, K.Sum):
        _once(_composite, cls)
    for nt in (GPState, StepResult, BOLoopResult, SwarmLoopResult,
               SwarmIterState):
        _once(jexport.register_namedtuple_serialization, nt,
              serialized_name=f"safeopt_tpu.{nt.__name__}")


#: kernel classes whose pytree aux can round-trip through jax.export.
_SERIALIZABLE_KERNELS = ("RBF", "Matern32", "Matern52", "Exponential",
                         "RatQuad", "Cosine", "StdPeriodic", "Linear",
                         "Poly", "MLP", "Bias", "White", "Product",
                         "Sum")


def _check_kernels_serializable(kernels) -> None:
    """Fail fast, by name, on kernels jax.export cannot round-trip.

    Without this, an unregistered kernel class surfaces as a deep
    ``jax.export`` serialization trace; every kernel in
    ``safeopt_tpu.gp.kernels.__all__`` must either export or raise a
    one-line TypeError naming itself.
    """
    from ..gp import kernels as K

    allowed = tuple(getattr(K, name) for name in _SERIALIZABLE_KERNELS)

    def walk(kern):
        if isinstance(kern, K._Composite):
            for part in kern.parts:
                walk(part)
        if not isinstance(kern, allowed):
            raise TypeError(
                f"kernel class {type(kern).__name__!r} is not registered "
                "for jax.export serialization; exportable kernels: "
                f"{', '.join(_SERIALIZABLE_KERNELS)}")

    for kern in (kernels if isinstance(kernels, (list, tuple))
                 else [kernels]):
        walk(kern)


def export_step(kernels, states, grid, fmin, beta, scaling, threshold,
                *, chunk: int = 64, ucb: bool = False,
                path: Optional[str] = None,
                platforms: Optional[Sequence[str]] = None) -> bytes:
    """Serialize one fused SafeOpt iteration for the given shapes.

    The example arguments fix shapes/dtypes only; their values are NOT
    baked in — the exported function takes ``(kernels, states, grid,
    fmin, beta, scaling, threshold)`` at call time (kernel
    hyperparameter leaves included, since kernels are pytrees).

    ``platforms`` lowers for specific targets (e.g. ``['cuda']`` to
    cross-compile a GPU artifact from a CPU host); default is the
    current backend. Returns the serialized bytes; also written to
    ``path`` when given.
    """
    from jax import export as jexport

    from ..algorithms.safe_opt_core import safeopt_step
    from ..config import with_matmul_precision

    _register_serializations()
    _check_kernels_serializable(kernels)

    @jax.jit
    @with_matmul_precision
    def step(kernels, states, grid, fmin, beta, scaling, threshold):
        return safeopt_step(kernels, states, grid, fmin, beta, scaling,
                            threshold, ucb=ucb, chunk=chunk)

    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    exported = jexport.export(step, **kwargs)(
        kernels, states, grid, fmin, beta, scaling, threshold)
    blob = exported.serialize()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def load_step(blob_or_path):
    """Deserialize an exported step or campaign into a callable.

    Accepts the bytes from ``export_step`` / ``export_campaign`` or a
    file path. The returned callable has the artifact's exported
    signature and runs under ``jit`` (compiled once per process, from
    the stored StableHLO — no Python tracing of safeopt_tpu code).
    """
    from jax import export as jexport

    import os

    _register_serializations()
    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as fh:
            blob = fh.read()
    else:
        blob = blob_or_path
    exported = jexport.deserialize(blob)
    return jax.jit(lambda *args: exported.call(*args))


def export_campaign(kernels, states, grid, fmin, beta, scaling, threshold,
                    key, *, objectives, n_iter: int,
                    path: Optional[str] = None,
                    platforms: Optional[Sequence[str]] = None,
                    **loop_kwargs) -> bytes:
    """Serialize an ENTIRE on-device campaign as one artifact.

    Wraps ``algorithms.runner.run_safeopt_loop``: the fused iteration,
    the (traced, baked-in) objective simulators, and the exact model
    update, ``n_iter`` times under ``lax.scan`` — a complete tuning
    job as a single versioned blob. GP states, the grid, scalars and
    the PRNG key stay runtime arguments, so the same artifact re-runs
    campaigns from different seeds/starting models. Load with
    ``load_step``; the returned callable has the exported signature
    ``(kernels, states, grid, fmin, beta, scaling, threshold, key) ->
    BOLoopResult``.
    """
    from jax import export as jexport

    from ..algorithms.runner import run_safeopt_loop

    _register_serializations()
    _check_kernels_serializable(kernels)

    @jax.jit
    def campaign(kernels, states, grid, fmin, beta, scaling, threshold,
                 key):
        return run_safeopt_loop(kernels, states, grid, fmin, beta,
                                scaling, threshold, key,
                                objectives=objectives, n_iter=n_iter,
                                **loop_kwargs)

    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    exported = jexport.export(campaign, **kwargs)(
        kernels, states, grid, fmin, beta, scaling, threshold, key)
    blob = exported.serialize()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def export_swarm_campaign(kernels, states, iter_state, key, velocity_scale,
                          bounds, fmin, scaling, threshold, betas, greedy0,
                          blb0, *, objectives, n_iter: int, swarm_size: int,
                          max_iters: int, path: Optional[str] = None,
                          platforms: Optional[Sequence[str]] = None,
                          **loop_kwargs) -> bytes:
    """``export_campaign`` for the SafeOptSwarm on-device loop.

    Same artifact semantics: objectives and loop structure baked in,
    GP states, the safe-set buffer, scalars and the PRNG key runtime.
    """
    from jax import export as jexport

    from ..algorithms.runner import run_swarmopt_loop

    _register_serializations()
    _check_kernels_serializable(kernels)

    @jax.jit
    def campaign(kernels, states, iter_state, key, velocity_scale, bounds,
                 fmin, scaling, threshold, betas, greedy0, blb0):
        return run_swarmopt_loop(kernels, states, iter_state, key,
                                 velocity_scale, bounds, fmin, scaling,
                                 threshold, betas, greedy0, blb0,
                                 objectives=objectives, n_iter=n_iter,
                                 swarm_size=swarm_size,
                                 max_iters=max_iters, **loop_kwargs)

    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    exported = jexport.export(campaign, **kwargs)(
        kernels, states, iter_state, key, velocity_scale, bounds, fmin,
        scaling, threshold, betas, greedy0, blb0)
    blob = exported.serialize()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob
