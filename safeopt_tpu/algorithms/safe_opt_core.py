"""Fused, jit-compiled core of the exact (grid) SafeOpt algorithm.

This module is the accelerator-native redesign of the reference hot path
(/root/reference/safeopt/gp_opt.py:453-712). Everything that touches
the O(N) candidate grid runs inside one compiled program per
``optimize()`` call:

1. **Confidence intervals** (reference ``update_confidence_intervals``,
   gp_opt.py:453-476): per GP, posterior over the full grid as pure
   matmuls on whitened factors — ``V = Linv @ K(X, grid)``,
   ``mu = V^T w``, ``var = kdiag - colsum(V^2)`` — then
   ``Q = mu -+ beta*sigma``. ``V`` is retained and reused by the
   expander test.

2. **Set classification** (gp_opt.py:478-536): safe set S (strict
   ``l > fmin`` intersection over GPs), maximizers M, and the
   candidate-expander filter (safe, not in M, scaled width above the
   best maximizer width, width above ``threshold * beta``) as masked
   reductions.

3. **Expander search** (gp_opt.py:557-612): the reference adds a
   *virtual observation* ``(x_cand, u_i)`` to constraint GP i, refits,
   and re-predicts every unsafe grid point, sequentially per candidate
   with early exit at the first success. Conditioning on one extra
   observation is a closed-form rank-1 posterior update, so here the
   test is evaluated for a whole *chunk* of candidates at once:

       c    = Linv k(X, x_cand)            (one matvec per candidate)
       dd   = sqrt(k(x,x) + noise - c.c)   (bordered Cholesky diagonal)
       E    = (k(x_cand, Z) - c^T V) / dd  (cross-covariance update)
       mu'  = mu(Z) + E * (u - c^T w)/dd
       var' = var(Z) - E^2

   Candidates are visited in the reference's sort order (descending
   max width) chunk by chunk under ``lax.while_loop``, stopping at the
   first chunk containing a success — identical decisions to the
   sequential loop, zero per-point Python work.

4. **Query selection** (gp_opt.py:617-649): masked argmax of the max
   scaled width over M cup G (or of the objective upper bound over S
   for the safe-UCB criterion).

GPs may have heterogeneous kernels (e.g. RBF objective + Matern
constraint), so the per-GP loop is unrolled at trace time; each GP's
state is a fixed-shape pytree and the whole step compiles once per
(grid size, capacities, num GPs) signature.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import with_matmul_precision
from ..gp.kernels import Kernel
from ..ops.topk import partial_top_k
from ..gp.regression import GPState

__all__ = ["StepResult", "safeopt_step", "safe_maximum",
           "full_expander_sets", "boundary_scan", "safeopt_step_from_Q",
           "certified_scan", "interval_scan", "device_oracle",
           "certified_finish"]


class StepResult(NamedTuple):
    """Device-side outputs of one fused SafeOpt iteration."""

    Q: jnp.ndarray          # (N, 2G) confidence intervals [l0,u0,l1,u1,..]
    S: jnp.ndarray          # (N,) safe set
    M: jnp.ndarray          # (N,) maximizers
    G: jnp.ndarray          # (N,) expanders (<=1 True unless full_sets)
    next_idx: jnp.ndarray   # () index of the next query point
    has_safe: jnp.ndarray   # () bool — host raises if False
    # tiny scalars so per-iteration stats never pull the O(N) masks
    safe_count: jnp.ndarray
    maximizer_count: jnp.ndarray
    expander_found: jnp.ndarray
    # the same five scalars packed into ONE int32 buffer: every host
    # conversion is a device->host round trip, so optimize() pulls this
    # single small array instead of five separate device scalars.
    diag: jnp.ndarray       # (5,) i32 [has_safe, next_idx, |S|, |M|, anyG]


def _pack_result(Q, S, M, G, next_idx, has_safe) -> StepResult:
    """Assemble a StepResult, deriving the scalar stats and the packed
    single-pull diagnostics buffer."""
    safe_count = jnp.sum(S)
    maximizer_count = jnp.sum(M)
    expander_found = jnp.any(G)
    diag = jnp.stack([has_safe.astype(jnp.int32),
                      next_idx.astype(jnp.int32),
                      safe_count.astype(jnp.int32),
                      maximizer_count.astype(jnp.int32),
                      expander_found.astype(jnp.int32)])
    return StepResult(Q=Q, S=S, M=M, G=G, next_idx=next_idx,
                      has_safe=has_safe, safe_count=safe_count,
                      maximizer_count=maximizer_count,
                      expander_found=expander_found, diag=diag)


# ---------------------------------------------------------------------------
# confidence intervals
# ---------------------------------------------------------------------------

def _posterior_with_V(kernel: Kernel, state: GPState, grid: jnp.ndarray):
    """Grid posterior returning (mu, var, V) with V = Linv @ K(X, grid)."""
    cap = state.capacity
    mask = (jnp.arange(cap) < state.count).astype(grid.dtype)
    kvec = kernel.K(state.X, grid) * mask[:, None]        # (cap, N)
    V = state.Linv @ kvec                                  # (cap, N)
    mu = V.T @ state.w                                     # (N,)
    var = jnp.maximum(kernel.Kdiag(grid) - jnp.sum(V * V, axis=0), 0.0)
    return mu, var, V


# The XLA interval path materializes (cap, N) temporaries (kvec, V) per
# GP. Above a per-GP V size of a sixteenth of the device's memory limit
# (so the kvec and V of several GPs fit beside the grid) the posterior
# runs CHUNKED over the grid instead: a sequential lax.map, memory
# bounded by one chunk, V not retained (the expander recomputes its
# cross terms chunk-wise). The CPU backend reports no memory limit, so
# it keeps a fixed one.
_V_BYTES_LIMIT = 3 << 30
_V_MEMORY_FRACTION = 1 / 16
_CHUNK_ROWS = 1 << 16


def _v_bytes_limit() -> int:
    """Per-GP byte size of ``V`` above which the posterior is chunked.

    Read from this process's first device: under ``jax.distributed``
    ``jax.devices()[0]`` may belong to another process.
    """
    stats = jax.local_devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        return _V_BYTES_LIMIT
    return int(stats["bytes_limit"] * _V_MEMORY_FRACTION)


def _posterior_chunked(kernel: Kernel, state: GPState, grid: jnp.ndarray):
    """(mu, var) over the grid with device memory bounded by one chunk."""
    cap = state.capacity
    n, d = grid.shape
    mask = (jnp.arange(cap) < state.count).astype(grid.dtype)
    lmasked = state.Linv * mask[None, :]

    block = min(_CHUNK_ROWS, n)
    pad = (-n) % block
    gpad = (jnp.concatenate([grid, jnp.zeros((pad, d), grid.dtype)])
            if pad else grid)

    def one(gb):
        kvec = kernel.K(state.X, gb) * mask[:, None]       # (cap, B)
        V = lmasked @ kvec                                 # (cap, B)
        mu = V.T @ state.w
        var = jnp.maximum(kernel.Kdiag(gb) - jnp.sum(V * V, axis=0), 0.0)
        return mu, var

    mu, var = jax.lax.map(one, gpad.reshape(-1, block, d))
    return mu.reshape(-1)[:n], var.reshape(-1)[:n]


def _confidence_intervals(kernels, states, grid, beta):
    """Q columns, plus per-GP (mu, sigma, V) retained for the expander.

    ``V`` is ``None`` for a GP whose posterior ran chunked (see
    ``_v_bytes_limit``); the expander then recomputes its cross terms.
    """
    mus, sigmas, Vs, cols = [], [], [], []
    v_limit = _v_bytes_limit()
    for kern, st in zip(kernels, states):
        if 4 * st.capacity * grid.shape[0] > v_limit:
            mu, var = _posterior_chunked(kern, st, grid)
            V = None
        else:
            mu, var, V = _posterior_with_V(kern, st, grid)
        sigma = jnp.sqrt(var)
        mus.append(mu)
        sigmas.append(sigma)
        Vs.append(V)
        cols.append(mu - beta * sigma)
        cols.append(mu + beta * sigma)
    Q = jnp.stack(cols, axis=1)
    return Q, mus, sigmas, Vs


# ---------------------------------------------------------------------------
# set classification
# ---------------------------------------------------------------------------

def _classify(Q, fmin, scaling, threshold, beta, valid, S=None):
    """S, M, and the expander-candidate mask + sort order.

    Mirrors gp_opt.py:478-552. ``threshold`` is a per-GP array (scalar
    thresholds are broadcast by the caller). ``valid`` masks padding
    rows appended for even sharding — they can be neither safe nor
    unsafe-set members. A precomputed (e.g. boundary-certified) ``S``
    may be supplied instead of the strict interval test.
    """
    l = Q[:, 0::2]                                   # (N, G)
    u = Q[:, 1::2]
    widths = u - l

    if S is None:
        S = jnp.all(l > fmin, axis=1) & valid        # strict, like reference
    has_safe = jnp.any(S)

    l0, u0 = l[:, 0], u[:, 0]
    best_l0 = jnp.max(jnp.where(S, l0, -jnp.inf))
    M = S & (u0 >= best_l0)
    max_var = jnp.max(jnp.where(M, u0 - l0, -jnp.inf)) / scaling[0]

    scaled_width = jnp.max(widths / scaling, axis=1)
    unscaled_width = jnp.max(widths, axis=1)
    cand = (S & ~M
            & (scaled_width > max_var)
            & jnp.any(widths > threshold * beta, axis=1))

    # Empty safe set zeroes everything (gp_opt.py:504-507).
    M = M & has_safe
    cand = cand & has_safe
    return S, M, cand, unscaled_width, has_safe


# ---------------------------------------------------------------------------
# expander predicate (rank-1 virtual-observation update)
# ---------------------------------------------------------------------------

def _chunk_expander_predicate(kernels, states, grid, Q, unsafe, mus, sigmas,
                              Vs, fmin, beta, lipschitz, grid_idx, valid):
    """Expander predicate for a chunk of candidate grid indices.

    GP variant (lipschitz None): closed-form rank-1 conditioning on the
    virtual observation (x_cand, u_i) per constraint GP, checked against
    every currently-unsafe grid point (gp_opt.py:577-606).
    Lipschitz variant: ``u_i - L_i * mindist(x_cand, unsafe) >= fmin_i``
    (gp_opt.py:558-576). ``unsafe`` excludes sharding-padding rows.
    """
    C = grid_idx.shape[0]
    Xc = jnp.take(grid, grid_idx, axis=0)                 # (C, d)
    pred = jnp.ones((C,), dtype=bool)

    if lipschitz is None:
        for i, (kern, st) in enumerate(zip(kernels, states)):
            fmin_i = fmin[i]
            uc = jnp.take(Q[:, 2 * i + 1], grid_idx)       # (C,)

            cap = st.capacity
            mask = (jnp.arange(cap) < st.count).astype(grid.dtype)

            kmat = kern.K(st.X, Xc) * mask[:, None]        # (cap, C)
            Cm = st.Linv @ kmat                            # (cap, C)
            dd2 = kern.Kdiag(Xc) + st.noise_var - jnp.sum(Cm * Cm, axis=0)
            dd = jnp.sqrt(jnp.maximum(dd2, 1e-30))         # (C,)
            gain = (uc - Cm.T @ st.w) / dd                 # (C,)

            # Cross-covariance update for every grid point:
            # Cm^T V = (Cm^T Linv) @ K(X, grid) — when V was kept from
            # the interval pass, reuse it; otherwise (fused or chunked
            # interval pass) fold Cm into Linv first so only a (C, cap) @
            # (cap, N) matmul touches the grid.
            if Vs[i] is not None:
                cross = Cm.T @ Vs[i]                        # (C, N)
            else:
                M2 = Cm.T @ (st.Linv * mask[None, :])       # (C, cap)
                if 4 * cap * grid.shape[0] > _v_bytes_limit():
                    # (cap, N) kvec would not fit (see
                    # _posterior_chunked); stream grid chunks instead
                    n, d = grid.shape
                    block = min(_CHUNK_ROWS, n)
                    pad = (-n) % block
                    gpad = (jnp.concatenate(
                        [grid, jnp.zeros((pad, d), grid.dtype)])
                        if pad else grid)

                    def one(gb, kern=kern, st=st, mask=mask, M2=M2):
                        return M2 @ (kern.K(st.X, gb) * mask[:, None])

                    cross = jnp.swapaxes(
                        jax.lax.map(one, gpad.reshape(-1, block, d)),
                        0, 1).reshape(M2.shape[0], -1)[:, :n]
                else:
                    cross = M2 @ (kern.K(st.X, grid) * mask[:, None])
            E = (kern.K(Xc, grid) - cross) / dd[:, None]    # (C, N)
            mu2 = mus[i][None, :] + E * gain[:, None]
            var2 = jnp.maximum(sigmas[i][None, :] ** 2 - E * E, 0.0)
            l2 = mu2 - beta * jnp.sqrt(var2)

            pred_i = jnp.any(unsafe[None, :] & (l2 >= fmin_i), axis=1)
            pred &= jnp.where(fmin_i == -jnp.inf, True, pred_i)
    else:
        # Pairwise distances candidate -> unsafe grid points.
        d2 = (jnp.sum(Xc * Xc, axis=1)[:, None]
              + jnp.sum(grid * grid, axis=1)[None, :]
              - 2.0 * (Xc @ grid.T))
        dist = jnp.sqrt(jnp.maximum(d2, 0.0))
        mindist = jnp.min(jnp.where(unsafe[None, :], dist, jnp.inf), axis=1)
        any_unsafe = jnp.any(unsafe)
        for i in range(len(kernels)):
            fmin_i = fmin[i]
            uc = jnp.take(Q[:, 2 * i + 1], grid_idx)
            pred_i = any_unsafe & (uc - lipschitz[i] * mindist >= fmin_i)
            pred &= jnp.where(fmin_i == -jnp.inf, True, pred_i)

    # A candidate with no constrained GP at all is never an expander
    # (the reference's G_safe starts False and is only ever set inside
    # the per-constraint loop, gp_opt.py:547,570,602).
    pred &= jnp.any(fmin > -jnp.inf)
    return pred & valid


def _next_chunk(remaining, width, chunk):
    """Pop the next ``chunk`` candidates in reference visit order.

    Order is (width descending, grid index descending among exact
    ties) — exactly what the reference's reversed ascending argsort
    yields (gp_opt.py:542-552). One hierarchical ``partial_top_k``
    (ops/topk.py; bit-identical to ``lax.top_k``) over the *flipped*
    key array: top_k breaks
    ties toward the lower index, so flipping makes ties resolve to the
    larger original grid index — exact reference order without a full
    O(N log N) sort (the search almost always ends within the first
    chunk).
    """
    N = width.shape[0]
    key = jnp.where(remaining, width, -jnp.inf)
    vals, ridx = partial_top_k(jnp.flip(key), chunk)
    idxs = (N - 1 - ridx).astype(jnp.int32)
    valids = vals > -jnp.inf
    remaining = remaining.at[idxs].set(False)   # already-False for pads
    return remaining, idxs, valids


_EXPANDER_PREFETCH = 16384


def _find_first_expander(kernels, states, grid, Q, unsafe, mus, sigmas, Vs,
                         fmin, beta, lipschitz, cand, width, chunk,
                         prefetch=_EXPANDER_PREFETCH):
    """Walk candidates in visit order, chunk by chunk, early-exiting.

    Replicates the sequential early-exit semantics of
    gp_opt.py:557-612: the selected expander is the first candidate in
    descending-width order whose predicate holds.

    The visit order is fixed before the walk starts, so re-deriving the
    next chunk with a full-grid ``partial_top_k`` every round is wasted
    work for any search that runs more than one round — the exhaustion
    case (no expander exists, every candidate visited) paid it once per
    chunk. The first chunk still comes from one ``partial_top_k`` (the
    search almost always ends there, and the O(N) compaction below
    costs more than one select). If the
    walk must continue, a ``lax.cond`` inside the loop body fires ONCE
    to compact the remaining (data-dependent, usually small) candidate
    set with a cumsum scatter — O(N) elementwise, no full sort — and
    sort the <= ``prefetch`` survivors by the exact reference
    comparator (width descending, larger grid index on ties,
    gp_opt.py:542-552); each later round then just slices the next
    ``chunk`` indices from the buffer. When more than ``prefetch``
    candidates remain (early iterations of a fresh run at most), the
    compacted prefix would be grid-order- not width-order-complete, so
    the walk stays on the masked top_k-per-round path — bit-identical
    either way.

    Everything runs in ONE ``lax.while_loop`` whose body contains the
    ONE traced copy of the (large: full-grid matmuls)
    chunk predicate; round selection and the buffer build live in
    small conds. A previous three-copy structure (separate round-0 /
    buffered / masked loops) compiled ~1.5x slower across the suite.
    """
    N = grid.shape[0]
    chunk = min(chunk, N)
    # A chunk multiple, so every dynamic_slice below starts in bounds
    # (a clamped slice would misalign positions against the validity
    # mask and silently skip tail candidates).
    B = -(-min(max(prefetch, chunk), N) // chunk) * chunk
    i32 = jnp.int32

    def build_buffer(remaining):
        """Compact remaining candidates, sorted in reference order."""
        n_rest = jnp.sum(remaining).astype(i32)
        pos = jnp.cumsum(remaining.astype(i32)) - 1
        slot = jnp.where(remaining & (pos < B), pos, B)
        cw = jnp.full((B + 1,), -jnp.inf, width.dtype).at[slot].set(
            jnp.where(remaining, width, -jnp.inf))[:B]
        ci = jnp.full((B + 1,), 0, i32).at[slot].set(
            jnp.arange(N, dtype=i32))[:B]
        # Reference visit order: width descending, larger grid index on
        # exact ties — ascending lexicographic sort on (-width, -index).
        _, _, sidx = jax.lax.sort((-cw, -ci, ci), num_keys=2)
        # limit < 0 keeps the masked top_k mode (buffer would be
        # incomplete); otherwise later rounds slice sidx.
        limit = jnp.where(n_rest <= B, n_rest, -1)
        return sidx, limit

    def cond(carry):
        remaining, buf, limit, p, r, found, winner = carry
        more = jnp.where(limit >= 0, p < limit, jnp.any(remaining))
        return (~found) & more

    def body(carry):
        remaining, buf, limit, p, r, _, winner = carry
        buffered = limit >= 0

        def from_buffer(_):
            gidx = jax.lax.dynamic_slice(buf, (p,), (chunk,))
            valid = p + jnp.arange(chunk) < limit
            return remaining, gidx, valid

        def from_topk(_):
            return _next_chunk(remaining, width, chunk)

        remaining, gidx, valid = jax.lax.cond(
            buffered, from_buffer, from_topk, None)
        pred = _chunk_expander_predicate(
            kernels, states, grid, Q, unsafe, mus, sigmas, Vs, fmin,
            beta, lipschitz, gidx, valid)
        found = jnp.any(pred)
        first = jnp.argmax(pred)                 # first True in chunk order
        winner = jnp.where(found, gidx[first], winner)
        p = p + jnp.where(buffered, chunk, 0)

        # After a failed round 0 with candidates left: build the sorted
        # buffer once (skipped entirely when round 0 succeeds).
        buf, limit = jax.lax.cond(
            (r == 0) & ~found & jnp.any(remaining),
            lambda rem: build_buffer(rem),
            lambda rem: (buf, limit), remaining)
        return remaining, buf, limit, p, r + 1, found, winner

    init = (cand, jnp.zeros((B,), i32), jnp.asarray(-1, i32),
            jnp.asarray(0, i32), jnp.asarray(0, i32),
            jnp.asarray(False), jnp.asarray(0, i32))

    def run_walk(_):
        *_, found, winner = jax.lax.while_loop(cond, body, init)
        return found, winner

    def no_unsafe(_):
        return jnp.asarray(False), jnp.asarray(0, i32)

    # With zero unsafe points the predicate is provably false for every
    # candidate (both variants reduce to ``any(unsafe & ...)`` per
    # constrained GP — gp_opt.py:598-606 finds no unsafe point to lift,
    # gp_opt.py:570 has no distance to beat), so the whole exhaustion
    # walk — up to |candidates|/chunk full-grid passes — collapses to
    # one scalar reduction. This is the common case once a run has
    # explored its reachable safe region.
    found, winner = jax.lax.cond(jnp.any(unsafe), run_walk, no_unsafe,
                                 None)
    G = jnp.zeros((N,), dtype=bool).at[winner].set(found)
    return G


# ---------------------------------------------------------------------------
# query selection
# ---------------------------------------------------------------------------

def _select_query(Q, S, M, G, scaling, ucb: bool):
    """Masked argmax (first max in grid order, like np.argmax)."""
    if ucb:
        value = jnp.where(S, Q[:, 1], -jnp.inf)
    else:
        l = Q[:, 0::2]
        u = Q[:, 1::2]
        width = jnp.max((u - l) / scaling, axis=1)
        value = jnp.where(M | G, width, -jnp.inf)
    return jnp.argmax(value)


# ---------------------------------------------------------------------------
# public fused steps
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("ucb", "use_lipschitz", "chunk"))
@with_matmul_precision
def safeopt_step(kernels: Tuple[Kernel, ...], states: Tuple[GPState, ...],
                 grid: jnp.ndarray, fmin: jnp.ndarray, beta: jnp.ndarray,
                 scaling: jnp.ndarray, threshold: jnp.ndarray,
                 lipschitz=None, num_valid=None, *, ucb: bool = False,
                 use_lipschitz: bool = False,
                 chunk: int = 64) -> StepResult:
    """One full SafeOpt iteration over the candidate grid.

    Fuses the reference call stack optimize() -> update_confidence_
    intervals -> compute_sets -> get_new_query_point (SURVEY.md
    section 3.1) into a single compiled program. ``num_valid`` masks
    padding rows appended for even multi-chip sharding.
    """
    N = grid.shape[0]
    valid = (jnp.ones((N,), bool) if num_valid is None
             else jnp.arange(N) < num_valid)
    Q, mus, sigmas, Vs = _confidence_intervals(kernels, states, grid, beta)
    S, M, cand, width, has_safe = _classify(
        Q, fmin, scaling, threshold, beta, valid)

    if ucb:
        G = jnp.zeros_like(S)
        M = jnp.zeros_like(S)   # ucb never populates M/G (gp_opt.py:670-671)
    else:
        lip = lipschitz if use_lipschitz else None
        G = _find_first_expander(kernels, states, grid, Q, valid & ~S, mus,
                                 sigmas, Vs, fmin, beta, lip, cand, width,
                                 chunk)

    next_idx = _select_query(Q, S, M, G, scaling, ucb)
    return _pack_result(Q, S, M, G, next_idx, has_safe)


@jax.jit
@with_matmul_precision
def safe_maximum(kernels, states, grid, fmin, beta, num_valid=None):
    """Best safe point by objective lower bound (gp_opt.py:677-712).

    Returns (idx, lower_bound, has_safe, Q, S, diag); host strips
    context columns. ``diag`` packs [idx, lower_bound, has_safe] into
    one small buffer in the grid dtype so the host needs a single
    device pull (idx is exact as a float for N < 2^24 in f32; callers
    with larger grids fall back to pulling idx separately).
    """
    N = grid.shape[0]
    valid = (jnp.ones((N,), bool) if num_valid is None
             else jnp.arange(N) < num_valid)
    Q, _, _, _ = _confidence_intervals(kernels, states, grid, beta)
    l = Q[:, 0::2]
    S = jnp.all(l > fmin, axis=1) & valid
    value = jnp.where(S, Q[:, 0], -jnp.inf)
    idx = jnp.argmax(value)
    has_safe = jnp.any(S)
    diag = jnp.stack([idx.astype(Q.dtype), value[idx],
                      has_safe.astype(Q.dtype)])
    return idx, value[idx], has_safe, Q, S, diag


@partial(jax.jit, static_argnames=("use_lipschitz", "chunk"))
@with_matmul_precision
def full_expander_sets(kernels, states, grid, fmin, beta, scaling,
                       lipschitz=None, num_valid=None, *,
                       use_lipschitz: bool = False, chunk: int = 64):
    """Plotting variant: evaluate the predicate for every safe point.

    Reference ``compute_sets(full_sets=True)`` (gp_opt.py:527-555): the
    candidate set is all of S (including M), unfiltered and unsorted.
    Accepts the same ``num_valid`` padding mask as ``safeopt_step`` so
    the fused entry points stay consistent on sharded grids.
    """
    N = grid.shape[0]
    valid = (jnp.ones((N,), bool) if num_valid is None
             else jnp.arange(N) < num_valid)
    Q, mus, sigmas, Vs = _confidence_intervals(kernels, states, grid, beta)
    l = Q[:, 0::2]
    u = Q[:, 1::2]
    S = jnp.all(l > fmin, axis=1) & valid
    has_safe = jnp.any(S)
    l0, u0 = l[:, 0], u[:, 0]
    best_l0 = jnp.max(jnp.where(S, l0, -jnp.inf))
    M = S & (u0 >= best_l0) & has_safe

    lip = lipschitz if use_lipschitz else None
    num_chunks = -(-N // chunk)
    unsafe = valid & ~S

    def body(k, G):
        offs = k * chunk + jnp.arange(chunk)
        in_range = (offs < N) & jnp.take(S, jnp.minimum(offs, N - 1))
        gidx = jnp.minimum(offs, N - 1)
        pred = _chunk_expander_predicate(
            kernels, states, grid, Q, unsafe, mus, sigmas, Vs, fmin, beta,
            lip, gidx, in_range)
        return G.at[gidx].set(pred | G[gidx])

    G = jax.lax.fori_loop(0, num_chunks, body,
                          jnp.zeros((N,), dtype=bool))
    G = G & has_safe
    return _pack_result(Q, S, M, G, jnp.asarray(0, jnp.int32), has_safe)


# ---------------------------------------------------------------------------
# boundary-certified decisions (exact_boundaries mode)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k",))
@with_matmul_precision
def boundary_scan(kernels, states, grid, fmin, beta, scaling, band,
                  num_valid=None, *, k: int = 128):
    """Pass 1 of a certified iteration: intervals + boundary triage.

    On-device f32 interval bounds carry ~1e-4 noise on large grids
    (chip_smoke.py measures it against float64); a point whose
    scaled safety margin ``min_i |l_i - fmin_i| / scaling_i`` falls
    inside ``band`` may be classified either way by any f32
    implementation. This pass returns
    the full interval matrix Q plus the (up to) ``k`` grid indices
    closest to a safety threshold, so the host can recompute exactly
    those in float64 (gp/host_math.HostFactor.predict) and pass the
    certified bits to ``safeopt_step_from_Q``.

    Returns ``(Q, idx (k,), within (k,) bool, total_within () int)``;
    ``total_within > k`` means the band overflowed the triage budget.
    """
    N = grid.shape[0]
    valid = (jnp.ones((N,), bool) if num_valid is None
             else jnp.arange(N) < num_valid)
    Q, _, _, _ = _confidence_intervals(kernels, states, grid, beta)
    l = Q[:, 0::2]
    constrained = fmin > -jnp.inf
    margins = jnp.abs(l - fmin) / scaling
    margins = jnp.where(constrained[None, :], margins, jnp.inf)
    margin = jnp.min(margins, axis=1)
    margin = jnp.where(valid, margin, jnp.inf)

    neg, idx = partial_top_k(-margin, k)
    within = (-neg) < band
    total_within = jnp.sum(margin < band)
    return Q, idx.astype(jnp.int32), within, total_within


@partial(jax.jit, static_argnames=("ucb", "use_lipschitz", "chunk"))
@with_matmul_precision
def safeopt_step_from_Q(kernels, states, grid, Q, fix_idx, fix_bits,
                        fmin, beta, scaling, threshold, lipschitz=None,
                        num_valid=None, *, ucb: bool = False,
                        use_lipschitz: bool = False,
                        chunk: int = 64) -> StepResult:
    """Pass 2 of a certified iteration: classification from given Q.

    Identical to ``safeopt_step`` except the intervals come from pass 1
    and the safe bits at ``fix_idx`` (entries < 0 are padding) are
    OVERRIDDEN by the host's float64 verdicts before maximizers,
    expanders and the query point are derived. The per-GP posterior
    moments the expander needs are recovered from Q exactly
    (mu = (l+u)/2, sigma = (u-l)/(2 beta)).
    """
    N = grid.shape[0]
    valid = (jnp.ones((N,), bool) if num_valid is None
             else jnp.arange(N) < num_valid)
    l = Q[:, 0::2]
    u = Q[:, 1::2]
    mus = [(l[:, i] + u[:, i]) * 0.5 for i in range(l.shape[1])]
    sigmas = [(u[:, i] - l[:, i]) / (2.0 * beta) for i in range(l.shape[1])]
    Vs = [None] * l.shape[1]

    S = jnp.all(l > fmin, axis=1) & valid
    # scatter the certified bits (padded entries rewrite their own value)
    safe_idx = jnp.maximum(fix_idx, 0)
    cur = S[safe_idx]
    new = jnp.where(fix_idx >= 0,
                    fix_bits & jnp.take(valid, safe_idx), cur)
    S = S.at[safe_idx].set(new)

    S, M, cand, width, has_safe = _classify(
        Q, fmin, scaling, threshold, beta, valid, S=S)

    if ucb:
        G = jnp.zeros_like(S)
        M = jnp.zeros_like(S)
    else:
        lip = lipschitz if use_lipschitz else None
        G = _find_first_expander(kernels, states, grid, Q, valid & ~S, mus,
                                 sigmas, Vs, fmin, beta, lip, cand, width,
                                 chunk)

    next_idx = _select_query(Q, S, M, G, scaling, ucb)
    return _pack_result(Q, S, M, G, next_idx, has_safe)


# ---------------------------------------------------------------------------
# one-dispatch certified iteration (optimistic two-pass protocol)
# ---------------------------------------------------------------------------

def _moments_from_Q(Q, beta):
    """Per-GP (mu, sigma) recovered exactly from interval columns."""
    l = Q[:, 0::2]
    u = Q[:, 1::2]
    mus = [(l[:, i] + u[:, i]) * 0.5 for i in range(l.shape[1])]
    sigmas = [(u[:, i] - l[:, i]) / (2.0 * beta) for i in range(l.shape[1])]
    return mus, sigmas


def _safety_margin(Q, fmin, scaling, valid):
    """Scaled distance of each row's lower bounds to a safety threshold."""
    l = Q[:, 0::2]
    constrained = fmin > -jnp.inf
    margins = jnp.abs(l - fmin) / scaling
    margins = jnp.where(constrained[None, :], margins, jnp.inf)
    return jnp.where(valid, jnp.min(margins, axis=1), jnp.inf)


def _refine_Q(kernels, states, grid, Q, fmin, beta, scaling, valid,
              rk: int, band_k: int, refine_band):
    """Recompute the decision-critical rows of a reduced-precision Q at
    full MATMUL_PRECISION and scatter them back in.

    Used by the reduced-precision certified mode: the full-grid
    interval pass ran at reduced matmul precision, and every interval
    that any decision boundary touches must come from full-precision
    values. Selection is ONE top-(band_k + rk) over a single
    boundary-proximity key — the pointwise max of per-boundary scores,
    each 0 at its decision boundary and negative away from it, all in
    scaled units so they are commensurate:

    - ``-margin``: closeness to a safety threshold. ``band_k`` sizes
      this share of the budget to swallow the ENTIRE reduced-precision
      safety ambiguity band (``refine_band``, default 1e-2 — above the
      7.3e-3 max scaled 3-pass error measured on the retired chip, not
      this one),
      so after the scatter every near-boundary safe bit is f32-highest
      quality and the downstream float64 certification band can stay
      at its usual narrow width (~1e-3);
    - with ``rk`` (the trajectory-identity head), three more scores
      over SAFE rows only: (a) scaled interval width relative to the
      current safe maximum (selection argmax, ``max_var``, the
      expander visit-order head — all live inside S, and unexplored
      rows at prior-level sigma fill the global width top, so the
      mask is essential), (b) objective lower bound relative to the
      incumbent ``best_l0``, and (c) distance of the objective upper
      bound to ``best_l0`` (the maximizer boundary). ``rk`` must cover
      the reduced-precision noise band AROUND each boundary, not just
      the winner: measured on the retired chip (not this one) at the
      cap512 bench config, 3-pass noise
      (~1e-3 on u) flips maximizer membership at rows within ~2e-3 of
      ``best_l0`` (26 rows of 3,796 maximizers) and reorders the
      expander walk at adjacent widths (gap ~5e-4); the default
      rk=2048 covers the measured tens-of-rows populations with two
      orders of magnitude of slack.

    The max-combined key makes the budget shared and the overflow
    check uniform: the returned population counts rows within
    ``refine_band`` of ANY boundary, and whenever it fits the
    (band_k + rk) budget the top-k provably contains every such row
    (any displacing row is itself in-band and counted). This is
    strictly better coverage-per-slot than per-criterion heads (a row
    2e-3 from the maximizer boundary always beats a row 0.3 below the
    width top) at a quarter of the full-grid top_k sweeps. Scope of
    the provable contract: it covers exactly the three head
    boundaries above (safety margin, safe-max width, best_l0 /
    maximizer proximity). Decision-relevant comparisons away from
    those boundaries — the ``max_var`` candidate cutoff in
    ``_classify``, the ``threshold*beta`` cut, and adjacent-width
    reorderings deep in the expander walk — score far from 0 in the
    combined key and are NOT promised refinement; trajectory identity
    there stays empirically gated (bench.py's cap512-certified
    strict-trajectory gate, same status as the old rank-based heads).

    Cost: a (band_k + rk)-point exact posterior per GP — (cap, cap)
    x (cap, P) matmuls, small next to the grid pass it replaces.
    """
    l = Q[:, 0::2]
    u = Q[:, 1::2]

    margin = _safety_margin(Q, fmin, scaling, valid)
    key = -margin
    if rk:
        S0 = jnp.all(l > fmin, axis=1) & valid
        # Combined head over SAFE rows only: maximizers, expander
        # candidates and the selection argmax all live inside S, and
        # unexplored rows at prior-level sigma occupy the entire
        # global top of the width order (the first expander of the
        # cap512 bench ranked ~427,000th globally but 0th among
        # candidates), so a global head never reaches them.
        widths = jnp.max((u - l) / scaling, axis=1)
        s_w = widths - jnp.max(jnp.where(S0, widths, -jnp.inf))
        l0s = l[:, 0] / scaling[0]
        best_l0 = jnp.max(jnp.where(S0, l0s, -jnp.inf))
        s_l = l0s - best_l0
        s_m = -jnp.abs(u[:, 0] / scaling[0] - best_l0)
        head = jnp.maximum(jnp.maximum(s_w, s_l), s_m)
        key = jnp.maximum(key, jnp.where(S0, head, -jnp.inf))
    _, idx = partial_top_k(key, min(band_k + rk, key.shape[0]))
    # Uniform overflow contract: EVERY row within ``refine_band`` of
    # ANY decision boundary (safety threshold or, with ``rk``, a
    # global-threshold head boundary) must be selected. If the
    # population fits the budget, the top-(band_k + rk) provably
    # contains it (any displacing row is itself in-band and counted);
    # callers compare the returned population against band_k + rk.
    band_pop = jnp.sum(key > -refine_band)
    pts = jnp.take(grid, idx, axis=0)
    cols = []
    for kern, st in zip(kernels, states):
        mu, var, _ = _posterior_with_V(kern, st, pts)
        sig = jnp.sqrt(var)
        cols.append(mu - beta * sig)
        cols.append(mu + beta * sig)
    return Q.at[idx].set(jnp.stack(cols, axis=1)), band_pop, idx


@partial(jax.jit, static_argnames=("k", "refine_k", "refine_band_k", "ucb",
                                   "use_lipschitz", "chunk",
                                   "interval_precision"))
def certified_scan(kernels, states, grid, fmin, beta, scaling, threshold,
                   band, lipschitz=None, num_valid=None, refine_band=None,
                   *, k: int = 128, refine_k: int = 0,
                   refine_band_k: int = 0, ucb: bool = False,
                   use_lipschitz: bool = False, chunk: int = 64,
                   interval_precision=None):
    """Pass 1 of an *optimistic* certified iteration, in ONE dispatch.

    Runs the complete fused step (identical decisions to
    ``safeopt_step``) AND the float64 boundary triage in the same
    compiled program, returning ``(StepResult, packed)`` where
    ``packed`` is a single int32 buffer
    ``[diag(5), total_within, refine_pop, idx(k), within(k),
    S[idx](k)]`` — one host pull tells the caller everything: the step
    outcome, which rows sit inside the f32 ambiguity band, the f32
    safe verdicts at those rows, and (reduced-precision mode) how many
    rows the refinement band held. When the band is empty, or the host
    float64 oracle confirms every in-band verdict, pass 1 IS the
    certified result and no second dispatch happens (the common case
    once a run converges); only an actual flip pays the
    ``safeopt_step_from_Q`` correction.

    ``interval_precision`` (static; ``'default'`` = 1-pass bf16) runs
    the full-grid interval pass at reduced matmul precision and
    then restores full precision on the (data-chosen,
    in-program) decision-critical rows via ``_refine_Q`` before
    anything is classified: the whole reduced-precision safety
    ambiguity band (``refine_band`` wide, top-``refine_band_k`` rows)
    plus the global-threshold rows (top-``refine_k`` per criterion).
    Safe-set decisions remain f64-exact through the (narrow, ~1e-3)
    certification band exactly as in full-precision mode, because
    every near-boundary row was already restored to full precision.
    Reference behavior protected: the strict interval comparisons of
    /root/reference/safeopt/gp_opt.py:478-481.
    """
    from ..config import MATMUL_PRECISION

    N = grid.shape[0]
    valid = (jnp.ones((N,), bool) if num_valid is None
             else jnp.arange(N) < num_valid)

    Q, mus, sigmas, Vs, refine_pop, refined_idx = _scan_intervals(
        kernels, states, grid, fmin, beta, scaling, valid, band,
        refine_band, refine_k, refine_band_k, interval_precision)

    with jax.default_matmul_precision(MATMUL_PRECISION):
        S, M, cand, width, has_safe = _classify(
            Q, fmin, scaling, threshold, beta, valid)

        if ucb:
            G = jnp.zeros_like(S)
            M = jnp.zeros_like(S)
        else:
            lip = lipschitz if use_lipschitz else None
            G = _find_first_expander(kernels, states, grid, Q, valid & ~S,
                                     mus, sigmas, Vs, fmin, beta, lip,
                                     cand, width, chunk)

        next_idx = _select_query(Q, S, M, G, scaling, ucb)
        res = _pack_result(Q, S, M, G, next_idx, has_safe)

        idx, within, total_within = _band_triage(
            Q, refined_idx, fmin, scaling, valid, band, k)
        packed = jnp.concatenate([
            res.diag, total_within.astype(jnp.int32)[None],
            refine_pop.astype(jnp.int32)[None],
            idx.astype(jnp.int32), within.astype(jnp.int32),
            S[idx].astype(jnp.int32)])
    return res, packed


def _scan_intervals(kernels, states, grid, fmin, beta, scaling, valid,
                    band, refine_band, refine_k, refine_band_k,
                    interval_precision):
    """Shared pass-1 interval machinery of the certified paths: the
    full-grid interval pass at the requested precision, then (reduced-
    precision mode) the unified full-precision refinement. Returns
    ``(Q, mus, sigmas, Vs, refine_pop, refined_idx)``."""
    from ..config import MATMUL_PRECISION

    with jax.default_matmul_precision(interval_precision
                                      or MATMUL_PRECISION):
        Q, mus, sigmas, Vs = _confidence_intervals(kernels, states, grid,
                                                   beta)

    with jax.default_matmul_precision(MATMUL_PRECISION):
        refine_pop = jnp.asarray(0, jnp.int32)
        refined_idx = None
        if interval_precision is not None and (refine_k or refine_band_k):
            rband = (band if refine_band is None else refine_band)
            Q, refine_pop, refined_idx = _refine_Q(
                kernels, states, grid, Q, fmin, beta, scaling, valid,
                refine_k, max(refine_band_k, 1), rband)
            mus, sigmas = _moments_from_Q(Q, beta)
            Vs = [None] * len(mus)
    return Q, mus, sigmas, Vs, refine_pop, refined_idx


def _band_triage(Q, refined_idx, fmin, scaling, valid, band, k):
    """Top-k rows by closeness to a safety threshold, flagged when
    inside the f64 certification band. Over the refined subset in
    reduced-precision mode (every possible in-band row was refined, so
    one small top_k replaces a second full-grid sweep)."""
    if refined_idx is not None and refined_idx.shape[0] >= k:
        sub = _safety_margin(Q[refined_idx], fmin, scaling,
                             jnp.ones((refined_idx.shape[0],), bool))
        sub = jnp.where(jnp.take(valid, refined_idx), sub, jnp.inf)
        neg, j = partial_top_k(-sub, k)
        idx = jnp.take(refined_idx, j)
        within = (-neg) < band
        total_within = jnp.sum(sub < band)
    else:
        margin = _safety_margin(Q, fmin, scaling, valid)
        neg, idx = partial_top_k(-margin, k)
        within = (-neg) < band
        total_within = jnp.sum(margin < band)
    return idx, within, total_within


@partial(jax.jit, static_argnames=("k", "refine_k", "refine_band_k",
                                   "interval_precision"))
def interval_scan(kernels, states, grid, fmin, beta, scaling, band,
                  num_valid=None, refine_band=None, *, k: int = 128,
                  refine_k: int = 0, refine_band_k: int = 0,
                  interval_precision=None):
    """Pass 1 of the DEVICE-ORACLE certified iteration: intervals
    (+ reduced-precision refinement) + band triage — NO classification.

    The host-oracle protocol classifies in pass 1 and re-classifies in
    the correction whenever a knife-edge verdict flips; on workloads
    where band rows genuinely straddle the f32/f64 boundary (on the
    retired chip, ~50 of 1,400 band rows at cap512, every iteration)
    that redundant classify+expander+select pass is paid forever.
    The device-oracle pipeline instead classifies ONCE, after the f64
    verdicts exist: ``interval_scan -> device_oracle ->
    certified_finish``, all chained on device, one diagnostics pull.

    Returns ``(Q, packed_t)`` with
    ``packed_t = [total_within, refine_pop, idx(k), within(k)]`` (i32).
    """
    N = grid.shape[0]
    valid = (jnp.ones((N,), bool) if num_valid is None
             else jnp.arange(N) < num_valid)
    from ..config import MATMUL_PRECISION

    Q, _, _, _, refine_pop, refined_idx = _scan_intervals(
        kernels, states, grid, fmin, beta, scaling, valid, band,
        refine_band, refine_k, refine_band_k, interval_precision)
    with jax.default_matmul_precision(MATMUL_PRECISION):
        idx, within, total_within = _band_triage(
            Q, refined_idx, fmin, scaling, valid, band, k)
        packed_t = jnp.concatenate([
            total_within.astype(jnp.int32)[None],
            refine_pop.astype(jnp.int32)[None],
            idx.astype(jnp.int32), within.astype(jnp.int32)])
    return Q, packed_t


# ---------------------------------------------------------------------------
# on-device float64 knife-edge oracle (round 5)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("kinds", "constrained", "k"))
def device_oracle(kernels, ostates, grid, Q, packed_t, fmin, beta, *,
                  kinds, constrained, k: int):
    """Settle the certified band's safe verdicts in float64 ON DEVICE.

    The host-oracle protocol costs, per iteration with flips: one
    round trip to pull the packed band buffer, a host f64 predict, a
    correction dispatch, and a second round trip for its diagnostics.
    This program removes every host touch: it consumes
    ``interval_scan``'s triage buffer *as a device array*, recomputes
    the <=k in-band rows' lower bounds at float64 against each model's
    :class:`OracleState` (the SAME f64 factors the host oracle uses, in
    the GPU's native float64), and emits the fix bits
    ``certified_finish`` classifies with. Decisions match the host
    oracle except on ~1e-15-relative knife edges (accumulation order);
    ``chip_smoke.py`` checks device against host verdicts at cap512.

    Trace and dispatch under ``jax.enable_x64(True)``. ``kinds`` picks
    each model's mu formula ('exact': ``V^T w``; 'sparse':
    ``k^T alpha`` — mirroring ``predict_f64`` exactly);
    ``constrained`` statically skips unconstrained GPs like the host
    loop does. ``flips`` (pass-1 f32 verdict vs f64) is telemetry,
    computed here from the gathered Q rows.

    Reference contract: the f64 exactness of near-threshold
    ``compute_safe_set`` decisions (gp_opt.py:478-481).
    """
    idx = packed_t[2:2 + k]
    within = packed_t[2 + k:2 + 2 * k] > 0

    pts = grid[jnp.maximum(idx, 0)].astype(jnp.float64)
    l_rows = Q[jnp.maximum(idx, 0), 0::2]               # f32 pass-1 l
    safe64 = jnp.ones((k,), bool)
    s_f32 = jnp.ones((k,), bool)
    for i, (kern, st, kind) in enumerate(zip(kernels, ostates, kinds)):
        if not constrained[i]:
            continue
        cap = st.capacity
        mask = (jnp.arange(cap) < st.count).astype(jnp.float64)
        kvec = kern.K(st.X, pts) * mask[:, None]          # (cap, k) f64
        V = st.F @ kvec
        if kind == "sparse":
            mu = kvec.T @ st.alpha
        else:
            mu = V.T @ st.w
        var = kern.Kdiag(pts) - jnp.sum(V * V, axis=0)
        l64 = mu - beta * jnp.sqrt(jnp.maximum(var, 0.0))
        safe64 &= l64 > fmin[i]
        s_f32 &= l_rows[:, i] > fmin[i].astype(l_rows.dtype)

    fix_idx = jnp.where(within, idx, -1).astype(jnp.int32)
    fix_bits = within & safe64
    flips = jnp.sum(within & (safe64 != s_f32)).astype(jnp.int32)
    n_within = jnp.sum(within).astype(jnp.int32)
    return fix_idx, fix_bits, flips, n_within


@partial(jax.jit, static_argnames=("ucb", "use_lipschitz", "chunk"))
def certified_finish(kernels, states, grid, Q, packed_t, fix_idx,
                     fix_bits, flips, n_within, fmin, beta, scaling,
                     threshold, lipschitz=None, num_valid=None, *,
                     ucb: bool = False, use_lipschitz: bool = False,
                     chunk: int = 64):
    """Pass 3 of the device-oracle certified iteration: classify ONCE
    with the f64-settled safe bits scattered in (the
    ``safeopt_step_from_Q`` protocol), then pack the caller's stats
    into one 9-int diagnostics buffer
    ``[has_safe, next_idx, |S|, |M|, anyG, flips, total_within,
    refine_pop, n_within]`` — the certified path's ONLY host pull,
    same count as the plain step's."""
    res = safeopt_step_from_Q(
        kernels, states, grid, Q, fix_idx, fix_bits, fmin, beta,
        scaling, threshold, lipschitz, num_valid, ucb=ucb,
        use_lipschitz=use_lipschitz, chunk=chunk)
    diag9 = jnp.concatenate([
        res.diag, flips[None], packed_t[0:1], packed_t[1:2],
        n_within[None]])
    return res, diag9
