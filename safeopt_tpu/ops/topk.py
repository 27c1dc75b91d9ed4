"""Exact partial top-k for long rows.

``jax.lax.top_k`` over one 1e6-element row may lower to a monolithic
sort-based select whose cost does not depend on ``k``, and the fused
SafeOpt step (safe_opt_core.py) needs such a
select for the expander visit order (reference
/root/reference/safeopt/gp_opt.py:542-552) and for the certified
boundary triage. ``partial_top_k`` replaces it with an exact two-level
hierarchy:

1. reshape the (``-inf``-padded) key row-major to ``(rows, cols)`` and
   take each row's top ``k`` — one *batched* top_k whose sort work
   vectorizes across rows;
2. merge with a single top_k of ``k`` over the ``rows * k`` survivors.

Exactness: with the total order "value descending, index ascending"
(``lax.top_k``'s tie rule), every element of the global top-k is among
its own row's top-k, so it survives level 1; and the merge comparator
``(value desc, flat position asc)`` coincides with the original
comparator on the survivor set, because per-row ranks are
index-ascending among equal values and row-major flat positions are
index-ascending across rows. The returned ``(values, indices)`` are
therefore IDENTICAL to ``lax.top_k``'s — including tie selection and
output order — which the golden lockstep tests rely on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["partial_top_k"]


def partial_top_k(key: jnp.ndarray, k: int, rows: int | None = None):
    """Exact ``lax.top_k(key, k)`` via a two-level hierarchy.

    ``key`` is a rank-1 array. Results (values and indices, ties included)
    match ``jax.lax.top_k`` bit-for-bit. ``rows=None`` picks the row count
    so level-1 rows hold ~max(2k, 256) columns (a choice not yet re-measured
    on the GPU). Falls back to the monolithic ``lax.top_k`` when the
    hierarchy cannot win: short rows (``cols < 2 * k`` — level 1 would
    nearly full-sort each row) or a tiny merge saving (``rows * k >= n //
    2``). The merge recurses, so very long keys select through three levels
    before the final small sort.
    """
    n = key.shape[0]
    if k >= n:
        return jax.lax.top_k(key, k)
    if rows is None:
        rows = max(1, n // max(2 * k, 256))
    cols = -(-n // rows)
    if cols < 2 * k or rows * k >= n // 2:
        return jax.lax.top_k(key, k)

    pad = rows * cols - n
    keyp = jnp.pad(key, (0, pad), constant_values=-jnp.inf)
    v1, i1 = jax.lax.top_k(keyp.reshape(rows, cols), k)     # (rows, k)
    base = (jnp.arange(rows, dtype=jnp.int32) * cols)[:, None]
    flat_idx = (base + i1.astype(jnp.int32)).reshape(-1)    # (rows * k,)
    v2, j = partial_top_k(v1.reshape(-1), k)
    # Padded slots can never surface: pads are -inf entries confined to
    # the LAST row's tail (highest flat positions), while row 0 alone
    # supplies k real candidates at flat positions 0..k-1 — under the
    # (value desc, flat position asc) order a pad loses every
    # comparison, even on fully--inf keys (where the output is row 0's
    # cols 0..k-1 = original indices 0..k-1, exactly lax.top_k's).
    return v2, jnp.take(flat_idx, j)
