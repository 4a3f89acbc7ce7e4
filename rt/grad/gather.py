"""One-hot matmul row gather — an alternative to XLA's element gathers.

The path-replay train step gathers one table row per pixel and bounce, and
the backward pass turns each gather into a scatter-add.  For the small
tables the replay graph reads (<=1K spheres/triangles, <=1K materials) the
gather can instead be a one-hot matmul:

    gathered = one_hot(idx, N) @ table        # (P, N) @ (N, C)

whose transpose — the gradient scatter-add onto the table — is ALSO a
matmul (``one_hot.T @ g``).  Whether it beats ``jnp.take`` depends on the
device; chip_smoke.py times both (``gather_mode="onehot"`` vs ``"take"``).

Exactness: every one-hot row holds a single 1.0; all other products are
exact zeros and the single surviving product is ``1.0 * x``.  The matmul
asks for ``Precision.HIGHEST``, so no reduced-precision (bf16/TF32) pass
can round ``x`` — the result is bit-equal to ``table[idx]`` (asserted in
tests/test_replay.py).

The pixel stream is processed in row blocks via ``lax.map`` so the one-hot
operand stays a few MB instead of P x N materialized at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Tables wider than this fall back to XLA's native gather: the one-hot
# operand (block x N) and its O(P*N) matmul zeros stop paying for themselves
# on large tables (lucy/dragon triangle tables are 20K-50K rows).
MAX_ONEHOT_ROWS = 4096


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray, *,
                block: int = 32768) -> jnp.ndarray:
    """``table[idx]`` (idx any shape, int32, already in-range) as a blocked
    one-hot matmul.  Returns shape ``idx.shape + (C,)``; bit-equal to the
    native gather, differentiable w.r.t. ``table``.

    Non-finite table entries are SAFE: a naive one-hot matmul would let a
    single NaN/Inf entry poison its column for EVERY gathered row (0.0 * NaN
    = NaN), whereas the native gather only affects rows that select it — and
    NaNs are reachable here (degenerate triangles get NaN face normals in
    the BVH build, rt/scene/bvh.py:136-139, and can appear transiently in
    apply_tri_params during vertex optimization).  The matmul therefore runs
    on a zero-sanitized table augmented with 0/1 non-finite masks (exact
    under a one-hot operand), and the selected rows' NaN/±Inf entries are
    reconstructed afterwards.  For all-finite tables the value columns are
    bit-identical to the unguarded matmul (same dot, same order); the extra
    mask columns ride the same matmul."""
    n, c = table.shape
    flat = idx.reshape(-1).astype(jnp.int32)
    p = flat.shape[0]
    iota = jax.lax.iota(jnp.int32, n)

    isnan = jnp.isnan(table)
    ispos = table == jnp.inf
    isneg = table == -jnp.inf
    san = jnp.where(isnan | ispos | isneg, jnp.zeros_like(table), table)
    aug = jnp.concatenate([san,
                           isnan.astype(table.dtype),
                           ispos.astype(table.dtype),
                           isneg.astype(table.dtype)], axis=1)

    def one_block(rows):
        oh = (rows[:, None] == iota[None, :]).astype(table.dtype)
        return jax.lax.dot(oh, aug,
                           precision=jax.lax.Precision.HIGHEST)

    if p <= block:
        out = one_block(flat)
    else:
        nb = -(-p // block)
        pad = nb * block - p
        if pad:
            flat = jnp.concatenate(
                [flat, jnp.zeros((pad,), jnp.int32)])
        out = jax.lax.map(one_block, flat.reshape(nb, block))
        out = out.reshape(nb * block, 4 * c)[:p]
    val = out[:, :c]
    # one-hot rows select exactly one table row, so the gathered masks are
    # exact 0.0/1.0 — reconstruct the non-finite entries per selected row
    val = jnp.where(out[:, c:2 * c] > 0.5, float("nan"), val)
    val = jnp.where(out[:, 2 * c:3 * c] > 0.5, float("inf"), val)
    val = jnp.where(out[:, 3 * c:] > 0.5, float("-inf"), val)
    return val.reshape(idx.shape + (c,))


def gather_rows_auto(table: jnp.ndarray, idx: jnp.ndarray, mode: str = "auto",
                     *, block: int = 32768) -> jnp.ndarray:
    """Policy wrapper: ``"onehot"`` forces the matmul path, ``"take"`` the XLA
    gather, ``"auto"`` picks onehot for tables up to MAX_ONEHOT_ROWS."""
    if mode == "take" or (mode == "auto" and table.shape[0] > MAX_ONEHOT_ROWS):
        return table[idx]
    return gather_rows(table, idx, block=block)
