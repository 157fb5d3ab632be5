"""Windowed-group merge cascade: k-way merge of pre-sorted lists in XLA.

The merge engine of the rolling-window grouped quantile (reference
``base.py:261-265`` + ``nbutils.quantile``): a 31-day window amplifies the
sort workload 31x because every value participates in 31 groups.  Instead of
re-sorting the amplified gather matrix, each day-of-year's per-year list is
sorted ONCE (1x data, short rows), and each group's ``window`` pre-sorted
lists are merged by a bitonic merge cascade.

The cascade uses only roll + iota-mask + min/max.  The reverse a bitonic
merge classically needs is moved to data prep: input rows alternate sort
direction by row parity (odd rows sorted DESCENDING, see
:func:`alternate_row_directions`), making every concatenated pair bitonic;
each cascade level then emits runs with alternating directions, so no
in-cascade reverse is needed.

Padding is +inf (not NaN): min/max networks are NaN-unsafe, and +inf-last
ordering equals XLA's NaN-last sort order for finite data.  Valid counts are
tracked separately (see ``ops.quantile.windowed_group_quantile``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["alternate_row_directions", "merged_window_rows_xla"]


def _merge_cascade(x):
    """[..., W, m] runs with row-parity-alternating directions -> [..., W*m]
    ascending.  ``W``, ``m`` powers of two; either phase (even rows ascending
    or even rows descending) is accepted — a pair of opposite-direction runs
    is bitonic either way.

    Sign-space formulation: a descending run of ``x`` equals the negation of
    an ascending run of ``-x``, so instead of the direction-masked double
    min/max network, whole pairs that must emit descending are *negated* and
    every level runs the cheap ascending-only merge (5 vec-ops/stage vs 9).
    Odd runs then sit in storage negated; the next level's entry negation
    folds the store-sign and the new pair-sign into ONE select-negate per
    level: level 0 negates whole odd pairs ([+,+,-,-] by row), later levels
    negate (pair parity) XOR (upper half) ([+,-,-,+]).  Signs cancel exactly
    at the final (ascending, pair-parity 0) level, so the output values are
    identical to the masked form (up to ±0.0 tie placement, which quantile
    extraction cannot observe).

    Grid layout: the runs stay [W, m] throughout (a run of flat length
    ``R*m`` occupies ``R`` consecutive rows, row-major), so every
    compare-exchange roll moves data along EITHER the short row axis (stage
    stride >= m) OR a single m-wide lane axis (stage stride < m) — never a
    W*m-wide axis.  The flat ascending result IS the row-major [W, m] block,
    so the final reshape is free.
    """
    W = x.shape[-2]
    for j in range(W.bit_length() - 1):  # log2(W) merge levels
        x = _cascade_level(x, j)
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _cascade_level(x, j: int):
    """One level of the grid cascade on [..., R, m]: entry sign negation for
    level ``j`` (runs of ``2**j`` rows pair into ``2**(j+1)``-row runs), then
    the ascending-only row- and lane-stride compare-exchange stages.  Works
    on any row count (runs merge independently by the iota masks)."""
    m = x.shape[-1]
    row = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 2)
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    if j == 0:
        neg = ((row >> 1) & 1) == 1
    else:
        neg = (((row >> (j + 1)) ^ (row >> j)) & 1) == 1
    x = jnp.where(neg, -x, x)
    sr = 1 << j
    while sr >= 1:
        fwd = jnp.roll(x, -sr, axis=x.ndim - 2)
        bwd = jnp.roll(x, sr, axis=x.ndim - 2)
        is_low = (row & sr) == 0
        x = jnp.where(is_low, jnp.minimum(x, fwd), jnp.maximum(x, bwd))
        sr //= 2
    s = m // 2
    while s >= 1:
        fwd = jnp.roll(x, -s, axis=x.ndim - 1)
        bwd = jnp.roll(x, s, axis=x.ndim - 1)
        is_low = (lane & s) == 0
        x = jnp.where(is_low, jnp.minimum(x, fwd), jnp.maximum(x, bwd))
        s //= 2
    return x


def alternate_row_directions(s, axis_rows: int = -2):
    """Flip odd rows of ascending-sorted lists to descending (the merge
    cascade's alternating-direction input layout)."""
    ridx = jnp.arange(s.shape[axis_rows]) % 2 == 1
    shape = [1] * s.ndim
    shape[axis_rows] = s.shape[axis_rows]
    return jnp.where(ridx.reshape(shape), jnp.flip(s, axis=-1), s)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.partial(jax.jit, static_argnames=("window", "n_groups", "out_width"))
def merged_window_rows_xla(s_pad, window: int, n_groups: int, out_width: int | None = None):
    """Merge each group's ``window`` consecutive pre-sorted rows.

    s_pad: [B, Dp, m] — per-(site, day) runs sorted ascending on even rows
    and DESCENDING on odd rows (see :func:`alternate_row_directions`), +inf
    padded, laid out so group ``g``'s window is rows ``[g, g+window)``;
    ``Dp`` must hold ``n_groups + next_pow2(window) - 1`` rows (the caller
    pads with +inf).  Returns [B, n_groups, out_width] merged ascending rows
    (+inf tails); ``out_width`` (default ``next_pow2(window) * m``) truncates
    the stored tail — positions past the maximum possible valid count are
    always +inf padding.
    """
    wpad = _next_pow2(window)
    base = jnp.arange(n_groups)[:, None] + jnp.arange(wpad)[None, :]  # [G, wpad]
    win = s_pad[:, base, :]  # [B, G, wpad, m]
    if wpad > window:
        win = jnp.where(jnp.arange(wpad)[None, None, :, None] >= window, jnp.inf, win)
    merged = _merge_cascade(win)
    return merged if out_width is None else merged[..., :out_width]
