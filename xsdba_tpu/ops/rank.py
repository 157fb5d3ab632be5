"""Average ranks with NaN handling, by sorting.

Replicates xarray/bottleneck ``nanrankdata`` semantics used by the reference
(``utils.py:575-646``): equal values get the average of their would-be ranks,
ranks start at 1, NaNs stay NaN; ``pct`` divides by the valid count.  The
reference then rescales pct ranks to span [0, 1] exactly
(``rnk = mx*(rnk-mn)/(mx-mn)``, ``utils.py:631-634``), which we reproduce.

Implementation: one sort + cumulative-max run labeling.  Equal values form
contiguous runs in the sorted order, and the average of consecutive integer
positions a..b is just (a+b)/2 — so tie-averaged ranks come from two
cummax scans over the sorted row, with no searchsorted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["average_rank", "pct_rank", "rank_pct_rescaled", "rank_pct_rescaled_with_sorted"]


def _rank_core(x):
    """Shared internals on a last-axis layout: returns
    (avg ranks [NaN where x is NaN], sorted values with NaNs last, NaN mask).

    One multi-operand ``lax.sort`` of (value, NaN flag, position), then a
    scatter of the run-averaged ranks back to the original positions (a
    pure permutation, so exact).  The sort's output IS the value-sorted
    row, so callers needing both ranks and quantiles of the same array get
    the sort for free (``rank_pct_rescaled_with_sorted``).
    """
    n = x.shape[-1]
    nan = jnp.isnan(x)
    key = jnp.where(nan, jnp.inf, x)
    # secondary key: NaNs sort AFTER genuine +inf values and never join
    # their tie-run (a lone +inf next to the NaN block would otherwise be
    # averaged over the NaN positions)
    nankey = nan.astype(jnp.int32)
    iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), x.shape)
    s, snan, perm = jax.lax.sort((key, nankey, iota), dimension=x.ndim - 1, num_keys=2)
    pos = jnp.arange(n, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.full_like(s[..., :1], jnp.nan), s[..., :-1]], axis=-1)
    prev_nan = jnp.concatenate([jnp.full_like(snan[..., :1], -1), snan[..., :-1]], axis=-1)
    starts = (s != prev) | (snan != prev_nan)  # first slot of each tie-run
    a = jax.lax.cummax(jnp.where(starts, pos, -1), axis=x.ndim - 1)
    nxt = jnp.concatenate([starts[..., 1:], jnp.ones_like(starts[..., :1])], axis=-1)
    b = -jax.lax.cummax(-jnp.where(nxt, pos, n)[..., ::-1], axis=x.ndim - 1)[..., ::-1]
    avg_sorted = (a + b).astype(x.dtype) / 2 + 1
    # a scatter, not a second sort keyed by ``perm``: XLA's GPU compiler
    # rewrites that sort into a scatter itself and, in site-partitioned
    # programs, emits one that fails HLO verification
    rnk = jnp.put_along_axis(
        jnp.zeros_like(avg_sorted), perm, avg_sorted, axis=x.ndim - 1, inplace=False
    )
    rnk = jnp.where(nan, jnp.nan, rnk)
    # restore NaNs in the sorted row (they sorted as +inf behind real +infs)
    sorted_x = jnp.where(snan == 1, jnp.nan, s)
    return rnk, sorted_x, nan


def average_rank(x, axis: int = -1):
    """Average rank along ``axis``; NaNs -> NaN; ranks start at 1."""
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    rnk, _, _ = _rank_core(x)
    return jnp.moveaxis(rnk, -1, axis)


def rank_pct_rescaled_with_sorted(x, axis: int = -1):
    """``rank_pct_rescaled`` plus the value-sorted row (NaNs last) and valid
    counts, all from ONE value sort.

    Returns ``(rescaled pct ranks, sorted values, valid counts)`` — sorted
    values/counts in last-axis layout, ready for
    ``ops.quantile._quantile_on_sorted``.  Callers that need both the ranks
    and the quantiles of the same array (the npdft hist side: reference
    ``_adjustment.py:310-326`` computes ``_quantile`` then ``_rank_bn`` on
    the same slice) save a full sort per call.
    """
    x = jnp.asarray(x)
    x = jnp.moveaxis(x, axis, -1)
    rnk, sorted_x, nan = _rank_core(x)
    nvalid = jnp.sum(~nan, axis=-1, keepdims=True).astype(rnk.dtype)
    r = rnk / jnp.where(nvalid == 0, 1, nvalid)
    mn = jnp.nanmin(r, axis=-1, keepdims=True)
    mx = jnp.nanmax(r, axis=-1, keepdims=True)
    denom = mx - mn
    pct = jnp.where(denom == 0, 0.0, mx * (r - mn) / jnp.where(denom == 0, 1, denom))
    return jnp.moveaxis(pct, -1, axis), sorted_x, nvalid[..., 0]


def pct_rank(x, axis: int = -1):
    """Percentage rank in (0, 1]: rank / n_valid (xarray ``rank(pct=True)``)."""
    x = jnp.asarray(x)
    rnk = average_rank(x, axis=axis)
    nvalid = jnp.sum(~jnp.isnan(x), axis=axis, keepdims=True).astype(rnk.dtype)
    return rnk / jnp.where(nvalid == 0, 1, nvalid)


def rank_pct_rescaled(x, axis: int = -1):
    """Reference pct rank: rescaled so min -> 0 and max -> mx
    (``utils.py:631-634``: ``mx*(rnk-mn)/(mx-mn)``)."""
    r = pct_rank(x, axis=axis)
    mn = jnp.nanmin(r, axis=axis, keepdims=True)
    mx = jnp.nanmax(r, axis=axis, keepdims=True)
    denom = mx - mn
    return jnp.where(denom == 0, 0.0, mx * (r - mn) / jnp.where(denom == 0, 1, denom))
