"""Group-wise apply primitives over static gather/scatter indexes.

The device replacement for ``Grouper.apply`` (reference ``base.py:347-457``):
instead of a runtime groupby, values are gathered into a dense ``[G, L]``
matrix (NaN-padded via the -1 indexes), reduced or transformed along ``L``,
and — for transforms — scattered back to the time axis through
``(group_idx[t], scatter_slot[t])`` (the window-center selection of
``base.py:425-430``).
"""

from __future__ import annotations

import jax.numpy as jnp

from .rank import average_rank

__all__ = [
    "gather_groups",
    "grouped_mean",
    "grouped_rank",
    "grouped_std",
    "scatter_back",
]


def gather_groups(x, gather_idx):
    """x [..., T], gather_idx [G, L] -> [..., G, L] with NaN where idx < 0."""
    x = jnp.asarray(x)
    gi = jnp.asarray(gather_idx)
    vals = x[..., jnp.clip(gi, 0, x.shape[-1] - 1)]
    return jnp.where(gi < 0, jnp.nan, vals)


def scatter_back(grouped_vals, group_idx, scatter_slot):
    """grouped_vals [..., G, L] -> [..., T] via per-timestep (group, slot)."""
    g = jnp.asarray(group_idx)
    s = jnp.asarray(scatter_slot)
    return grouped_vals[..., g, s]


def grouped_mean(x, gather_idx):
    """NaN-aware per-group mean: [..., T] -> [..., G]."""
    v = gather_groups(x, gather_idx)
    return jnp.nanmean(v, axis=-1)


def grouped_std(x, gather_idx, ddof: int = 0):
    """NaN-aware per-group standard deviation: [..., T] -> [..., G]."""
    v = gather_groups(x, gather_idx)
    return jnp.nanstd(v, axis=-1, ddof=ddof)


def grouped_rank(x, gather_idx, group_idx, scatter_slot, pct: bool = False):
    """Rank each value within its (windowed) group, written back to time.

    Matches reference ``group.apply(u.rank, da, pct=True)`` (utils.py:575-638):
    average ranks within the group block; with ``pct`` the ranks are divided by
    the valid count then rescaled to span [0, 1] (utils.py:631-634).
    """
    v = gather_groups(x, gather_idx)           # [..., G, L]
    rnk = average_rank(v, axis=-1)
    if pct:
        nvalid = jnp.sum(~jnp.isnan(v), axis=-1, keepdims=True).astype(rnk.dtype)
        rnk = rnk / jnp.where(nvalid == 0, 1, nvalid)
        mn = jnp.nanmin(rnk, axis=-1, keepdims=True)
        mx = jnp.nanmax(rnk, axis=-1, keepdims=True)
        denom = jnp.where(mx - mn == 0, 1, mx - mn)
        rnk = mx * (rnk - mn) / denom
    return scatter_back(rnk, group_idx, scatter_slot)


def grouped_rank_and_quantile(x, gather_idx, group_idx, scatter_slot, quantiles):
    """Fused ``grouped_rank(pct=True)`` + per-group quantile tables.

    One gather and ONE value sort serve both: the rank's first
    ``lax.sort`` already produces the value-sorted group rows, which feed
    ``_quantile_on_sorted`` directly.  Numerically identical to
    ``grouped_rank(x, ..., pct=True)`` plus
    ``nan_quantile(gather_groups(x, gather_idx), quantiles)`` — the
    NpdfTransform/QDM pattern (reference ``_adjustment.py:820-846``: rank
    then table-interp of the same grouped array).

    Returns ``(pct ranks scattered back to time [..., T],
    quantile tables [..., G, nq])``.
    """
    from .quantile import _quantile_on_sorted
    from .rank import rank_pct_rescaled_with_sorted

    v = gather_groups(x, gather_idx)            # [..., G, L]
    rnk, sorted_v, nvalid = rank_pct_rescaled_with_sorted(v, axis=-1)
    qtab = _quantile_on_sorted(
        sorted_v, nvalid, jnp.asarray(quantiles, sorted_v.dtype), 1.0, 1.0
    )
    return scatter_back(rnk, group_idx, scatter_slot), qtab
