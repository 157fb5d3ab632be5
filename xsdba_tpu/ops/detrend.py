"""Batched polynomial trend fitting.

Replaces xarray ``polyfit``/``polyval`` (reference ``detrending.py:196-208``)
with masked normal equations solved batched on device: one small
``[deg+1, deg+1]`` solve per (batch, group) — batched, no per-site loop.

The x axis is affinely rescaled to [-1, 1] per group before fitting; the
evaluated trend is mathematically invariant under this rescaling and far
better conditioned than raw epoch coordinates.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["grouped_polyfit_trend", "polyfit_trend"]


def _vander(x, degree: int):
    return jnp.stack([x**k for k in range(degree + 1)], axis=-1)  # [..., n, d+1]


@partial(jax.jit, static_argnames=("degree",))
def polyfit_trend(y, x, *, degree: int):
    """Fit a polynomial of ``degree`` to y([..., n]) over x([n] or [..., n]),
    NaN-aware, and evaluate it at x.  Returns the trend [..., n]."""
    y = jnp.asarray(y)
    x = jnp.asarray(x, dtype=y.dtype)
    x = jnp.broadcast_to(x, y.shape)
    # rescale to [-1, 1] (NaN-x entries excluded)
    valid = ~(jnp.isnan(y) | jnp.isnan(x))
    xv = jnp.where(valid, x, jnp.nan)
    lo = jnp.nanmin(xv, axis=-1, keepdims=True)
    hi = jnp.nanmax(xv, axis=-1, keepdims=True)
    span = jnp.where(hi > lo, hi - lo, 1.0)
    xs = (jnp.where(jnp.isnan(x), 0.0, x) - lo) / span * 2 - 1

    V = _vander(xs, degree)                       # [..., n, d+1]
    w = valid.astype(y.dtype)[..., None]          # [..., n, 1]
    Vw = V * w
    yv = jnp.where(valid, y, 0.0)
    A = jnp.einsum("...ni,...nj->...ij", Vw, V)
    b = jnp.einsum("...ni,...n->...i", Vw, yv)
    # ridge epsilon guards rank-deficient groups (all-NaN -> identity solve)
    eps = jnp.asarray(1e-12, y.dtype)
    A = A + eps * jnp.eye(degree + 1, dtype=y.dtype)
    coef = jnp.linalg.solve(A, b[..., None])[..., 0]
    trend = jnp.einsum("...ni,...i->...n", V, coef)
    # all-NaN rows give 0 coefficients -> return NaN there
    any_valid = valid.any(axis=-1, keepdims=True)
    return jnp.where(any_valid, trend, jnp.nan)


@partial(jax.jit, static_argnames=("degree",))
def grouped_polyfit_trend(y, x, gather_idx, group_idx, scatter_slot, *, degree: int):
    """Per-group polynomial trend written back to the time axis.

    y: [..., T]; x: [T] numeric time coordinate; gather/scatter from
    ``Grouper.indexes``.  The group.apply(polyfit) of reference
    ``detrending.py:196-208``, fused.
    """
    from .segment import gather_groups, scatter_back

    yg = gather_groups(y, gather_idx)                       # [..., G, L]
    xg = gather_groups(jnp.asarray(x, dtype=yg.dtype), gather_idx)  # [G, L]
    trend_g = polyfit_trend(yg, xg, degree=degree)
    return scatter_back(trend_g, group_idx, scatter_slot)
