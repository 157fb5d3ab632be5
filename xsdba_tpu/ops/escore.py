"""Székely–Rizzo energy distance as matmuls.

Replaces the numba O(K·N·M) pairwise loops (reference ``nbutils.py:274-372``)
with the ||x||² + ||y||² − 2xᵀy matmul factorization — the distance matrix
is one matmul.  NaN points (any variable NaN) are masked out with weights
instead of compressed (static shapes), matching ``remove_NaNs`` semantics.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["escore"]


def _masked_pairwise_mean(X, Y, mx, my):
    """Mean euclidean distance between masked columns of X [..., K, N] and
    Y [..., K, M]; mx/my are 1-valid masks over columns."""
    X0 = jnp.where(mx[..., None, :], X, 0.0)
    Y0 = jnp.where(my[..., None, :], Y, 0.0)
    x2 = jnp.sum(X0 * X0, axis=-2)                         # [..., N]
    y2 = jnp.sum(Y0 * Y0, axis=-2)                         # [..., M]
    xy = jnp.einsum("...kn,...km->...nm", X0, Y0)
    d2 = x2[..., :, None] + y2[..., None, :] - 2 * xy
    d = jnp.sqrt(jnp.clip(d2, 0, None))
    w = mx[..., :, None] * my[..., None, :]
    tot = jnp.sum(d * w, axis=(-2, -1))
    cnt = jnp.sum(w, axis=(-2, -1))
    return tot, cnt


def escore(tgt, sim):
    """Energy distance between clusters tgt [..., K, N] and sim [..., K, M]
    (reference ``nbutils.py:341-372``): ``w · (2·sXY − sXX − sYY) / 2`` with
    ``w = n1·n2/(n1+n2)``; columns with any NaN are excluded."""
    tgt = jnp.asarray(tgt)
    sim = jnp.asarray(sim)
    mt = (~jnp.any(jnp.isnan(tgt), axis=-2)).astype(tgt.dtype)
    ms = (~jnp.any(jnp.isnan(sim), axis=-2)).astype(sim.dtype)
    n2 = jnp.sum(mt, axis=-1)
    n1 = jnp.sum(ms, axis=-1)

    txy, _ = _masked_pairwise_mean(tgt, sim, mt, ms)
    txx, _ = _masked_pairwise_mean(tgt, tgt, mt, mt)
    tyy, _ = _masked_pairwise_mean(sim, sim, ms, ms)
    sXY = txy / jnp.maximum(n1 * n2, 1)
    # reference _autocorrelation divides by n^2 (includes the zero diagonal)
    sXX = txx / jnp.maximum(n2 * n2, 1)
    sYY = tyy / jnp.maximum(n1 * n1, 1)

    w = n1 * n2 / jnp.maximum(n1 + n2, 1)
    out = w * (2 * sXY - sXX - sYY) / 2
    return jnp.where((n1 == 0) | (n2 == 0), jnp.nan, out)
