"""Optimal-transport utilities (reference ``utils.py:1028-1146``).

Histogramming and plan construction for OTC/dOTC.  Two solvers:

- ``emd``: the in-tree C++ exact solver (``xsdba_tpu.native``), matching the
  reference's POT network simplex results;
- ``sinkhorn``: entropic OT in JAX — static shapes, runs on device, converges to
  the exact plan as ``reg -> 0`` (documented deviation when used).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "bin_width_estimator",
    "eps_cholesky",
    "histogram",
    "optimal_transport",
    "sinkhorn_plan",
]


def bin_width_estimator(X):
    """Freedman-Diaconis with Scott fallback (reference utils.py:1028-1052);
    lists take the per-dimension minimum."""
    if isinstance(X, list):
        return np.min([bin_width_estimator(x) for x in X], axis=0)
    X = np.asarray(X)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    bw = 2.0 * (np.percentile(X, 75, axis=0) - np.percentile(X, 25, axis=0)) / np.power(X.shape[0], 1.0 / 3.0)
    return np.where(bw == 0, 3.49 * np.std(X, axis=0) / np.power(X.shape[0], 1.0 / 3.0), bw)


def histogram(data, bin_width, bin_origin):
    """Multidimensional histogram over occupied bins only (reference
    utils.py:1054-1071).  Returns (bin centers, frequencies, per-point bin
    index rows)."""
    data = np.asarray(data)
    idx_bin = np.floor((data - bin_origin) / bin_width)
    grid, mu = np.unique(idx_bin, return_counts=True, axis=0)
    mu = mu / mu.sum()
    centers = (grid + 0.5) * bin_width + bin_origin
    return centers, mu, idx_bin


@partial(jax.jit, static_argnames=("n_iter",))
def sinkhorn_plan(mu, nu, cost, reg=5e-3, n_iter: int = 500):
    """Entropic OT plan via Sinkhorn iterations in log space."""
    mu = jnp.asarray(mu)
    nu = jnp.asarray(nu)
    C = jnp.asarray(cost)
    C = C / jnp.maximum(jnp.max(C), 1e-30)
    logmu = jnp.log(jnp.maximum(mu, 1e-300))
    lognu = jnp.log(jnp.maximum(nu, 1e-300))
    lse = jax.scipy.special.logsumexp

    def step(_, fg):
        f, g = fg
        f = reg * (logmu - lse((-C + g[None, :]) / reg, axis=1))
        g = reg * (lognu - lse((-C + f[:, None]) / reg, axis=0))
        return (f, g)

    f = jnp.zeros_like(mu)
    g = jnp.zeros_like(nu)
    f, g = jax.lax.fori_loop(0, n_iter, step, (f, g))
    return jnp.exp((f[:, None] + g[None, :] - C) / reg)


def optimal_transport(gridX, gridY, muX, muY, num_iter_max=100_000_000, normalization="max_distance", solver="emd"):
    """Row-normalized transport plan between histogram grids (reference
    utils.py:1074-1113): normalize grids, sqeuclidean costs, solve, normalize
    rows to conditional probabilities."""
    gridX = np.asarray(gridX, dtype=np.float64)
    gridY = np.asarray(gridY, dtype=np.float64)
    if normalization == "standardize":
        gridX = (gridX - gridX.mean(axis=0)) / gridX.std(axis=0)
        gridY = (gridY - gridY.mean(axis=0)) / gridY.std(axis=0)
    elif normalization == "max_distance":
        max1 = np.abs(gridX.max(axis=0) - gridY.min(axis=0))
        max2 = np.abs(gridY.max(axis=0) - gridX.min(axis=0))
        md = np.maximum(max1, max2)
        gridX = gridX / md
        gridY = gridY / md
    elif normalization == "max_value":
        mv = np.maximum(gridX.max(axis=0), gridY.max(axis=0))
        gridX = gridX / mv
        gridY = gridY / mv
    elif normalization is not None:
        raise ValueError(f"Unknown normalization {normalization!r}")

    diff = gridX[:, None, :] - gridY[None, :, :]
    C = np.einsum("ijk,ijk->ij", diff, diff)

    if solver == "emd":
        from ..native import emd

        gamma = emd(muX, muY, C)
    elif solver == "sinkhorn":
        gamma = np.asarray(sinkhorn_plan(muX, muY, C))
    else:
        raise ValueError(f"Unknown solver {solver!r}")
    rows = gamma.sum(axis=1, keepdims=True)
    return gamma / np.where(rows == 0, 1, rows)


def eps_cholesky(M, nit: int = 26):
    """Cholesky with growing diagonal perturbation until positive-definite
    (reference utils.py:1116-1146)."""
    M = np.asarray(M, dtype=np.float64)
    try:
        return np.linalg.cholesky(M)
    except np.linalg.LinAlgError:
        pass
    eps = min(1e-9, float(np.abs(np.diagonal(M)).min())) or 1e-9
    for _ in range(nit):
        try:
            return np.linalg.cholesky(M + np.eye(M.shape[0]) * eps)
        except np.linalg.LinAlgError:
            eps *= 2
    raise ValueError("The vcov matrix is far from positive-definite. Please use `cov_factor = 'std'`")
