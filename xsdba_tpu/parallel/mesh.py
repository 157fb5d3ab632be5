"""Device-mesh scaling for bias adjustment.

The reference parallelizes with dask blocks over spatial dims
(``base.py:563-726``, SURVEY §2.10): bias adjustment is embarrassingly
parallel over sites, with time kept whole per site (the reference enforces a
single chunk along the adjusted dim, ``adjustment.py:102-103`` — the same
invariant as "time fits on-device").

Device equivalent: a 1-D (or 2-D site×var) ``jax.sharding.Mesh``; inputs
carry ``NamedSharding`` partitions over the site axis and the jitted cores are
compiled under the mesh — XLA partitions every op site-wise with zero
collectives on the adjustment path.  Collectives only appear in spatial
diagnostics (all-gather of site vectors; see ``properties``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "site_mesh",
    "shard_sites",
    "sharded_first_eof",
    "sharded_pairwise_corr",
    "site_sharding",
    "SITE_AXIS",
    "VAR_AXIS",
]

# f32 products owe reference parity: a default-precision f32 matmul may run
# in TF32 on GPUs
_HIGHEST = jax.lax.Precision.HIGHEST

SITE_AXIS = "site"
VAR_AXIS = "var"


def site_mesh(devices=None, n_var: int = 1) -> Mesh:
    """Build a mesh over the site axis (optionally site x var).

    ``n_var > 1`` reserves a second axis for multivariate methods whose
    rotation matmuls contract over variables (MBCn/NpdfTransform) — those
    reduce with a psum; everything else is pure data parallelism.  The mesh
    shape follows the algorithm alone: the cards of a host reach each other
    at the same rate.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_var > 1:
        if devices.size % n_var:
            raise ValueError(f"{devices.size} devices not divisible by n_var={n_var}")
        return Mesh(devices.reshape(devices.size // n_var, n_var), (SITE_AXIS, VAR_AXIS))
    return Mesh(devices.reshape(-1), (SITE_AXIS,))


def site_sharding(mesh: Mesh, ndim: int, site_axis: int = 0) -> NamedSharding:
    """NamedSharding that partitions axis ``site_axis`` over the site mesh
    axis and replicates the rest (time stays whole per shard)."""
    spec = [None] * ndim
    spec[site_axis] = SITE_AXIS
    return NamedSharding(mesh, P(*spec))


def shard_sites(arr, mesh: Mesh, site_axis: int = 0):
    """Place ``arr`` on the mesh, partitioned along its site axis."""
    return jax.device_put(arr, site_sharding(mesh, np.ndim(arr), site_axis))


def sharded_pairwise_corr(x, mesh: Mesh):
    """All-site pairwise Pearson correlation over a site-sharded mesh.

    The one all-to-all pattern of this domain is the spatial diagnostics'
    pairwise matrices (reference ``utils.py:977-1025`` / ``nbutils.py:424-445``
    feeding ``spatial_correlogram`` / ``decorrelation_length``).  Each shard
    standardizes its own site block, ``all_gather``s the standardized vectors
    across the mesh, and computes its ``[S_local, S_global]`` block as one
    matmul.

    x: [S, T] site-sharded (NaNs excluded pairwise-complete is NOT applied —
    rows with NaN yield NaN, as the reference's dense path).  Returns the
    [S, S] correlation matrix, sharded on the first axis.
    """

    @partial(shard_map, mesh=mesh, in_specs=P(SITE_AXIS, None), out_specs=P(SITE_AXIS, None))
    def _f(xl):
        xl = xl - jnp.mean(xl, axis=-1, keepdims=True)
        nrm = jnp.sqrt(jnp.sum(xl * xl, axis=-1, keepdims=True))
        xl = xl / jnp.where(nrm == 0, 1, nrm)
        xg = jax.lax.all_gather(xl, SITE_AXIS, tiled=True)  # [S_global, T]
        return jnp.einsum("lt,gt->lg", xl, xg, precision=_HIGHEST)

    return _f(x)


def sharded_first_eof(x, mesh: Mesh):
    """Leading EOF of a site-sharded field ``x`` [S, T] (additive anomalies).

    Same semantics as :func:`~xsdba_tpu.ops.pca.first_eof_pattern` on the
    time-side Gram: each shard zero-fills its local anomaly block (NaNs are
    missing; all-NaN sites come back NaN), the [T, T] Gram matrix
    accumulates with ONE ``psum`` over the site axis (the contraction runs
    over the sharded dim, so the collective moves a [T, T] block instead of
    gathering [S, T] data), the small ``eigh`` replicates per shard, and
    each shard maps the leading time vector back to its own site loadings.
    One more ``psum`` normalizes; the global sign anchor (largest |loading|,
    lowest site index on exact ties) is a pmax/pmin pair.

    Returns ``(eof [S] sharded like x, var_frac scalar)``.
    """

    @partial(shard_map, mesh=mesh, in_specs=P(SITE_AXIS, None), out_specs=(P(SITE_AXIS), P()))
    def _f(xl):  # [S_loc, T]
        finite = jnp.isfinite(xl)
        n = jnp.sum(finite, axis=-1, keepdims=True)
        mean = jnp.sum(jnp.where(finite, xl, 0.0), axis=-1, keepdims=True) / jnp.maximum(n, 1)
        a = jnp.where(finite, xl - mean, 0.0)
        site_ok = jnp.any(finite, axis=-1)
        g = jax.lax.psum(jnp.matmul(a.T, a, precision=_HIGHEST), SITE_AXIS)  # [T, T]
        w, u = jnp.linalg.eigh(g)
        vloc = jnp.matmul(a, u[:, -1], precision=_HIGHEST)          # [S_loc]
        ss = jax.lax.psum(jnp.sum(vloc * vloc), SITE_AXIS)
        vloc = vloc / jnp.where(ss == 0, 1.0, jnp.sqrt(ss))
        iloc = jnp.argmax(jnp.abs(vloc))
        mloc = jnp.abs(vloc)[iloc]
        mglob = jax.lax.pmax(mloc, SITE_AXIS)
        gidx = (jax.lax.axis_index(SITE_AXIS) * vloc.shape[0] + iloc).astype(jnp.int32)
        cand = jnp.where(mloc == mglob, gidx, jnp.iinfo(jnp.int32).max)
        winner = jax.lax.pmin(cand, SITE_AXIS)
        sgn = jax.lax.psum(jnp.where(gidx == winner, jnp.sign(vloc[iloc]), 0.0), SITE_AXIS)
        v = vloc * jnp.where(sgn == 0, 1.0, sgn)
        tot = jnp.sum(jnp.where(w > 0, w, 0.0))
        var_frac = w[-1] / jnp.where(tot == 0, 1.0, tot)
        return jnp.where(site_ok, v, jnp.nan), var_frac

    return _f(x)


def sharded_rotation_apply(rot, x, mesh: Mesh):
    """Apply a rotation matrix over a var-sharded multivariate axis.

    The MBCn/NpdfTransform rotation ``y = R @ x`` contracts over the
    multivariate axis — the one place this domain has genuine tensor
    parallelism.  ``x`` [..., V, L] is sharded on V over the ``var`` mesh
    axis; each shard holds the matching column block of R, computes its
    partial product and a ``psum`` over the ``var`` axis reduces the
    partials.

    Returns y [..., V, L] sharded like x.
    """

    V = x.shape[-2]
    nvar = mesh.shape[VAR_AXIS]
    if V % nvar:
        raise ValueError(f"V={V} not divisible by var axis size {nvar}")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, VAR_AXIS), P(SITE_AXIS, VAR_AXIS, None)),
        out_specs=P(SITE_AXIS, VAR_AXIS, None),
    )
    def _apply(r_cols, x_rows):
        # r_cols [V, V/p]; x_rows [B_loc, V/p, L] -> partial [B_loc, V, L]
        part = jnp.einsum("ij,...jl->...il", r_cols, x_rows, precision=_HIGHEST)
        full = jax.lax.psum(part, VAR_AXIS)
        # keep this shard's rows of the result
        k = jax.lax.axis_index(VAR_AXIS)
        rows = full.shape[-2] // jax.lax.axis_size(VAR_AXIS)
        return jax.lax.dynamic_slice_in_dim(full, k * rows, rows, axis=-2)

    return _apply(rot, x)
