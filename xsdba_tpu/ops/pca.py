"""Principal-component transform construction (reference ``utils.py:649-785``).

NaN-tolerant covariance + hermitian SVD, and the 2^M orientation searches,
all batched over group blocks with vmap (the 2^M candidates evaluate as one
batched matmul instead of a Python loop).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["best_pc_orientation_full", "best_pc_orientation_simple", "first_eof_pattern", "pc_matrix", "pc_transform_matrix"]


def pc_matrix(arr):
    """arr [..., M, P] -> PC matrix [..., M, M]: eigvecs(cov) · sqrt(eigvals).

    Columns (points) with any NaN coordinate are excluded (reference
    adjustment.py:1148-1153 drops them before np.cov, ddof=1).
    """
    x = jnp.asarray(arr)
    valid = ~jnp.any(jnp.isnan(x), axis=-2, keepdims=True)          # [..., 1, P]
    n = jnp.sum(valid, axis=-1)                                     # [..., 1]
    x0 = jnp.where(valid, x, 0.0)
    mean = jnp.sum(x0, axis=-1, keepdims=True) / jnp.maximum(n[..., None], 1)
    xc = jnp.where(valid, x - mean, 0.0)
    cov = jnp.einsum("...ip,...jp->...ij", xc, xc) / jnp.maximum(n[..., None] - 1, 1)
    u, s, _ = jnp.linalg.svd(cov, hermitian=True)
    return u * jnp.sqrt(s)[..., None, :]


def _sign_vectors(m: int) -> np.ndarray:
    """All 2^m sign vectors, ordered like itertools.product([1,-1]*m)."""
    out = np.ones((2**m, m))
    for i in range(2**m):
        for j in range(m):
            out[i, j] = 1.0 if (i >> (m - 1 - j)) % 2 == 0 else -1.0
    return out


def best_pc_orientation_simple(R, Hinv, val: float = 1000.0):
    """Orientation minimizing the reprojection error of a far test point
    (reference utils.py:685-726).  R/Hinv: [..., M, M] -> [..., M]."""
    R = jnp.asarray(R)
    m = R.shape[-1]
    S = jnp.asarray(_sign_vectors(m), R.dtype)                      # [K, M]
    P = val * jnp.eye(m, dtype=R.dtype)
    # (s * R) scales columns of R by s
    RH = jnp.einsum("km,...im,...mj->k...ij", S, R, Hinv)           # [K, ..., M, M]
    err = jnp.linalg.norm(P - RH @ P, axis=(-2, -1))                # [K, ...]
    best = jnp.argmin(err, axis=0)
    return S[best]


def best_pc_orientation_full(R, Hinv, Rmean, Hmean, hist):
    """Orientation maximizing the mean per-variable Spearman correlation of
    the candidate scenario with hist (reference utils.py:730-785).

    R/Hinv [..., M, M]; Rmean/Hmean [..., M]; hist [..., M, P] (NaN padded).
    """
    from .rank import average_rank

    R = jnp.asarray(R)
    hist = jnp.asarray(hist)
    m = R.shape[-1]
    S = jnp.asarray(_sign_vectors(m), R.dtype)
    centred = hist - Hmean[..., None]
    T = jnp.einsum("km,...im,...mj->k...ij", S, R, Hinv)            # [K, ..., M, M]
    scen = Rmean[..., None] + jnp.einsum("k...ij,...jp->k...ip", T, jnp.where(jnp.isnan(centred), 0.0, centred))
    scen = jnp.where(jnp.isnan(hist), jnp.nan, scen)

    rh = average_rank(hist, axis=-1)                                # [..., M, P]
    rs = average_rank(scen, axis=-1)                                # [K, ..., M, P]

    def _corr(a, b):
        va = ~jnp.isnan(a) & ~jnp.isnan(b)
        n = jnp.sum(va, axis=-1)
        a0 = jnp.where(va, a, 0.0)
        b0 = jnp.where(va, b, 0.0)
        ma = jnp.sum(a0, axis=-1) / jnp.maximum(n, 1)
        mb = jnp.sum(b0, axis=-1) / jnp.maximum(n, 1)
        ac = jnp.where(va, a - ma[..., None], 0.0)
        bc = jnp.where(va, b - mb[..., None], 0.0)
        cov = jnp.sum(ac * bc, axis=-1)
        return cov / jnp.sqrt(jnp.sum(ac * ac, axis=-1) * jnp.sum(bc * bc, axis=-1))

    corr = _corr(rh, rs)                                            # [K, ..., M]
    score = jnp.mean(corr, axis=-1)                                 # [K, ...]
    best = jnp.argmax(score, axis=0)
    return S[best]


@jax.jit
def first_eof_pattern(anom):
    """Leading EOF of an anomaly matrix ``anom`` [..., T, S].

    NaN entries are treated as missing and contribute zero anomaly to the
    covariance products (the same zero-fill the eofs package applies after
    centering); columns with no finite entry come back as NaN.  Returns
    ``(eof [..., S], var_frac [...])`` with the EOF normalized to unit L2
    norm and signed so its largest-magnitude loading is positive.

    The eigenproblem is solved on the smaller Gram side: time-by-time when
    ``T <= S`` (the leading left vector is mapped back through ``Aᵀu``),
    site-by-site otherwise — either way one matmul plus a small
    batched ``eigh``.  Original implementation: the reference removed its
    ``first_eof`` (properties.py:1540-1554) over an eofs-package licensing
    issue, so there is no behavior to match.
    """
    anom = jnp.asarray(anom)
    T, S = anom.shape[-2:]
    finite = jnp.isfinite(anom)
    site_ok = jnp.any(finite, axis=-2)                              # [..., S]
    a0 = jnp.where(finite, anom, 0.0)
    if T <= S:
        g = jnp.einsum("...ts,...us->...tu", a0, a0)                # [..., T, T]
        w, u = jnp.linalg.eigh(g)
        v = jnp.einsum("...ts,...t->...s", a0, u[..., :, -1])       # [..., S]
    else:
        c = jnp.einsum("...ts,...tu->...su", a0, a0)                # [..., S, S]
        w, u = jnp.linalg.eigh(c)
        v = u[..., :, -1]
    nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    v = v / jnp.where(nrm == 0, 1.0, nrm)
    lead = jnp.take_along_axis(v, jnp.argmax(jnp.abs(v), axis=-1)[..., None], axis=-1)
    sgn = jnp.sign(lead)
    v = v * jnp.where(sgn == 0, 1.0, sgn)
    tot = jnp.sum(jnp.where(w > 0, w, 0.0), axis=-1)                # PSD: guard fp negatives
    var_frac = w[..., -1] / jnp.where(tot == 0, 1.0, tot)
    return jnp.where(site_ok, v, jnp.nan), var_frac


@partial(jax.jit, static_argnames=("best_orientation",))
def pc_transform_matrix(ref, hist, *, best_orientation: str = "simple"):
    """Per-block transform T = (R·orient) H⁻¹ plus centroids
    (reference adjustment.py:1144-1196).

    ref/hist [..., M, P] -> (trans [..., M, M], ref_mean, hist_mean [..., M]).
    """
    R = pc_matrix(ref)
    H = pc_matrix(hist)
    Hinv = jnp.linalg.inv(H)
    ref_mean = jnp.nanmean(ref, axis=-1)
    hist_mean = jnp.nanmean(hist, axis=-1)
    if best_orientation == "simple":
        orient = best_pc_orientation_simple(R, Hinv)
    elif best_orientation == "full":
        orient = best_pc_orientation_full(R, Hinv, ref_mean, hist_mean, hist)
    else:
        raise ValueError(f"Unknown `best_orientation` method: {best_orientation}.")
    trans = (R * orient[..., None, :]) @ Hinv
    return trans, ref_mean, hist_mean
