"""N-pdf transform cores (the MBCn engine).

Device re-design of reference ``_adjustment.py:289-465``: the per-site
numpy loop over rotations becomes a ``lax.scan`` whose body is fully
batched — rotation matmuls, batched nan-quantiles, ranks and table
lookups.  Composed rotation increments (``rot_i @ rot_{i-1}.T``,
reference ``_adjustment.py:311``) are precomputed so the scan carries the
*rotated* state instead of re-rotating from scratch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.escore import escore
from ..ops.interp import interp1d_table
from ..ops.quantile import _quantile_on_sorted, nan_quantile
from ..ops.rank import rank_pct_rescaled, rank_pct_rescaled_with_sorted

# rotations owe float64-reference parity: a default-precision f32 matmul
# may run in TF32 on GPUs
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["npdft_adjust_core", "npdft_train_core", "standardize_lastaxis"]


def standardize_lastaxis(x):
    """(x - nanmean) / nanstd along the last axis (ddof=0), as in
    reference ``_adjustment.py:303-305``."""
    mu = jnp.nanmean(x, axis=-1, keepdims=True)
    sd = jnp.nanstd(x, axis=-1, keepdims=True)
    return (x - mu) / sd


def _composed_rots(rots):
    """rot increments: rots[0], rots[i] @ rots[i-1].T for i>0."""
    head = rots[:1]
    tail = jnp.einsum("iab,ibc->iac", rots[1:], jnp.swapaxes(rots[:-1], -1, -2), precision=_HIGHEST)
    return jnp.concatenate([head, tail], axis=0)


@partial(jax.jit, static_argnames=("interp", "extrap", "n_escore", "standardize"))
def npdft_train_core(ref, hist, rots, quantiles, *, interp: str, extrap: str, n_escore: int, standardize: bool = True):
    """Train the npdf transform.

    ref/hist: [..., V, L] (one windowed group block, NaN padded);
    rots: [I, V, V]; quantiles: [nq].
    Returns (af_q [..., I, V, nq], escores [..., I]).
    """
    if standardize:
        ref = standardize_lastaxis(ref)
        hist = standardize_lastaxis(hist)
    inc = _composed_rots(rots)
    L = ref.shape[-1]
    stride = max(1, int(-(-L // n_escore))) if n_escore > 0 else 1

    def body(carry, rot):
        r, h = carry
        r = jnp.einsum("ij,...jl->...il", rot, r, precision=_HIGHEST)
        h = jnp.einsum("ij,...jl->...il", rot, h, precision=_HIGHEST)
        ref_q = nan_quantile(r, quantiles, axis=-1)
        # hist side needs BOTH quantiles and ranks of the same array — one
        # shared value sort serves both (the sort is the iteration's
        # dominant cost; numerically identical to nan_quantile + rank)
        rnk, h_sorted, h_valid = rank_pct_rescaled_with_sorted(h, axis=-1)
        hist_q = _quantile_on_sorted(
            h_sorted, h_valid, jnp.asarray(quantiles, h.dtype), 1.0, 1.0
        )
        af_q = ref_q - hist_q
        qtab = jnp.broadcast_to(quantiles, hist_q.shape)
        af = interp1d_table(rnk, qtab, af_q, interp, extrap)
        h = h + af
        # n_escore == 0 skips here (MBCn-train semantics, reference
        # _adjustment.py:308,325: `if n_escore > 0`) while the
        # NpdfTransform core below computes at 0 (adjustment.py:1034:
        # `>= 0`, "0 for all") — the reference's own asymmetry, kept
        esc = escore(r[..., ::stride], h[..., ::stride]) if n_escore > 0 else jnp.full(r.shape[:-2], jnp.nan, r.dtype)
        return (r, h), (af_q, esc)

    (_, _), (af_q, escores) = jax.lax.scan(body, (ref, hist), inc)
    # scan stacks along axis 0 -> move iteration axis before V
    af_q = jnp.moveaxis(af_q, 0, -3)
    escores = jnp.moveaxis(escores, 0, -1)
    return af_q, escores


@partial(jax.jit, static_argnames=("interp", "extrap", "n_escore", "base"))
def npdf_transform_core(
    ref,
    hist,
    sim,
    rots,
    quantiles,
    gather_h,
    group_idx_h,
    slot_h,
    gather_s,
    group_idx_s,
    slot_s,
    frac_h,
    pos_h,
    frac_s,
    pos_s,
    *,
    interp: str,
    extrap: str,
    n_escore: int,
    base: str = "qdm",
):
    """NpdfTransform engine (reference ``_adjustment.py:977-1057``).

    ref/hist [..., V, Th], sim [..., V, Ts].  Each scan step rotates the
    current hist/sim (and the fixed ref) with a fresh rotation, runs the
    grouped univariate ``base`` ("qdm": rank + factor lookup; "eqm": table
    lookup at the value) per variable, and rotates back.  Escore (vs the
    un-rotated ref, standardized by ref) tracks convergence.
    Returns (scenh, scens, escores).
    """
    from ..ops.interp import interp_on_quantiles_grouped
    from ..ops.segment import gather_groups, grouped_rank, grouped_rank_and_quantile

    Th = ref.shape[-1]
    stride = max(1, int(-(-Th // n_escore))) if n_escore > 0 else 1
    # escore standardization by original ref (reference processing.py:460-480)
    mu = jnp.nanmean(ref, axis=-1, keepdims=True)
    sd = jnp.nanstd(ref, axis=-1, ddof=1, keepdims=True)
    ref_n = ((ref - mu) / sd)[..., ::stride]

    def body(carry, rot):
        h, s = carry
        refp = jnp.einsum("ij,...jl->...il", rot, ref, precision=_HIGHEST)
        hp = jnp.einsum("ij,...jl->...il", rot, h, precision=_HIGHEST)
        sp = jnp.einsum("ij,...jl->...il", rot, s, precision=_HIGHEST)
        ref_q = nan_quantile(gather_groups(refp, gather_h), quantiles, axis=-1)
        if base == "qdm":
            # the hist side needs both its grouped ranks and its grouped
            # quantile tables — one gather + one value sort serves both
            rnk_h, hist_q = grouped_rank_and_quantile(
                hp, gather_h, group_idx_h, slot_h, quantiles
            )
            af = ref_q - hist_q                                      # [..., V, G, nq]
            qtab = jnp.broadcast_to(quantiles, af.shape)
            scenhp = hp + interp_on_quantiles_grouped(
                rnk_h, frac_h, qtab, af, pos_h, interp, extrap
            )
            rnk_s = grouped_rank(sp, gather_s, group_idx_s, slot_s, pct=True)
            scensp = sp + interp_on_quantiles_grouped(
                rnk_s, frac_s, qtab, af, pos_s, interp, extrap
            )
        else:  # eqm: look the value up in hist's quantile table
            hist_q = nan_quantile(gather_groups(hp, gather_h), quantiles, axis=-1)
            af = ref_q - hist_q
            scenhp = hp + interp_on_quantiles_grouped(
                hp, frac_h, hist_q, af, pos_h, interp, extrap
            )
            scensp = sp + interp_on_quantiles_grouped(
                sp, frac_s, hist_q, af, pos_s, interp, extrap
            )
        h = jnp.einsum("ji,...jl->...il", rot, scenhp, precision=_HIGHEST)
        s = jnp.einsum("ji,...jl->...il", rot, scensp, precision=_HIGHEST)
        if n_escore >= 0:
            hn = (h - mu) / sd
            esc = escore(ref_n, hn[..., ::stride])
        else:
            esc = jnp.full(h.shape[:-2], jnp.nan, h.dtype)
        return (h, s), esc

    (scenh, scens), escores = jax.lax.scan(body, (hist, sim), rots)
    return scenh, scens, jnp.moveaxis(escores, 0, -1)


@partial(jax.jit, static_argnames=("interp", "extrap"))
def npdft_adjust_core(sim, af_q, rots, quantiles, *, interp: str, extrap: str):
    """Apply stored npdft factors to (standardized) sim [..., V, L]
    (reference ``_adjustment.py:426-465``); af_q [..., I, V, nq]."""
    inc = _composed_rots(rots)
    af_q_it = jnp.moveaxis(af_q, -3, 0)  # [I, ..., V, nq]

    def body(s, inputs):
        rot, afq = inputs
        s = jnp.einsum("ij,...jl->...il", rot, s, precision=_HIGHEST)
        rnk = rank_pct_rescaled(s, axis=-1)
        qtab = jnp.broadcast_to(quantiles, afq.shape)
        af = interp1d_table(rnk, qtab, afq, interp, extrap)
        s = s + af
        return s, None

    sim, _ = jax.lax.scan(body, sim, (inc, af_q_it))
    return jnp.einsum("ji,...jl->...il", rots[-1], sim, precision=_HIGHEST)
