"""NaN-aware batched quantiles.

Replaces the reference's numba kernels (``nbutils.py:24-271``): per-row in-place
sort + type-7 (Hyndman-Fan; ``alpha=beta=1``) linear interpolation, NaN-aware.

Design: one ``jnp.sort`` over the reduced axis (XLA sorts NaNs last, like
numpy), then a vectorized gather + lerp — no Python-level row loop.  Everything
is shape-static and vmappable over arbitrary leading batch dims, so XLA fuses
the surrounding elementwise work.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "nan_quantile",
    "grouped_nan_quantile",
    "vecquantiles",
    "windowed_group_quantile",
]


def _virtual_index(valid_count, quantiles, alpha: float, beta: float):
    # Reference nbutils.py:130: n*q + (alpha + q*(1-alpha-beta)) - 1
    return valid_count * quantiles + (alpha + quantiles * (1 - alpha - beta)) - 1


def _lerp(left, right, gamma):
    # Symmetric lerp for fp accuracy — mirrors nbutils.py:77-106.
    diff = right - left
    out = left + diff * gamma
    return jnp.where(gamma >= 0.5, right - diff * (1 - gamma), out)


def _quantile_on_sorted(sorted_x, valid, quantiles, alpha, beta, sentinel: str = "nan"):
    """Type-7 quantiles given a pre-sorted (NaNs-last) last axis.

    sorted_x: [..., n]; valid: [...] count of non-NaN entries;
    quantiles: [..., nq] (broadcastable against leading dims).
    Returns [..., nq].

    ``sentinel="inf"`` marks padding beyond ``valid`` as +inf instead of NaN
    (the merge-cascade layout, where min/max networks cannot carry NaNs); the
    out-of-range clip then tests +inf and all-empty rows yield NaN explicitly.
    """
    n = sorted_x.shape[-1]

    def _indices(v):
        # v: [..., 1] valid counts (float).  Bounds handling
        # (nbutils.py:30-68): above valid-1 -> last element of the *full* row
        # (index -1, NaN/+inf pad — later clipped to the max valid value);
        # below 0 -> first element.
        vi = _virtual_index(v, quantiles, alpha, beta)
        prev = jnp.floor(vi)
        above = vi >= v - 1
        below = vi < 0
        prev_idx = jnp.clip(prev, 0, n - 1).astype(jnp.int32)
        next_idx = jnp.clip(prev + 1, 0, n - 1).astype(jnp.int32)
        last = jnp.int32(n - 1)
        prev_idx = jnp.where(above, last, jnp.where(below, 0, prev_idx))
        next_idx = jnp.where(above, last, jnp.where(below, 0, next_idx))
        gamma = (vi - prev).astype(sorted_x.dtype)
        return prev_idx, next_idx, gamma

    def _finish(left, right, gamma, max_valid, vcount):
        interp = _lerp(left, right, gamma)
        # NaN range clip: replace NaN interpolation by the max valid value
        # (nbutils.py:144-147).  All-NaN rows keep NaN (max_valid NaN there).
        if sentinel == "inf":
            bad = jnp.isnan(interp) | (interp == jnp.inf)
            out = jnp.where(bad, max_valid, interp)
            return jnp.where(vcount == 0, jnp.nan, out)
        return jnp.where(jnp.isnan(interp), max_valid, interp)

    v = valid[..., None].astype(sorted_x.dtype)
    prev_idx, next_idx, gamma = _indices(v)
    left = jnp.take_along_axis(sorted_x, prev_idx, axis=-1)
    right = jnp.take_along_axis(sorted_x, next_idx, axis=-1)
    max_idx = jnp.clip(valid[..., None] - 1, 0, n - 1).astype(jnp.int32)
    max_valid = jnp.take_along_axis(sorted_x, max_idx, axis=-1)
    return _finish(left, right, gamma, max_valid, valid[..., None])


def nan_quantile(x, quantiles, axis: int = -1, alpha: float = 1.0, beta: float = 1.0):
    """NaN-aware quantiles along ``axis``; matches ``np.nanquantile`` for
    ``alpha=beta=1`` (reference ``nbutils.py:113-148``).

    ``quantiles`` is a 1-D array of nq probabilities.  The reduced axis is
    replaced by a trailing ``nq`` axis.
    """
    x = jnp.asarray(x)
    quantiles = jnp.asarray(quantiles, dtype=x.dtype)
    x = jnp.moveaxis(x, axis, -1)
    sorted_x = jnp.sort(x, axis=-1)  # NaNs sort to the end
    valid = jnp.sum(~jnp.isnan(x), axis=-1)
    return _quantile_on_sorted(sorted_x, valid, quantiles, alpha, beta)


def vecquantiles(x, ranks, axis: int = -1, alpha: float = 1.0, beta: float = 1.0):
    """Quantile where the probability differs per row (reference
    ``nbutils.py:151-195``): ``x`` [..., n], ``ranks`` [...] -> [...].

    NaN rank yields NaN.
    """
    x = jnp.asarray(x)
    ranks = jnp.asarray(ranks, dtype=x.dtype)
    x = jnp.moveaxis(x, axis, -1)
    sorted_x = jnp.sort(x, axis=-1)
    valid = jnp.sum(~jnp.isnan(x), axis=-1)
    q = jnp.nan_to_num(ranks)[..., None]
    out = _quantile_on_sorted(sorted_x, valid, q, alpha, beta)[..., 0]
    return jnp.where(jnp.isnan(ranks), jnp.nan, out)


def grouped_nan_quantile(x, gather_idx, quantiles, alpha: float = 1.0, beta: float = 1.0, group_chunk: int | None = None):
    """Fused gather -> sort -> lerp grouped quantile.

    x: [..., T]; gather_idx: [G, L] int32 with -1 padding (see
    ``Grouper.indexes``); quantiles: [nq].  Returns [..., G, nq].

    This is the device lowering of the reference's rolling-window groupby quantile
    (``base.py:261-265`` + ``nbutils.quantile``): window padding positions are
    -1 and become NaN, exactly like the NaN pads of ``rolling.construct``.

    ``group_chunk`` bounds peak memory: groups are processed ``group_chunk``
    at a time with ``lax.map`` so only a [..., chunk, L] slice of the gather
    matrix is ever materialized (windowed dayofyear groups would otherwise
    allocate [..., 366, years*window] — tens of GB at production size).
    By default a chunk is picked to keep the slice near ~2^28 elements.
    """
    x = jnp.asarray(x)
    gi = jnp.asarray(gather_idx)
    G, L = gi.shape
    batch = int(np.prod(x.shape[:-1], dtype=np.int64)) if x.ndim > 1 else 1
    if group_chunk is None:
        budget = 1 << 28
        group_chunk = max(1, min(G, budget // max(batch * L, 1)))

    def one_chunk(gidx_chunk):
        mask = gidx_chunk < 0
        vals = x[..., jnp.clip(gidx_chunk, 0, x.shape[-1] - 1)]   # [..., C, L]
        vals = jnp.where(mask, jnp.nan, vals)
        return nan_quantile(vals, quantiles, axis=-1, alpha=alpha, beta=beta)

    if group_chunk >= G:
        return one_chunk(gi)

    # pad G to a multiple of the chunk, map over chunks, then crop
    n_chunks = -(-G // group_chunk)
    pad = n_chunks * group_chunk - G
    gi_p = jnp.concatenate([gi, jnp.full((pad, L), -1, gi.dtype)], axis=0) if pad else gi
    chunks = gi_p.reshape(n_chunks, group_chunk, L)
    out = jax.lax.map(one_chunk, chunks)                           # [n_chunks, ..., C, nq]
    out = jnp.moveaxis(out, 0, -3)                                  # [..., n_chunks, C, nq]
    out = out.reshape(out.shape[:-3] + (n_chunks * group_chunk, out.shape[-1]))
    return out[..., :G, :]


# ---------------------------------------------------------------------------
# Shared-sort windowed grouped quantile (the doy+window hot path)
# ---------------------------------------------------------------------------

#: Windowed-quantile engine per platform, measured at the heavy EQM
#: doy+31w shape (PERF.md): the counting-selection gather engine is the
#: fastest of the three on both the CPU and the GPU.
_ENGINE_BY_PLATFORM = {"cpu": "gather", "gpu": "gather"}


def windowed_engine(plan, quantiles) -> str:
    """The engine that serves a windowed grouped quantile on this platform:
    ``"gather"`` or ``"emit"`` (counting selection, ``ops/selquant.py``) or
    ``"merge"`` (per-day sorts + the XLA merge cascade, ``ops/merge.py``).

    Selection needs interval-shaped window membership (regular calendars)
    and a 1-D quantile vector; the ``selection_backend`` option turns it
    off and ``selection_mode`` pins one of its two extraction forms."""
    from ..utils.options import get_option
    from .selquant import selection_ok

    if not selection_ok(plan, quantiles):
        return "merge"
    mode = get_option("selection_mode")
    if mode != "auto":
        return mode
    return _ENGINE_BY_PLATFORM.get(jax.default_backend(), "gather")


def _static_safe(x):
    fin = jnp.isfinite(x)
    return jnp.all(jnp.all(fin, axis=-1) | jnp.all(jnp.isnan(x), axis=-1))


@jax.jit
def _finite_probe(x):
    """Device scalar: the STATIC extraction is value-safe — every site row
    is either all-finite or all-NaN.  With all-finite rows every group's
    windowed valid count equals the plan's host-known member count, so the
    extraction indices are compile-time constants (a traced cond would
    compile both extraction branches); all-NaN rows (ocean-masked
    sites in production grids) are NaN under any extraction and the static
    path masks them explicitly.  Rows with a PARTIAL NaN pattern (or any
    +/-inf) take the exact dynamic-count path."""
    return _static_safe(x)


@jax.jit
def _pair_finite_probe(a, b):
    """Static-safety of a (ref, hist) pair in one dispatch."""
    return _static_safe(a) & _static_safe(b)


# extraction variant for host-known counts (runtime option ``extract_mode``):
# "strip" = per-quantile static 32-wide slices + constant-mask selects;
# "flat" = one constant-index gather from the flattened [..., G*n] axis;
# "matmul" = one-hot matmul contraction at Precision.HIGHEST.
# Threaded into the core as a static arg.


def _static_extract_indices(counts, q_static, n, dtype, alpha, beta):
    """Host-side (numpy) replication of ``_virtual_index``/``_indices`` for
    compile-time-known valid counts: returns (prev idx, next idx, gamma,
    empty mask), each [G, nq] / [G].  The f32 arithmetic matches the device
    op order exactly so the selected columns are bit-identical."""
    npdt = np.float32 if dtype == jnp.float32 else np.float64
    nvh = np.asarray(counts, dtype=np.int64)[:, None]          # [G, 1]
    v = nvh.astype(npdt)
    qs = np.asarray(q_static, dtype=npdt)[None, :]             # [1, nq]
    vi = (v * qs + (npdt(alpha) + qs * npdt(1.0 - alpha - beta)) - npdt(1.0)).astype(npdt)
    prev = np.floor(vi)
    above = vi >= v - npdt(1.0)
    below = vi < 0
    pi = np.clip(prev, 0, n - 1).astype(np.int64)
    ni = np.clip(prev + 1, 0, n - 1).astype(np.int64)
    # above/below land on pad/first entries; the gather path's NaN-range
    # clip then substitutes the max valid value — statically that is nv-1
    last_valid = np.maximum(nvh - 1, 0)
    pi = np.where(above, last_valid, np.where(below, 0, pi))
    ni = np.where(above, last_valid, np.where(below, 0, ni))
    gamma = (vi - prev).astype(npdt)
    empty = nvh[:, 0] == 0
    return pi, ni, gamma, empty


def _static_flat_extract(merged, counts, q_static, edge_ids, alpha, beta):
    """Static-count extraction as ONE constant-index gather from the
    flattened [..., G*n] axis.

    Bit-identical to ``_static_strip_extract`` (same host-side index math,
    same ``_lerp``), but with no strip-width constraint and no [..., G, nq,
    32] intermediate.
    """
    n = merged.shape[-1]
    G = merged.shape[-2]
    pi, ni, gamma, empty = _static_extract_indices(
        counts, q_static, n, merged.dtype, alpha, beta
    )
    nq = pi.shape[1]
    lead = merged.shape[:-2]
    flat = merged.reshape(lead + (G * n,))
    rowbase = np.arange(G, dtype=np.int64)[:, None] * n
    both = np.concatenate([(rowbase + pi).ravel(), (rowbase + ni).ravel()])
    vals = jnp.take(flat, jnp.asarray(both, dtype=jnp.int32), axis=-1)
    left = vals[..., : G * nq].reshape(lead + (G, nq))
    right = vals[..., G * nq :].reshape(lead + (G, nq))
    npdt = np.float32 if merged.dtype == jnp.float32 else np.float64
    out = _lerp(left, right, jnp.asarray(gamma.astype(npdt)))
    if empty.any():
        out = jnp.where(jnp.asarray(empty)[:, None], jnp.nan, out)
    return out


def _static_matmul_extract(merged, counts, q_static, edge_ids, alpha, beta):
    """Static-count extraction as a one-hot matmul contraction per group.

    Same host-side type-7 index/gamma math as the flat/strip forms; the
    2*nq picked columns per group are selected by a bf16 one-hot
    [G, n, 2nq] contraction at ``Precision.HIGHEST`` — exact for f32
    inputs (the bf16x3 decomposition reproduces ``x*1.0`` bit-exactly and
    exactly one term per output is non-zero; a picked ``-0.0`` may come
    back ``+0.0``, which no comparison or lerp downstream can observe).
    +inf pads are clamped to f32 max before the contraction (``0 * inf``
    would NaN-poison the sums); static indices never select pad positions
    for non-empty groups and empty groups are NaN-masked after, so the
    clamp is unobservable.  The index constant rides through an
    ``optimization_barrier`` so XLA cannot constant-fold the [G, n, 2nq]
    one-hot into a program constant of hundreds of megabytes.
    """
    n = merged.shape[-1]
    G = merged.shape[-2]
    pi, ni, gamma, empty = _static_extract_indices(
        counts, q_static, n, merged.dtype, alpha, beta
    )
    nq = pi.shape[1]
    idx = jnp.asarray(np.concatenate([pi, ni], axis=1).astype(np.int32))  # [G, 2nq]
    idx = jax.lax.optimization_barrier(idx)
    oh = (
        jnp.arange(n, dtype=jnp.int32)[None, :, None] == idx[:, None, :]
    ).astype(jnp.bfloat16)  # [G, n, 2nq]
    safe = jnp.minimum(merged, jnp.asarray(np.finfo(np.float32).max, merged.dtype))
    vals = jnp.einsum(
        "...gn,gnk->...gk",
        safe,
        oh,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=merged.dtype,
    )
    left, right = vals[..., :nq], vals[..., nq:]
    npdt = np.float32 if merged.dtype == jnp.float32 else np.float64
    out = _lerp(left, right, jnp.asarray(gamma.astype(npdt)))
    if empty.any():
        out = jnp.where(jnp.asarray(empty)[:, None], jnp.nan, out)
    return out


def _static_strip_extract(merged, counts, q_static, edge_ids, alpha, beta):
    """Extraction with host-known per-group valid counts: all indices and
    lerp weights are compile-time constants, so each quantile reads a narrow
    STATIC strip of the merged row and selects with a constant mask — no
    gathers, no wide matmuls.  Bit-identical to the gather path (the f32
    index arithmetic of ``_virtual_index`` is replicated in numpy, and the
    same symmetric ``_lerp`` is applied).

    merged: [..., G, n] ascending, +inf past each row's count.  Returns
    [..., G, nq], or None when the static spans don't fit the strip width
    (caller then uses the gather path).
    """
    n = merged.shape[-1]
    G = merged.shape[-2]
    npdt = np.float32 if merged.dtype == jnp.float32 else np.float64
    nvh = np.asarray(counts, dtype=np.int64)[:, None]          # [G, 1]
    pi, ni, gamma, empty = _static_extract_indices(
        counts, q_static, n, merged.dtype, alpha, beta
    )

    # strip bases from the groups whose counts are authoritative (non-edge,
    # non-empty); edge groups are overwritten by the exact path afterwards,
    # so their indices are merely clipped into the strip
    ref_rows = ~empty
    ref_rows[np.asarray(edge_ids, dtype=np.int64)] = False
    if not ref_rows.any():
        return None
    W = 32
    lo = np.minimum(pi, ni)[ref_rows].min(axis=0)
    hi = np.maximum(pi, ni)[ref_rows].max(axis=0)
    if int((hi - lo).max()) >= W:
        return None
    base = np.clip(lo, 0, max(n - W, 0))
    if n < W:
        return None
    offs_p = np.clip(pi - base[None, :], 0, W - 1)
    offs_n = np.clip(ni - base[None, :], 0, W - 1)
    d = np.arange(W)
    mask_l = offs_p[:, :, None] == d[None, None, :]            # [G, nq, W]
    mask_r = offs_n[:, :, None] == d[None, None, :]

    strips = jnp.stack(
        [jax.lax.slice_in_dim(merged, int(b), int(b) + W, axis=-1) for b in base],
        axis=-2,
    )  # [..., G, nq, W]
    zero = jnp.zeros((), merged.dtype)
    left = jnp.sum(jnp.where(jnp.asarray(mask_l), strips, zero), axis=-1)
    right = jnp.sum(jnp.where(jnp.asarray(mask_r), strips, zero), axis=-1)
    out = _lerp(left, right, jnp.asarray(gamma.astype(npdt)))
    if empty.any():
        out = jnp.where(jnp.asarray(empty)[:, None], jnp.nan, out)
    return out


import weakref

_PLAN_FINITE_HINT: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _extract_mode():
    """Resolve the merge-path extraction option OUTSIDE jit so it enters the
    compiled programs as a static argument (option flips re-trace).
    ``"auto"`` is the flat constant-index gather."""
    from ..utils.options import get_option

    mode = get_option("extract_mode")
    return "flat" if mode == "auto" else mode


def speculative_static_dispatch(plan, probe, call):
    """The one speculation protocol for the windowed static/dynamic pair.

    ``call(static)`` runs the static-count program (``True``, compile-time
    extraction indices) or the NaN-safe dynamic one (``False``).  ``probe``
    is ``None`` when no host fetch is possible (under an outer trace) —
    then the NaN-safe path runs directly — or a 0-arg callable fetching the
    finiteness probe (callers may memoize it across chunked calls).

    With a hopeful hint the static program is dispatched BEFORE the probe
    result is read, so the device runs it while the host waits for the
    probe; the common all-finite case pays no probe latency and a NaN case
    discards one speculative run.  Plans are long-lived: once one has seen non-finite
    data the hint disables speculation for it (the wasted fast run would
    tax every call).
    """
    if probe is None:
        return call(False)
    if _PLAN_FINITE_HINT.get(plan, True):
        out_fast = call(True)  # speculative, races the probe fetch
        if _set_hint(plan, probe()):
            return out_fast
        return call(False)
    return call(True) if _set_hint(plan, probe()) else call(False)


def _set_hint(plan, ok: bool) -> bool:
    _PLAN_FINITE_HINT[plan] = ok
    return ok

_PLAN_DEVICE_CACHE: "weakref.WeakKeyDictionary" = None  # type: ignore[assignment]


def _plan_device_arrays(plan):
    """Device copies of a WindowMergePlan's index arrays, cached per plan.

    Plans are long-lived (cached on the TimeIndex), so their device images
    are too: no host-to-device copy of the indexes per call."""
    global _PLAN_DEVICE_CACHE
    import weakref

    if _PLAN_DEVICE_CACHE is None:
        _PLAN_DEVICE_CACHE = weakref.WeakKeyDictionary()
    hit = _PLAN_DEVICE_CACHE.get(plan)
    if hit is None:
        hit = (
            jnp.asarray(plan.w1_gather),
            jnp.asarray(plan.edge_ids),
            jnp.asarray(plan.edge_gather),
        )
        _PLAN_DEVICE_CACHE[plan] = hit
    return hit


@functools.partial(
    jax.jit,
    static_argnames=(
        "half",
        "window",
        "ypad",
        "wpad",
        "dp",
        "alpha",
        "beta",
        "counts",
        "q_static",
        "edge_tuple",
        "regular",
        "extract_mode",
    ),
)
def _windowed_group_quantile_core(
    x,
    w1_gather,
    edge_ids,
    edge_gather,
    quantiles,
    *,
    half: int,
    window: int,
    ypad: int,
    wpad: int,
    dp: int,
    alpha: float,
    beta: float,
    counts: tuple | None = None,
    q_static: tuple | None = None,
    edge_tuple: tuple = (),
    regular: int | None = None,
    extract_mode: str = "strip",
):
    from .merge import alternate_row_directions, merged_window_rows_xla

    # w1_gather is EXTENDED: G + 2*half rows of virtual groups (year-shifted
    # wrap lists at both ends; see grouper._window_merge_plan), laid out so
    # group g's window is rows [g, g+window) directly.
    Gx, Ymax = w1_gather.shape
    G = Gx - 2 * half
    if regular is not None:
        # regular layout (plan.regular_period): the slab is the transpose of
        # the [years, P] time reshape plus year-dropped wrap slices — no
        # element gathers (bit-identical values by construction)
        P = regular
        lead_ = x.shape[:-1]
        Y = x.shape[-1] // P
        core = jnp.swapaxes(x.reshape(lead_ + (Y, P)), -1, -2)  # [..., P, Y]
        napad = jnp.full(lead_ + (half, 1), jnp.nan, x.dtype)
        head = jnp.concatenate([core[..., P - half : P, : Y - 1], napad], axis=-1)
        tail = jnp.concatenate([core[..., 0:half, 1:], napad], axis=-1)
        vals = jnp.concatenate([head, core, tail], axis=-2)  # [..., Gx, Y]
    else:
        gi = jnp.asarray(w1_gather)
        vals = x[..., jnp.clip(gi, 0, x.shape[-1] - 1)]
        vals = jnp.where(gi < 0, jnp.nan, vals)
    V = jnp.sum(~jnp.isnan(vals), axis=-1).astype(jnp.int32)
    raw = jnp.where(jnp.isnan(vals), jnp.inf, vals)  # [..., Gx, Ymax], unsorted
    if ypad > Ymax:
        raw = jnp.pad(
            raw, [(0, 0)] * (raw.ndim - 1) + [(0, ypad - Ymax)], constant_values=jnp.inf
        )
    lead = x.shape[:-1]
    Sp = jnp.full(lead + (dp, ypad), jnp.inf, dtype=raw.dtype)
    Sp = jax.lax.dynamic_update_slice_in_dim(Sp, raw, 0, axis=raw.ndim - 2)
    B = 1
    for d in lead:
        B *= d
    Sb = Sp.reshape((B, dp, ypad))
    # merged positions past the max possible member count are always +inf:
    # truncating them saves memory traffic on the merged intermediate
    out_width = min(wpad * ypad, -(-(window * Ymax) // ypad) * ypad)
    Sb = alternate_row_directions(jnp.sort(Sb, axis=-1), axis_rows=-2)
    merged = merged_window_rows_xla(Sb, window, G, out_width=out_width)
    merged = merged.reshape(lead + (G, merged.shape[-1]))

    # sliding valid counts over the extended rows: nv[g] = sum V[g : g+window]
    Vp = jnp.pad(V, [(0, 0)] * (V.ndim - 1) + [(0, max(window - 2 * half, 0))])
    cs = jnp.cumsum(Vp, axis=-1)
    cs = jnp.pad(cs, [(0, 0)] * (cs.ndim - 1) + [(1, 0)])
    idx = jnp.arange(G)
    nv = cs[..., idx + window] - cs[..., idx]

    q = jnp.asarray(quantiles, dtype=x.dtype)
    out = None
    if counts is not None and q_static is not None:
        # host-known valid counts: fully-static extraction (flat constant
        # gather, one-hot matmul contraction, or strip selects —
        # bit-identical, ``extract_mode`` option)
        if extract_mode == "matmul" and merged.dtype == jnp.float32:
            out = _static_matmul_extract(merged, counts, q_static, edge_tuple, alpha, beta)
        elif extract_mode in ("flat", "matmul"):  # matmul falls back off-f32
            out = _static_flat_extract(merged, counts, q_static, edge_tuple, alpha, beta)
        else:
            out = _static_strip_extract(merged, counts, q_static, edge_tuple, alpha, beta)
        if out is not None:
            # all-NaN site rows (ocean masks) are static-safe only with an
            # explicit mask: their slab rows sort to [+inf pads..., NaNs],
            # so the static strip reads pad values, not NaN
            allnan = jnp.all(jnp.isnan(x), axis=-1)
            out = jnp.where(allnan[..., None, None], jnp.nan, out)
    if out is None:
        out = _quantile_on_sorted(merged, nv, q, alpha, beta, sentinel="inf")

    if edge_gather.shape[0]:
        ge = jnp.asarray(edge_gather)
        xe = x[..., jnp.clip(ge, 0, x.shape[-1] - 1)]
        xe = jnp.where(ge < 0, jnp.nan, xe)
        qe = nan_quantile(xe, q, axis=-1, alpha=alpha, beta=beta)
        out = out.at[..., jnp.asarray(edge_ids), :].set(qe)
    return out


def windowed_group_quantile(
    x,
    plan,
    quantiles,
    alpha: float = 1.0,
    beta: float = 1.0,
    engine: str | None = None,
):
    """Windowed grouped quantile without re-sorting the window-amplified
    gather matrix.

    Selects the same order statistics as ``grouped_nan_quantile(x,
    gi.gather_idx, q)`` for windowed dayofyear / "5D" groupings (same multiset
    per group, same type-7 semantics) — the reference's rolling-construct
    semantics (``base.py:261-265``).  ``engine`` (default: the platform's,
    :func:`windowed_engine`) is ``"gather"`` or ``"emit"`` (counting
    selection, bit-identical to the jitted re-sort oracle) or ``"merge"``:
    sort each window-1 list once and merge ``window`` pre-sorted lists per
    group (``ops/merge.py``), at ~1/window of the sort work; edge groups
    (year wrap / series boundary) take the exact gather+sort path.
    Precision note for the merge engine: its static extraction computes the
    type-7 virtual index/gamma with strict numpy f32 rounding, while the
    device oracle's ``n*q + c`` may be FMA-contracted by XLA — a 1-ulp
    difference in gamma that moves interpolated values by a few ulp on some
    (count, q) pairs (selected elements are always identical; measured max
    ~5e-7 relative).

    ``plan`` is a :class:`~xsdba_tpu.utils.grouper.WindowMergePlan`
    (``GroupIndexes.merge_plan``).
    """
    x = jnp.asarray(x)
    if engine is None:
        engine = windowed_engine(plan, quantiles)
    if engine != "merge":
        # counting selection: one NaN-exact program, no merge, no
        # speculative static/dynamic dispatch (ops/selquant.py)
        from .selquant import selection_windowed_quantile

        return selection_windowed_quantile(x, plan, quantiles, alpha=alpha, beta=beta, mode=engine)

    w1_dev, eid_dev, eg_dev = _plan_device_arrays(plan)

    # One host-fetched scalar decides the extraction form statically: with
    # all-finite data the valid counts equal the plan's member counts, so
    # extraction indices are compile-time constants (a traced cond would
    # compile both extraction branches).  The fetch waits for the device, so
    # the finite-path compute is dispatched OPTIMISTICALLY before the probe
    # result is read — the common all-finite case pays no probe latency at
    # all, and the NaN case discards one speculative run.
    can_static = (
        np.ndim(quantiles) == 1
        and plan.nv_host is not None
        and not isinstance(x, jax.core.Tracer)  # no host probe under a trace
    )
    probe_dev = _finite_probe(x) if can_static else None
    extract_mode = _extract_mode()

    def run(xc, static: bool):
        if static:
            counts = tuple(int(c) for c in plan.nv_host)
            q_static = tuple(float(qv) for qv in np.asarray(quantiles, np.float64))
            edge_tuple = tuple(int(e) for e in plan.edge_ids)
        else:
            counts = q_static = None
            edge_tuple = ()
        return _windowed_group_quantile_core(
            xc,
            w1_dev,
            eid_dev,
            eg_dev,
            jnp.asarray(quantiles, dtype=x.dtype),
            half=plan.half,
            window=plan.window,
            ypad=plan.ypad,
            wpad=plan.wpad,
            dp=plan.dp,
            alpha=alpha,
            beta=beta,
            counts=counts,
            q_static=q_static,
            edge_tuple=edge_tuple,
            regular=plan.regular_period,
            extract_mode=extract_mode,
        )

    # bound the cascade's window slab ([chunk, G, wpad, ypad]) to ~4 GB f32
    G = plan.w1_gather.shape[0] - 2 * plan.half
    per_site = G * plan.wpad * plan.ypad
    max_chunk = max(1, (1 << 30) // per_site)
    def run_all(xc):
        if xc.ndim <= 1:
            return _run_dispatch(xc)
        lead = xc.shape[:-1]
        B = int(np.prod(lead)) if lead else 1
        if B <= max_chunk:
            return _run_dispatch(xc)
        # chunk over the FLATTENED batch (leading dims may hide a big product)
        xf = xc.reshape((B, xc.shape[-1]))
        chunks = [_run_dispatch(xf[i : i + max_chunk]) for i in range(0, B, max_chunk)]
        out = jnp.concatenate(chunks, axis=0)
        return out.reshape(lead + out.shape[1:])

    probe_val: list = []

    def _probe() -> bool:
        # memoized: chunked calls share one probe fetch
        if not probe_val:
            probe_val.append(bool(probe_dev))
        return probe_val[0]

    def _run_dispatch(xc):
        return speculative_static_dispatch(
            plan, None if probe_dev is None else _probe, lambda static: run(xc, static)
        )

    return run_all(x)
