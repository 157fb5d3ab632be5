"""Quantile-table lookup: the adjust-time hot path.

Replaces the reference's ``interp_on_quantiles`` (``utils.py:317-513``):

- ungrouped: per-slice ``scipy.interp1d`` with constant/NaN extrapolation from
  the first/last *non-NaN* table entries (``utils.py:350-377``);
- grouped: 2-D ``scipy.griddata`` over (value, fractional group index) with
  cyclic group padding + numba constant extrapolation
  (``utils.py:380-400``, ``nbutils.py:397-416``).

Design: the lookup is gather-free: the quantile axis is *unrolled* (nq is a
small static constant), locating each value by summed comparisons and
selecting bounds by masked accumulation; the grouped variant loops over the
(static) group count, slicing one [batch, nq] table per step and
mask-accumulating into the output.  On the GPU the partitioned grouped
lookup runs the same arithmetic as a Triton kernel (``ops/pallas/interp.py``).

The grouped case is *separable*: evaluate the 1-D interpolant of the two
groups bracketing each timestep's cyclic fractional index and blend linearly
— the structured equivalent of griddata's triangulation on this
quasi-regular grid (documented deviation: identical on the regular interior,
smoother near group boundaries).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "interp1d_table",
    "interp_grouped_partitioned",
    "interp_on_quantiles_grouped",
    "interp_on_quantiles_reference",
    "searchsorted_batched",
]


def searchsorted_batched(sorted_x, v, side: str = "right"):
    """Batched searchsorted as an explicit binary search of take_along_axis
    gathers — log2(n) fully-vectorized steps.  Prefer the unrolled-table
    routines below for hot paths with small n."""
    n = sorted_x.shape[-1]
    batch = jnp.broadcast_shapes(sorted_x.shape[:-1], v.shape[:-1])
    sx = jnp.broadcast_to(sorted_x, batch + (n,))
    vv = jnp.broadcast_to(v, batch + v.shape[-1:])
    lo = jnp.full(vv.shape, -1, dtype=jnp.int32)
    hi = jnp.full(vv.shape, n, dtype=jnp.int32)
    for _ in range(max(1, int(np.ceil(np.log2(n + 1))))):
        mid = (lo + hi) // 2
        midc = jnp.clip(mid, 0, n - 1)
        xm = jnp.take_along_axis(sx, midc, axis=-1)
        cmp = xm <= vv if side == "right" else xm < vv
        go = cmp & (mid >= 0) & (mid < n)
        lo = jnp.where(go, mid, lo)
        hi = jnp.where(go, hi, mid)
    return lo + 1


def _compact_nan_pairs(xq, yq):
    """Drop (x, y) pairs where either is NaN by sorting them to the end.

    Matches the reference's mask ``isnan(oldx)|isnan(oldy)`` (utils.py:351).
    xq is assumed ascending (quantile tables); the compaction keeps order.
    Returns (xs, ys, nvalid) with invalid xs set to +inf.
    """
    bad = jnp.isnan(xq) | jnp.isnan(yq)
    key = jnp.where(bad, jnp.inf, xq)
    order = jnp.argsort(key, axis=-1)
    xs = jnp.take_along_axis(key, order, axis=-1)
    ys = jnp.take_along_axis(yq, order, axis=-1)
    nvalid = jnp.sum(~bad, axis=-1)
    return xs, ys, nvalid


_UNROLL_MAX_NQ = 64


def _cubic_slopes(xs, ys, nvalid):
    """Not-a-knot cubic-spline SLOPES at the first ``nvalid`` compacted nodes.

    Solves the same tridiagonal system as scipy ``CubicSpline`` /
    ``interp1d(kind="cubic")`` (scipy ``_cubic.py``: interior rows
    ``dx_i s_{i-1} + 2(dx_{i-1}+dx_i) s_i + dx_{i-1} s_{i+1} =
    3(dx_i m_{i-1} + dx_{i-1} m_i)`` plus the two not-a-knot boundary rows),
    Thomas-eliminated as a ``lax.scan`` over the static node axis and fully
    batched over leading dims.  Reference behavior replicated:
    ``utils.py:350-377`` passes the NaN-compacted table to scipy, so the
    system here is built on the first ``nvalid`` nodes only — rows past
    ``nvalid`` are identity (the boundary row floats to index ``nvalid-1``).

    Degenerate rows (``nvalid < 4``, where scipy raises) and rows with
    duplicated nodes (where scipy raises too) are NOT handled here: the
    former fall back to linear in the caller, the latter propagate NaN
    through the slope division — both documented deviations from an
    exception the device path cannot raise.

    xs, ys: [..., n] compacted (+inf x pads); nvalid: [...].  Returns
    s [..., n] (garbage past ``nvalid`` — never selected by the caller).
    """
    n = xs.shape[-1]
    dt = xs.dtype
    m = nvalid[..., None].astype(jnp.int32)                       # [..., 1]
    xsf = jnp.where(jnp.isfinite(xs), xs, 0.0)
    seg = jnp.arange(n - 1, dtype=jnp.int32)
    valid_seg = seg < (m - 1)                                      # [..., n-1]
    dx = jnp.where(valid_seg, xsf[..., 1:] - xsf[..., :-1], 1.0)
    sl = jnp.where(valid_seg, (ys[..., 1:] - ys[..., :-1]) / dx, 0.0)

    def seg_at(a, idx):
        return jnp.take_along_axis(a, jnp.clip(idx, 0, n - 2), axis=-1)

    def node_at(a, idx):
        return jnp.take_along_axis(a, jnp.clip(idx, 0, n - 1), axis=-1)

    # interior coefficient arrays, aligned so index i holds dx_{i-1} / dx_i
    one_seg = jnp.ones_like(dx[..., :1])
    zero_seg = jnp.zeros_like(one_seg)
    dx_im1 = jnp.concatenate([one_seg, dx], axis=-1)
    dx_i = jnp.concatenate([dx, one_seg], axis=-1)
    sl_im1 = jnp.concatenate([zero_seg, sl], axis=-1)
    sl_i = jnp.concatenate([sl, zero_seg], axis=-1)
    a = dx_i
    b = 2.0 * (dx_im1 + dx_i)
    c = dx_im1
    r = 3.0 * (dx_i * sl_im1 + dx_im1 * sl_i)

    ii = jnp.arange(n, dtype=jnp.int32)
    # first boundary row (static index 0): scipy _cubic.py not-a-knot start
    dx0 = dx[..., 0:1]
    dx1 = dx[..., 1:2]
    d0 = xsf[..., 2:3] - xsf[..., 0:1]
    d0s = jnp.where(d0 != 0, d0, 1.0)
    b_first = dx1
    c_first = d0
    r_first = ((dx0 + 2.0 * d0) * dx1 * sl[..., 0:1] + dx0 * dx0 * sl[..., 1:2]) / d0s
    # last boundary row (dynamic index m-1): not-a-knot end
    dxm2 = seg_at(dx, m - 2)
    dxm3 = seg_at(dx, m - 3)
    slm2 = seg_at(sl, m - 2)
    slm3 = seg_at(sl, m - 3)
    d2 = node_at(xsf, m - 1) - node_at(xsf, m - 3)
    d2s = jnp.where(d2 != 0, d2, 1.0)
    a_last = d2
    b_last = dxm3
    r_last = (dxm2 * dxm2 * slm3 + (2.0 * d2 + dxm2) * dxm3 * slm2) / d2s

    is0 = ii == 0
    is_last = ii == (m - 1)
    is_pad = ii >= m
    zero = jnp.zeros((), dt)
    one = jnp.ones((), dt)
    a = jnp.where(is0, zero, a)
    b = jnp.where(is0, b_first, b)
    c = jnp.where(is0, c_first, c)
    r = jnp.where(is0, r_first, r)
    a = jnp.where(is_last, a_last, a)
    b = jnp.where(is_last, b_last, b)
    c = jnp.where(is_last, zero, c)
    r = jnp.where(is_last, r_last, r)
    a = jnp.where(is_pad, zero, a)
    b = jnp.where(is_pad, one, b)
    c = jnp.where(is_pad, zero, c)
    r = jnp.where(is_pad, zero, r)

    # Thomas: forward elimination then back substitution, scanned over the
    # static node axis (batch rides fully vectorized in the carry)
    batch = jnp.broadcast_shapes(a.shape, b.shape, c.shape, r.shape)[:-1]
    abcr = tuple(
        jnp.moveaxis(jnp.broadcast_to(t, batch + (n,)), -1, 0) for t in (a, b, c, r)
    )  # each [n, ...batch]

    def fwd(carry, row):
        cp_prev, rp_prev = carry
        ak, bk, ck, rk = row
        denom = bk - ak * cp_prev
        denom = jnp.where(denom == 0, jnp.asarray(jnp.nan, dt), denom)
        cp = ck / denom
        rp = (rk - ak * rp_prev) / denom
        return (cp, rp), (cp, rp)

    z = jnp.zeros(batch, dt)
    _, (cps, rps) = jax.lax.scan(fwd, (z, z), abcr)

    def bwd(s_next, cr):
        cp, rp = cr
        s_k = rp - cp * s_next
        return s_k, s_k

    _, s_rev = jax.lax.scan(bwd, z, (cps, rps), reverse=True)
    return jnp.moveaxis(s_rev, 0, -1)


def _eval_cubic_segment(v, x0, x1, y0, y1, s0, s1, lin):
    """Hermite evaluation of one cubic segment from endpoint slopes (scipy
    ``_cubic.py`` coefficient form); ``lin`` substitutes where the segment is
    degenerate (h == 0 never happens on a valid strictly-increasing table —
    duplicated nodes already carry NaN slopes)."""
    h = x1 - x0
    hs = jnp.where(h > 0, h, 1.0)
    mseg = (y1 - y0) / hs
    tc = (s0 + s1 - 2.0 * mseg) / hs
    dlt = v - x0
    cub = y0 + dlt * (s0 + dlt * ((mseg - s0) / hs - tc + dlt * (tc / hs)))
    return jnp.where(h > 0, cub, lin)


def _interp_unrolled(v, xs, ys, nvalid, method: str, extrap: str):
    """Evaluate the compacted table (xs, ys, nvalid) at v, gather-free.

    v: [..., T]; xs/ys: [..., nq] (leading dims broadcastable); nvalid [...].
    The nq axis is unrolled: count = sum_k (xs_k <= v) locates the segment,
    masked accumulation selects the bounds.

    Above ``_UNROLL_MAX_NQ`` entries the unroll would bloat the XLA graph
    (compile time scales linearly with nq) — a log2(nq) binary-search +
    gather variant with identical semantics takes over (ExtremeValues tables
    have thousands of entries).
    """
    nq = xs.shape[-1]
    if nq > _UNROLL_MAX_NQ:
        return _interp_gathered(v, xs, ys, nvalid, method, extrap)
    last = jnp.clip(nvalid - 1, 0, nq - 1)[..., None]
    cubic = method == "cubic"
    if cubic:
        sp = _cubic_slopes(xs, ys, nvalid)

    cnt = jnp.zeros(jnp.broadcast_shapes(v.shape, xs.shape[:-1] + (1,)), dtype=jnp.int32)
    for k in range(nq):
        cnt = cnt + (xs[..., k : k + 1] <= v)
    k0 = jnp.clip(cnt - 1, 0, jnp.maximum(nvalid - 2, 0)[..., None])

    x0 = jnp.zeros_like(v, shape=cnt.shape)
    x1 = jnp.zeros_like(x0)
    y0 = jnp.zeros_like(x0)
    y1 = jnp.zeros_like(x0)
    x_last = jnp.zeros_like(x0)
    y_last = jnp.zeros_like(x0)
    s0 = jnp.zeros_like(x0) if cubic else None
    s1 = jnp.zeros_like(x0) if cubic else None
    for k in range(nq):
        xk = xs[..., k : k + 1]
        yk = ys[..., k : k + 1]
        m0 = k0 == k
        if k < nq - 1:
            x0 = jnp.where(m0, xk, x0)
            y0 = jnp.where(m0, yk, y0)
            x1 = jnp.where(m0, xs[..., k + 1 : k + 2], x1)
            y1 = jnp.where(m0, ys[..., k + 1 : k + 2], y1)
            if cubic:
                s0 = jnp.where(m0, sp[..., k : k + 1], s0)
                s1 = jnp.where(m0, sp[..., k + 1 : k + 2], s1)
        else:
            x0 = jnp.where(m0, xk, x0)
            y0 = jnp.where(m0, yk, y0)
            x1 = jnp.where(m0, jnp.inf, x1)
            y1 = jnp.where(m0, yk, y1)
            if cubic:
                s0 = jnp.where(m0, sp[..., k : k + 1], s0)
                s1 = jnp.where(m0, sp[..., k : k + 1], s1)
        ml = last == k
        x_last = jnp.where(ml, xk, x_last)
        y_last = jnp.where(ml, yk, y_last)

    # a single-valid-pair table pairs y0 with the NaN pad slot: t is 0
    # there, but 0 * (NaN - y0) would still poison the blend
    y1 = jnp.where(jnp.isnan(y1), y0, y1)
    dx = x1 - x0
    t = jnp.where(dx > 0, (v - x0) / jnp.where(dx == 0, 1, dx), 0.0)
    t = jnp.where(jnp.isfinite(t), t, 0.0)
    if method == "linear":
        out = y0 + t * (y1 - y0)
    elif method == "nearest":
        out = jnp.where(jnp.abs(v - x0) <= jnp.abs(x1 - v), y0, y1)
    elif cubic:
        lin = y0 + t * (y1 - y0)
        out = _eval_cubic_segment(v, x0, x1, y0, y1, s0, s1, lin)
        # scipy raises below 4 nodes (make_interp_spline k=3 needs n > 3);
        # the device path degrades to linear there (documented deviation)
        out = jnp.where(nvalid[..., None] < 4, lin, out)
    else:
        raise NotImplementedError(f"method={method!r}")

    x_first = xs[..., :1]
    y_first = ys[..., :1]
    below = v < x_first
    above = v > x_last
    if extrap == "constant":
        out = jnp.where(below, y_first, out)
        out = jnp.where(above, y_last, out)
    elif extrap == "nan":
        out = jnp.where(below | above, jnp.nan, out)
    else:
        raise ValueError(f"extrapolation must be 'constant' or 'nan', got {extrap!r}")

    out = jnp.where(nvalid[..., None] == 0, jnp.nan, out)
    return jnp.where(jnp.isnan(v), jnp.nan, out)


def _interp_gathered(v, xs, ys, nvalid, method: str, extrap: str):
    """Large-table form of :func:`_interp_unrolled` — binary-search locate
    (log2 nq vectorized steps) + take_along_axis bound selection.  Bitwise
    the same semantics; used when unrolling would blow up compile time."""
    nq = xs.shape[-1]
    cnt = searchsorted_batched(xs, v, side="right")
    k0 = jnp.clip(cnt - 1, 0, jnp.maximum(nvalid - 2, 0)[..., None])

    def take(a, idx):
        aa = jnp.broadcast_to(a, jnp.broadcast_shapes(a.shape, idx.shape[:-1] + a.shape[-1:]))
        return jnp.take_along_axis(aa, idx, axis=-1)

    x0 = take(xs, k0)
    y0 = take(ys, k0)
    k1 = jnp.clip(k0 + 1, 0, nq - 1)
    at_end = k0 == nq - 1
    x1 = jnp.where(at_end, jnp.inf, take(xs, k1))
    y1 = jnp.where(at_end, y0, take(ys, k1))
    y1 = jnp.where(jnp.isnan(y1), y0, y1)  # single-valid-pair: NaN pad slot
    last = jnp.clip(nvalid - 1, 0, nq - 1)[..., None] * jnp.ones_like(k0)
    x_last = take(xs, last)
    y_last = take(ys, last)

    dx = x1 - x0
    t = jnp.where(dx > 0, (v - x0) / jnp.where(dx == 0, 1, dx), 0.0)
    t = jnp.where(jnp.isfinite(t), t, 0.0)
    if method == "linear":
        out = y0 + t * (y1 - y0)
    elif method == "nearest":
        out = jnp.where(jnp.abs(v - x0) <= jnp.abs(x1 - v), y0, y1)
    elif method == "cubic":
        sp = _cubic_slopes(xs, ys, nvalid)
        s0 = take(sp, k0)
        s1 = jnp.where(at_end, s0, take(sp, k1))
        lin = y0 + t * (y1 - y0)
        out = _eval_cubic_segment(v, x0, x1, y0, y1, s0, s1, lin)
        out = jnp.where(nvalid[..., None] < 4, lin, out)  # scipy raises < 4
    else:
        raise NotImplementedError(f"method={method!r}")

    x_first = xs[..., :1]
    y_first = ys[..., :1]
    below = v < x_first
    above = v > x_last
    if extrap == "constant":
        out = jnp.where(below, y_first, out)
        out = jnp.where(above, y_last, out)
    elif extrap == "nan":
        out = jnp.where(below | above, jnp.nan, out)
    else:
        raise ValueError(f"extrapolation must be 'constant' or 'nan', got {extrap!r}")

    out = jnp.where(nvalid[..., None] == 0, jnp.nan, out)
    return jnp.where(jnp.isnan(v), jnp.nan, out)


def interp1d_table(v, xq, yq, method: str = "linear", extrap: str = "constant"):
    """Evaluate the monotone table (xq, yq) at points v, batched.

    v: [..., T]; xq, yq: [..., nq] (leading dims broadcastable with v's).
    NaN pairs in the table are ignored; NaN in v stays NaN.
    ``extrap``: 'constant' fills beyond the table with the first/last valid
    yq; 'nan' fills with NaN (reference utils.py:353-368).
    ``method``: 'linear', 'nearest' or 'cubic' (not-a-knot spline matching
    scipy ``interp1d(kind="cubic")``; rows with < 4 valid nodes degrade to
    linear where scipy raises — documented deviation).
    """
    v = jnp.asarray(v)
    xs, ys, nvalid = _compact_nan_pairs(jnp.asarray(xq), jnp.asarray(yq))
    return _interp_unrolled(v, xs, ys, nvalid, method, extrap)


def _compact_sorted_tables(xq, yq):
    """Compaction fast path for tables KNOWN to be ascending with NaN pairs
    only as whole rows (quantile-trained tables: type-7 quantiles at
    ascending q are non-decreasing, and a group is either fitted — all nq
    entries finite — or empty — all NaN).  Bit-identical to
    :func:`_compact_nan_pairs` on such tables (the stable argsort there is
    the identity permutation), without the argsort + two take_along_axis
    gathers, which in the fused train+adjust program would run PER STEP on
    the [B, G+2, nq] tables."""
    bad = jnp.isnan(xq) | jnp.isnan(yq)
    xs = jnp.where(bad, jnp.inf, xq)
    ys = jnp.where(bad, jnp.nan, yq)
    return xs, ys, jnp.sum(~bad, axis=-1)


def _pad_cyclic_tables(xq, yq, tables_compact: bool = False):
    """Compact NaN pairs and add the cyclic group padding (one group wrapped
    on each side; reference utils.py:284-314).  ``tables_compact`` asserts
    the quantile-trained table shape (see :func:`_compact_sorted_tables`)."""
    compact = _compact_sorted_tables if tables_compact else _compact_nan_pairs
    xq, yq, nvalid = compact(jnp.asarray(xq), jnp.asarray(yq))
    G = xq.shape[-2]
    if G > 1:
        xq_p = jnp.concatenate([xq[..., -1:, :], xq, xq[..., :1, :]], axis=-2)
        yq_p = jnp.concatenate([yq[..., -1:, :], yq, yq[..., :1, :]], axis=-2)
        nv_p = jnp.concatenate([nvalid[..., -1:], nvalid, nvalid[..., :1]], axis=-1)
    else:
        xq_p, yq_p, nv_p = xq, yq, nvalid
    return xq_p, yq_p, nv_p


def use_triton_kernel(method: str, extrap: str, nq: int, dtype) -> bool:
    """The partitioned lookup runs the Triton kernel (``ops/pallas/interp.py``)
    on the GPU for the linear / constant-extrapolation f32 case with an
    unrolled table; everything else, and every other platform, runs
    :func:`_interp_unrolled`."""
    return (
        jax.default_backend() == "gpu"
        and method == "linear"
        and extrap == "constant"
        and nq <= _UNROLL_MAX_NQ
        and jnp.dtype(dtype) == jnp.float32
    )


def interp_grouped_partitioned(
    v,
    xq,
    yq,
    part0,
    g0,
    slot0,
    part1,
    g1,
    slot1,
    w,
    method: str = "linear",
    extrap: str = "constant",
    regular0: int | None = None,
    tables_compact: bool = False,
):
    """Grouped table lookup via static bracketing partitions.

    The fast form of :func:`interp_on_quantiles_grouped` when the caller has
    ``GroupIndexes.bracket_partitions``: the time axis is partitioned by
    bracketing padded group (``part0/part1`` [Gp, Lp], -1-padded), each
    partition row is evaluated against its *own* table in one vectorized
    ``_interp_unrolled`` call, and results scatter back through cheap
    long-axis gathers.  Work is 2·nq·T regardless of the group count
    (the fori_loop form is G·nq·T).

    ``tables_compact``: the tables are quantile-trained (ascending, NaN rows
    whole) — skip the argsort-based NaN compaction (bit-identical there;
    see :func:`_compact_sorted_tables`).
    """
    v = jnp.asarray(v)
    xq_p, yq_p, nv_p = _pad_cyclic_tables(xq, yq, tables_compact)
    nq = xq_p.shape[-1]

    def _eval_tables(vals):
        return _eval_tables_sliced(vals, xq_p, yq_p, nv_p)

    def eval_partition(part, grp, slot):
        pi = jnp.asarray(part)
        vals = jnp.where(pi >= 0, v[..., jnp.clip(pi, 0, v.shape[-1] - 1)], jnp.nan)  # [..., Gp, Lp]
        out = _eval_tables(vals)                                                       # [..., Gp, Lp]
        return out[..., jnp.asarray(grp), jnp.asarray(slot)]                            # [..., T]

    def eval_partition_regular(P):
        # partition rows 1..P are the transpose of the [years, P] reshape of
        # the time axis (Brackets.regular0): skip the element gathers and the
        # empty pad rows entirely — reshape in, evaluate against the matching
        # table rows, reshape out
        T = v.shape[-1]
        Y = T // P
        lead = v.shape[:-1]
        core = jnp.swapaxes(v.reshape(lead + (Y, P)), -1, -2)  # [..., P, Y]
        sl = (Ellipsis, slice(1, P + 1), slice(None))
        out = _eval_tables_sliced(core, xq_p[sl], yq_p[sl], nv_p[..., 1 : P + 1])
        return jnp.swapaxes(out, -1, -2).reshape(lead + (T,))

    def _eval_tables_sliced(vals, xqs, yqs, nvs):
        if use_triton_kernel(method, extrap, nq, vals.dtype):
            from .pallas.interp import interp_rows

            return interp_rows(vals, xqs, yqs, nvs)
        return _interp_unrolled(vals, xqs, yqs, nvs, method, extrap)

    if regular0 is not None and part1 is None:
        return eval_partition_regular(int(regular0))

    val0 = eval_partition(part0, g0, slot0)
    if part1 is None:  # collapsed brackets (nearest method / integer indexes)
        return val0
    val1 = eval_partition(part1, g1, slot1)
    ww = jnp.asarray(w, dtype=v.dtype)
    return (1 - ww) * val0 + ww * val1


def interp_on_quantiles_grouped(
    v,
    frac_idx,
    xq,
    yq,
    group_positions,
    method: str = "linear",
    extrap: str = "constant",
):
    """Grouped quantile-table lookup with cyclic group blending.

    v: [..., T] values to look up; frac_idx: [T] fractional group index
    (1-based month/doy style — see ``Grouper.interp_index``);
    xq, yq: [..., G, nq] per-group tables; group_positions: [G] the group
    coordinate values (e.g. 1..12 for months).

    Equivalent of reference ``utils.py:409-513``: groups are cyclically padded
    (``add_cyclic_bounds``, utils.py:284-314) so indexes below the first /
    above the last group blend with the wrapped-around group.  For each
    timestep the two bracketing group tables are evaluated in 1-D and blended
    linearly by the fractional offset.  One fori_loop over the padded groups;
    each step is gather-free.
    """
    v = jnp.asarray(v)
    xq, yq, nvalid = _compact_nan_pairs(jnp.asarray(xq), jnp.asarray(yq))
    frac = jnp.asarray(frac_idx, dtype=v.dtype)
    pos = jnp.asarray(group_positions, dtype=v.dtype)
    G = xq.shape[-2]

    # Cyclic padding: prepend the last group at pos[0]-step0, append the first
    # at pos[-1]+step1 (reference utils.py:284-314, cyclic_coords=False).
    if G > 1:
        step0 = pos[1] - pos[0]
        step1 = pos[-1] - pos[-2]
        pos_p = jnp.concatenate([pos[:1] - step0, pos, pos[-1:] + step1])
        xq_p = jnp.concatenate([xq[..., -1:, :], xq, xq[..., :1, :]], axis=-2)
        yq_p = jnp.concatenate([yq[..., -1:, :], yq, yq[..., :1, :]], axis=-2)
        nv_p = jnp.concatenate([nvalid[..., -1:], nvalid, nvalid[..., :1]], axis=-1)
    else:
        pos_p, xq_p, yq_p, nv_p = pos, xq, yq, nvalid
    Gp = xq_p.shape[-2]

    if method == "nearest" or G == 1:
        # single target group per timestep (both brackets collapse onto it)
        g = jnp.clip(jnp.searchsorted(pos_p, frac, side="left"), 1, Gp - 1)
        g0 = jnp.where(frac - pos_p[g - 1] < pos_p[g] - frac, g - 1, g).astype(jnp.int32)
        g1 = g0
        w = jnp.zeros_like(frac)
    else:
        g1 = jnp.clip(jnp.searchsorted(pos_p, frac, side="right"), 1, Gp - 1).astype(jnp.int32)
        g0 = g1 - 1
        p0 = pos_p[g0]
        p1 = pos_p[g1]
        w = jnp.where(p1 > p0, (frac - p0) / jnp.where(p1 == p0, 1, p1 - p0), 0.0)

    batch = jnp.broadcast_shapes(v.shape[:-1], xq_p.shape[:-2])
    acc0 = jnp.zeros(batch + v.shape[-1:], dtype=v.dtype)

    # contributions: (1-w) from the g0 table, w from the g1 table; when the
    # brackets collapse (nearest / G == 1) weight the single table fully.
    def body2(g, acc):
        xs = jax.lax.dynamic_index_in_dim(xq_p, g, axis=xq_p.ndim - 2, keepdims=False)
        ys = jax.lax.dynamic_index_in_dim(yq_p, g, axis=yq_p.ndim - 2, keepdims=False)
        nv = jax.lax.dynamic_index_in_dim(nv_p, g, axis=nv_p.ndim - 1, keepdims=False)
        val = _interp_unrolled(v, xs, ys, nv, method, extrap)
        w0 = jnp.where(g1 == g0, 1.0, 1 - w)
        c = jnp.where(g0 == g, w0 * val, 0.0) + jnp.where((g1 == g) & (g1 != g0), w * val, 0.0)
        return acc + c

    return jax.lax.fori_loop(0, Gp, body2, acc0)


# ---------------------------------------------------------------------------
# exact reference-parity grouped lookup (host; scipy griddata)
# ---------------------------------------------------------------------------


def _first_last_nonnull(a):
    """Per-row (first, last) non-NaN values of a [..., nq] array
    (reference ``nbutils.py:378-394``)."""
    a = np.asarray(a, dtype=np.float64)
    valid = ~np.isnan(a)
    anyv = valid.any(axis=-1)
    first_i = np.argmax(valid, axis=-1)
    last_i = a.shape[-1] - 1 - np.argmax(valid[..., ::-1], axis=-1)
    first = np.take_along_axis(a, first_i[..., None], axis=-1)[..., 0]
    last = np.take_along_axis(a, last_i[..., None], axis=-1)[..., 0]
    return (
        np.where(anyv, first, np.nan),
        np.where(anyv, last, np.nan),
    )


def interp_on_quantiles_reference(
    v,
    newg,
    xq,
    yq,
    group_positions,
    method: str = "linear",
    extrap: str = "constant",
):
    """Bit-faithful reimplementation of the reference's grouped
    ``interp_on_quantiles`` (``utils.py:380-400`` + ``nbutils.py:397-416``):
    cyclic-pad the group axis with extrapolated coordinates, drop NaN nodes,
    run ``scipy.interpolate.griddata`` over the scattered
    (value, group-index) points, then re-apply the constant/nan
    extrapolation outside each group's interpolated table span.

    Host path — parity runs, not perf runs.  Shapes: ``v`` [..., T],
    ``newg`` [T] (fractional group index for linear/cubic, exact group
    coordinates for nearest), ``xq``/``yq`` [..., G, nq],
    ``group_positions`` [G].
    """
    v = np.asarray(v, dtype=np.float64)
    newg = np.asarray(newg, dtype=np.float64)
    xq = np.asarray(xq, dtype=np.float64)
    yq = np.asarray(yq, dtype=np.float64)
    pos = np.asarray(group_positions, dtype=np.float64)
    G = pos.shape[0]

    # reference add_cyclic_bounds(..., cyclic_coords=False): wrap the rows,
    # extrapolate the coordinate by its neighbouring step
    if G > 1:
        pos_p = np.concatenate([[2 * pos[0] - pos[1]], pos, [2 * pos[-1] - pos[-2]]])
    else:
        pos_p = np.concatenate([pos - 1.0, pos, pos + 1.0])
    xq_p = np.concatenate([xq[..., -1:, :], xq, xq[..., :1, :]], axis=-2)
    yq_p = np.concatenate([yq[..., -1:, :], yq, yq[..., :1, :]], axis=-2)

    batch = np.broadcast_shapes(v.shape[:-1], xq.shape[:-2], yq.shape[:-2])
    T = v.shape[-1]
    nq = xq.shape[-1]
    vf = np.broadcast_to(v, batch + (T,)).reshape(-1, T)
    xf = np.broadcast_to(xq_p, batch + (G + 2, nq)).reshape(-1, G + 2, nq)
    yf = np.broadcast_to(yq_p, batch + (G + 2, nq)).reshape(-1, G + 2, nq)
    oldg = np.broadcast_to(pos_p[:, None], (G + 2, nq))

    # when the tables carry no batch dims (e.g. QDM's shared quantile nodes)
    # every row interpolates over the SAME (value, group) point cloud —
    # triangulate once instead of once per row (Delaunay dominates griddata)
    shared = xq.ndim == 2 and yq.ndim == 2
    fn_shared = lo_x = hi_x = lo_y = hi_y = None
    if shared:
        mask_old = np.isnan(xq_p) | np.isnan(yq_p)
        if not mask_old.all():
            fn_shared = _griddata_interpolator(
                xq_p[~mask_old], oldg[~mask_old], yq_p[~mask_old], method
            )
            # extrapolation bounds depend only on the tables and newg: hoist
            blo, bhi = _first_last_nonnull(xq_p)
            lo_x = np.interp(newg, pos_p, blo)
            hi_x = np.interp(newg, pos_p, bhi)
            if extrap == "constant":
                clo, chi = _first_last_nonnull(yq_p)
                lo_y = np.interp(newg, pos_p, clo)
                hi_y = np.interp(newg, pos_p, chi)

    out = np.full_like(vf, np.nan)
    for b in range(vf.shape[0]):
        newx = vf[b]
        mask_new = np.isnan(newx) | np.isnan(newg)
        if mask_new.all():
            continue
        if shared:
            if fn_shared is None:
                continue
            fn = fn_shared
        else:
            oldx, oldy = xf[b], yf[b]
            mask_old = np.isnan(oldx) | np.isnan(oldy)
            if mask_old.all():
                continue
            fn = _griddata_interpolator(
                oldx[~mask_old], oldg[~mask_old], oldy[~mask_old], method
            )
        res = out[b]
        res[~mask_new] = fn(newx[~mask_new], newg[~mask_new])
        if method == "nearest" or extrap != "nan":
            # nbutils._extrapolate_on_quantiles: per-group table span,
            # linearly interpolated over the padded group coordinate
            if shared:
                toolow = newx < lo_x
                toohigh = newx > hi_x
            else:
                blo, bhi = _first_last_nonnull(oldx)
                lo_x = np.interp(newg, pos_p, blo)
                hi_x = np.interp(newg, pos_p, bhi)
                toolow = newx < lo_x
                toohigh = newx > hi_x
                if extrap == "constant":
                    clo, chi = _first_last_nonnull(oldy)
                    lo_y = np.interp(newg, pos_p, clo)
                    hi_y = np.interp(newg, pos_p, chi)
            if extrap == "constant":
                res[toolow] = lo_y[toolow]
                res[toohigh] = hi_y[toohigh]
            else:
                res[toolow] = np.nan
                res[toohigh] = np.nan
    return out.reshape(batch + (T,))


def _griddata_interpolator(px, pg, values, method: str):
    """The interpolator ``scipy.interpolate.griddata`` would build for the
    scattered 2-D points (px, pg) — constructed once so repeated evaluations
    share the Delaunay triangulation."""
    import scipy.interpolate as si

    pts = np.column_stack([px.ravel(), pg.ravel()])
    if method == "nearest":
        f = si.NearestNDInterpolator(pts, values.ravel())
    elif method == "linear":
        f = si.LinearNDInterpolator(pts, values.ravel(), fill_value=np.nan)
    elif method == "cubic":
        f = si.CloughTocher2DInterpolator(pts, values.ravel(), fill_value=np.nan)
    else:  # pragma: no cover - caller validates
        raise ValueError(f"Unknown griddata method {method!r}")
    return lambda qx, qg: f(np.column_stack([qx.ravel(), qg.ravel()])).ravel()
