"""Jitted compute cores for the adjustment schemes.

Each core is a pure function over dense device arrays (time last) plus static
group-index arrays — the device equivalent of the reference's decorated
compute functions (``_adjustment.py``).  Cores are jitted once per (scheme, kind,
interp, extrapolation, shapes) signature; everything inside fuses under XLA.

Grouped lookups and broadcasts use *bracket partitions*
(``GroupIndexes.bracket_partitions``): static -1-padded partitions of the
time axis by bracketing padded group, so every device-side step is either a
vectorized per-partition table evaluation or a gather from a long source
axis — never an element-wise gather from a small table.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from ..ops.correction import apply_correction, get_correction
from ..ops.interp import interp_grouped_partitioned
from ..ops.segment import grouped_rank

__all__ = [
    "broadcast_groups_core",
    "eqm_train_adjust_windowed",
    "eqm_train_core",
    "qdm_adjust_core",
    "qm_adjust_core",
    "qdm_train_adjust_core",
    "scaling_adjust_core",
    "scaling_train_core",
]


def _pad_cyclic_factors(f):
    """[..., G] -> [..., G+2] with one wrapped group on each side."""
    if f.shape[-1] > 1:
        return jnp.concatenate([f[..., -1:], f, f[..., :1]], axis=-1)
    return f


def broadcast_groups_core(f, brackets):
    """Map per-group factors [..., G] onto the time axis [..., T] using
    bracket partitions (reference ``u.broadcast``, utils.py:180-248).

    The factor grid is tiled over the partition columns so the final step is
    a (row, col) gather from a long source.
    """
    part0, g0, slot0, part1, g1, slot1, w = brackets
    f = jnp.asarray(f)
    # partitions index padded groups (G+2) unless G == 1
    f_p = _pad_cyclic_factors(f) if part0.shape[0] != f.shape[-1] else f

    regular0 = getattr(brackets, "regular0", None)
    if regular0 is not None and part1 is None and part0.shape[0] == f_p.shape[-1]:
        # regular layout (Brackets.regular0): factor of timestep t is
        # f_p[1 + (t % P)] — a broadcast + reshape, no gathers
        P = int(regular0)
        Y = part0.shape[-1]
        lead = f_p.shape[:-1]
        grid = jnp.broadcast_to(f_p[..., None, 1 : P + 1], lead + (Y, P))
        return grid.reshape(lead + (Y * P,))

    def eval_part(part, grp, slot):
        Lp = part.shape[-1]
        grid = jnp.broadcast_to(f_p[..., None], f_p.shape + (Lp,))
        return grid[..., jnp.asarray(grp), jnp.asarray(slot)]

    v0 = eval_part(jnp.asarray(part0), g0, slot0)
    if part1 is None:
        return v0
    v1 = eval_part(jnp.asarray(part1), g1, slot1)
    ww = jnp.asarray(w, dtype=v0.dtype)
    return (1 - ww) * v0 + ww * v1


@partial(jax.jit, static_argnames=("kind",))
def eqm_train_core(refg, histg, quantiles, *, kind: str):
    """EQM train on one batch: per-group quantiles of ref & hist, correction
    factors (reference ``_adjustment.py:193-286``).

    refg/histg: [..., G, L] gathered group matrices (NaN padded);
    quantiles: [nq].  Returns (af, hist_q): [..., G, nq].
    """
    from ..ops.quantile import nan_quantile

    ref_q = nan_quantile(refg, quantiles, axis=-1)
    hist_q = nan_quantile(histg, quantiles, axis=-1)
    af = get_correction(hist_q, ref_q, kind)
    return af, hist_q


@partial(jax.jit, static_argnames=("kind", "interp", "extrapolation", "tables_compact"))
def qm_adjust_core(
    sim, hist_q, af, brackets, *, kind: str, interp: str, extrapolation: str,
    tables_compact: bool = False,
):
    """QM adjust (reference ``_adjustment.py:594-676``): look up each sim value
    in the per-group (hist_q -> af) table, apply the correction.

    ``tables_compact``: the tables are quantile-trained (ascending, NaN rows
    whole) — skip the argsort NaN compaction (bit-identical there; the sort
    + small-axis gathers it avoids would run per step inside fused
    programs)."""
    from ..ops.interp import interp1d_table

    if hist_q.shape[-2] == 1:
        af_t = interp1d_table(sim, hist_q[..., 0, :], af[..., 0, :], interp, extrapolation)
    else:
        part0, g0, slot0, part1, g1, slot1, w = brackets
        af_t = interp_grouped_partitioned(
            sim, hist_q, af, part0, g0, slot0, part1, g1, slot1, w, interp, extrapolation,
            regular0=getattr(brackets, "regular0", None),
            tables_compact=tables_compact,
        )
    return apply_correction(sim, af_t, kind)


@partial(jax.jit, static_argnames=("kind", "interp", "extrapolation"))
def qdm_adjust_core(
    sim,
    af,
    quantiles,
    brackets,
    gather_sim,
    group_idx,
    scatter_slot,
    *,
    kind: str,
    interp: str,
    extrapolation: str,
):
    """QDM adjust (reference ``_adjustment.py:783-886``): per-group pct rank of
    sim, then af looked up at (rank, group) and applied.

    Returns (scen, sim_q)."""
    from ..ops.interp import interp1d_table

    sim_q = grouped_rank(sim, gather_sim, group_idx, scatter_slot, pct=True)
    G = af.shape[-2]
    nq = af.shape[-1]
    qtab = jnp.broadcast_to(quantiles, af.shape[:-2] + (G, nq))
    if G == 1:
        af_t = interp1d_table(sim_q, qtab[..., 0, :], af[..., 0, :], interp, extrapolation)
    else:
        part0, g0, slot0, part1, g1, slot1, w = brackets
        # xq is the ascending quantile nodes and af is train output (whole-row
        # NaNs only): the argsort compaction is the identity — skip it
        af_t = interp_grouped_partitioned(
            sim_q, qtab, af, part0, g0, slot0, part1, g1, slot1, w, interp, extrapolation,
            regular0=getattr(brackets, "regular0", None),
            tables_compact=True,
        )
    return apply_correction(sim, af_t, kind), sim_q


@partial(jax.jit, static_argnames=("kind",))
def scaling_train_core(ref, hist, gather_ref, gather_hist, *, kind: str):
    """Scaling train (reference ``_adjustment.py:938-958``): group means."""
    mu_ref = jnp.nanmean(_gather(ref, gather_ref), axis=-1)
    mu_hist = jnp.nanmean(_gather(hist, gather_hist), axis=-1)
    return get_correction(mu_hist, mu_ref, kind)


@partial(jax.jit, static_argnames=("kind",))
def scaling_adjust_core(sim, af, brackets, *, kind: str):
    """Scaling adjust (reference ``_adjustment.py:961-974``)."""
    af_t = broadcast_groups_core(af, brackets)
    return apply_correction(sim, af_t, kind)


def _gather(x, gather_idx):
    gi = jnp.asarray(gather_idx)
    vals = x[..., jnp.clip(gi, 0, x.shape[-1] - 1)]
    return jnp.where(gi < 0, jnp.nan, vals)


@partial(jax.jit, static_argnames=("kind", "interp", "extrapolation"))
def qdm_train_adjust_core(
    ref,
    hist,
    sim,
    gather_idx,
    group_idx,
    scatter_slot,
    brackets,
    quantiles,
    *,
    kind: str,
    interp: str,
    extrapolation: str,
):
    """Fully fused QDM train + adjust — the flagship single-step kernel.

    One jit: grouped quantile estimation of ref & hist (gather->sort->lerp),
    adjustment factors, per-group pct ranks of sim, factor lookup, correction.
    Purely batch-parallel over leading dims -> shards over a site mesh with
    zero collectives.
    """
    from ..ops.quantile import nan_quantile

    refg = _gather(ref, gather_idx)
    histg = _gather(hist, gather_idx)
    ref_q = nan_quantile(refg, quantiles, axis=-1)
    hist_q = nan_quantile(histg, quantiles, axis=-1)
    af = get_correction(hist_q, ref_q, kind)
    scen, _ = qdm_adjust_core.__wrapped__(
        sim,
        af,
        quantiles,
        brackets,
        gather_idx,
        group_idx,
        scatter_slot,
        kind=kind,
        interp=interp,
        extrapolation=extrapolation,
    )
    return scen

@partial(jax.jit, static_argnames=("kind",))
def eqm_train_from_raw(ref, hist, gather_idx, quantiles, *, kind: str):
    """EQM train straight from [..., T] arrays with memory-bounded chunking
    over groups (no full [..., G, L] gather materialized) — the path used
    when no frequency adaptation is requested."""
    from ..ops.quantile import grouped_nan_quantile

    ref_q = grouped_nan_quantile(ref, gather_idx, quantiles)
    hist_q = grouped_nan_quantile(hist, gather_idx, quantiles)
    return get_correction(hist_q, ref_q, kind), hist_q


@partial(jax.jit, static_argnames=("kind",))
def dqm_train_from_raw(ref, hist, gather_idx, quantiles, *, kind: str):
    """DQM train (normalized quantiles + scaling factor) with memory-bounded
    chunking over groups, straight from [..., T] arrays."""
    from ..ops.correction import invert
    from ..ops.quantile import nan_quantile

    G, L = gather_idx.shape
    batch = 1
    for d in ref.shape[:-1]:
        batch *= d
    chunk = max(1, min(G, (1 << 28) // max(batch * L, 1)))

    def one(gidx):
        refg = _gather(ref, gidx)
        histg = _gather(hist, gidx)
        mu_ref = jnp.nanmean(refg, axis=-1)
        mu_hist = jnp.nanmean(histg, axis=-1)
        refn = apply_correction(refg, invert(mu_ref[..., None], kind), kind)
        histn = apply_correction(histg, invert(mu_hist[..., None], kind), kind)
        ref_q = nan_quantile(refn, quantiles, axis=-1)
        hist_q = nan_quantile(histn, quantiles, axis=-1)
        return get_correction(hist_q, ref_q, kind), hist_q, mu_ref, mu_hist

    if chunk >= G:
        af, hist_q, mu_ref, mu_hist = one(gather_idx)
        return af, hist_q, get_correction(mu_hist, mu_ref, kind)

    n_chunks = -(-G // chunk)
    pad = n_chunks * chunk - G
    gi = jnp.concatenate([gather_idx, jnp.full((pad, L), -1, gather_idx.dtype)], axis=0) if pad else gather_idx
    af, hist_q, mu_ref, mu_hist = jax.lax.map(one, gi.reshape(n_chunks, chunk, L))

    def combine(a, has_nq):
        # [n_chunks, ..., C(, nq)] -> [..., G(, nq)]
        move_to = a.ndim - (3 if has_nq else 2)
        a = jnp.moveaxis(a, 0, move_to)
        tail = (a.shape[-1],) if has_nq else ()
        a = a.reshape(a.shape[:move_to] + (n_chunks * chunk,) + tail)
        return a[..., :G, :] if has_nq else a[..., :G]

    af = combine(af, True)
    hist_q = combine(hist_q, True)
    mu_ref = combine(mu_ref, False)
    mu_hist = combine(mu_hist, False)
    return af, hist_q, get_correction(mu_hist, mu_ref, kind)


def _windowed_group_mean(x, plan):
    """Per-group NaN-mean for windowed doy/5D groupings via sliding sums of
    the window-1 per-group sums (no gather amplification); edge groups exact."""
    x = jnp.asarray(x)
    gi = jnp.asarray(plan.w1_gather)  # EXTENDED rows: [G + 2*half, Ymax]
    vals = jnp.where(gi < 0, jnp.nan, x[..., jnp.clip(gi, 0, x.shape[-1] - 1)])
    sums = jnp.nansum(vals, axis=-1)
    cnts = jnp.sum(~jnp.isnan(vals), axis=-1)
    half, window = plan.half, plan.window
    G = gi.shape[0] - 2 * half

    def slide(a):
        # group g's window is extended rows [g, g+window)
        ap = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, max(window - 2 * half, 0))])
        cs = jnp.cumsum(ap, axis=-1)
        cs = jnp.pad(cs, [(0, 0)] * (cs.ndim - 1) + [(1, 0)])
        idx = jnp.arange(G)
        return cs[..., idx + window] - cs[..., idx]

    mu = slide(sums) / jnp.maximum(slide(cnts), 1)
    mu = jnp.where(slide(cnts) == 0, jnp.nan, mu)
    if plan.edge_gather.shape[0]:
        ge = jnp.asarray(plan.edge_gather)
        xe = jnp.where(ge < 0, jnp.nan, x[..., jnp.clip(ge, 0, x.shape[-1] - 1)])
        mu = mu.at[..., jnp.asarray(plan.edge_ids)].set(jnp.nanmean(xe, axis=-1))
    return mu


@partial(
    jax.jit,
    static_argnames=(
        "half", "window", "ypad", "wpad", "dp", "kind",
        "counts", "q_static", "edge_tuple", "regular", "extract_mode",
    ),
)
def _eqm_train_windowed_fused(
    ref, hist, w1, eid, eg, q, *,
    half, window, ypad, wpad, dp, kind, counts, q_static, edge_tuple,
    regular=None, extract_mode="strip",
):
    """Fully-fused EQM windowed train on the merge engine: stack + grouped
    quantiles + factors in ONE program (one dispatch, no eager
    intermediates)."""
    from ..ops.quantile import _windowed_group_quantile_core

    both = jnp.stack([ref, hist], axis=0)
    q2 = _windowed_group_quantile_core.__wrapped__(
        both, w1, eid, eg, q,
        half=half, window=window, ypad=ypad, wpad=wpad, dp=dp,
        alpha=1.0, beta=1.0,
        counts=counts, q_static=q_static, edge_tuple=edge_tuple, regular=regular,
        extract_mode=extract_mode,
    )
    # materialize the extracted tables once: the ref/hist slices below are
    # separate consumers and XLA otherwise re-runs the extraction gather per
    # consumer (same pessimization as the train->adjust boundary; identity)
    q2 = jax.lax.optimization_barrier(q2)
    return get_correction(q2[1], q2[0], kind), q2[1]


@partial(jax.jit, static_argnames=("G", "kind", "mode"))
def _eqm_train_windowed_sel(ref, hist, lab, q, *, G, kind, mode):
    """Fused EQM windowed train on the counting-selection backend: stack +
    selection quantiles + factors in ONE NaN-exact program — no speculative
    static/dynamic pair, no finiteness probe (ops/selquant.py)."""
    from ..ops.selquant import selection_windowed_quantile_core

    both = jnp.stack([ref, hist], axis=0)
    q2 = selection_windowed_quantile_core(both, lab, q, G=G, mode=mode)
    q2 = jax.lax.optimization_barrier(q2)  # one extraction, two consumers
    return get_correction(q2[1], q2[0], kind), q2[1]


@partial(
    jax.jit,
    static_argnames=("G", "kind", "mode", "interp", "extrapolation"),
)
def _eqm_train_adjust_windowed_sel(
    ref, hist, sim, lab, q, brackets, *, G, kind, mode, interp, extrapolation
):
    """Selection-backend analogue of ``_eqm_train_adjust_windowed_fused``."""
    af, hist_q = _eqm_train_windowed_sel.__wrapped__(ref, hist, lab, q, G=G, kind=kind, mode=mode)
    # materialize train tables before the adjust consumers (see
    # _eqm_train_adjust_windowed_fused; identity, bit-exact)
    af, hist_q = jax.lax.optimization_barrier((af, hist_q))
    scen = qm_adjust_core.__wrapped__(
        sim, hist_q, af, brackets, kind=kind, interp=interp, extrapolation=extrapolation
    )
    return scen, af, hist_q


def _sel_fused_mode(plan, ref, hist, quantiles):
    """The selection mode of the fused train(+adjust) program, or None when
    it does not apply: the platform's engine is a selection engine, ref and
    hist pair up, and one group chunk of the stage-3 block gather of the
    stacked batch ([2B, g_chunk, K, 2*Wb] at the defaults 64 and 64) stays
    within 2**31 elements."""
    from ..ops.quantile import windowed_engine

    mode = windowed_engine(plan, quantiles)
    if mode == "merge" or ref.shape != hist.shape or ref.dtype != hist.dtype:
        return None
    B2 = 2 * int(np.prod(ref.shape[:-1], dtype=np.int64))
    Gc = min(64, int(plan.fast_mask.shape[0]))
    K = 2 * int(np.shape(quantiles)[0]) + 1
    return mode if B2 * Gc * K * 128 <= (1 << 31) else None


@partial(
    jax.jit,
    static_argnames=(
        "half", "window", "ypad", "wpad", "dp", "kind",
        "counts", "q_static", "edge_tuple", "regular", "interp", "extrapolation",
        "extract_mode",
    ),
)
def _eqm_train_adjust_windowed_fused(
    ref, hist, sim, w1, eid, eg, q, brackets, *,
    half, window, ypad, wpad, dp, kind, counts, q_static, edge_tuple,
    regular=None, interp="linear", extrapolation="constant",
    extract_mode="strip",
):
    """Windowed EQM train + adjust in ONE program on the merge engine: stack
    + grouped quantiles + factors + grouped table lookup + correction.  One
    dispatch per step, and XLA can overlap the adjust-side slab transpose
    with the train-side merge when both live in the same program."""
    af, hist_q = _eqm_train_windowed_fused.__wrapped__(
        ref, hist, w1, eid, eg, q,
        half=half, window=window, ypad=ypad, wpad=wpad, dp=dp,
        kind=kind, counts=counts, q_static=q_static,
        edge_tuple=edge_tuple, regular=regular, extract_mode=extract_mode,
    )
    # Materialize the train tables before the adjust side consumes them:
    # without the barrier XLA may fuse the extraction gather into the
    # adjust's per-bracket consumers and recompute it per partition.  The
    # barrier is identity (bit-exact).
    af, hist_q = jax.lax.optimization_barrier((af, hist_q))
    scen = qm_adjust_core.__wrapped__(
        sim, hist_q, af, brackets, kind=kind, interp=interp, extrapolation=extrapolation,
        tables_compact=True,
    )
    return scen, af, hist_q


def eqm_train_adjust_windowed(
    ref, hist, sim, plan, quantiles, brackets, *,
    kind: str, interp: str = "linear", extrapolation: str = "constant",
    assume_finite: bool | None = None,
):
    """One-dispatch windowed EQM train+adjust (the doy+window production
    pipeline); numerically identical to ``eqm_train_windowed`` followed by
    ``qm_adjust_core``.  Returns (scen, af, hist_q).

    Same speculative static dispatch as ``eqm_train_windowed``: the fused
    static-count program races the finiteness-probe fetch.  Under an outer
    ``jit``/``scan`` trace the host probe is impossible, so the call takes
    the exact (NaN-safe) extraction unless ``assume_finite=True`` pins the
    static fast path (callers that construct finite data, e.g. bench)."""
    from ..ops.quantile import (
        _PLAN_FINITE_HINT,
        _extract_mode,
        _pair_finite_probe,
        _plan_device_arrays,
        speculative_static_dispatch,
    )

    ref = jnp.asarray(ref)
    hist = jnp.asarray(hist)
    sim = jnp.asarray(sim)

    sel_mode = _sel_fused_mode(plan, ref, hist, quantiles)
    if sel_mode is not None:
        from ..ops.selquant import _plan_label_device

        return _eqm_train_adjust_windowed_sel(
            ref, hist, sim, _plan_label_device(plan),
            jnp.asarray(quantiles, dtype=ref.dtype), brackets,
            G=int(plan.fast_mask.shape[0]), kind=kind, mode=sel_mode,
            interp=interp, extrapolation=extrapolation,
        )

    pairable = (
        ref.shape == hist.shape
        and ref.dtype == hist.dtype
        and np.ndim(quantiles) == 1
        and plan.nv_host is not None
        and 2 * int(np.prod(ref.shape[:-1])) * plan.w1_gather.shape[0] * plan.wpad * plan.ypad
        <= (1 << 31)
    )
    if not pairable:
        af, hist_q = eqm_train_windowed(ref, hist, plan, quantiles, kind=kind)
        scen = qm_adjust_core(
            sim, hist_q, af, brackets, kind=kind, interp=interp, extrapolation=extrapolation,
            tables_compact=True,
        )
        return scen, af, hist_q

    w1, eid, eg = _plan_device_arrays(plan)
    qdev = jnp.asarray(quantiles, dtype=ref.dtype)
    extract_mode = _extract_mode()

    def call(static: bool):
        if static:
            counts = tuple(int(c) for c in plan.nv_host)
            q_static = tuple(float(v) for v in np.asarray(quantiles, np.float64))
            edge_tuple = tuple(int(e) for e in plan.edge_ids)
        else:
            counts = q_static = None
            edge_tuple = ()
        return _eqm_train_adjust_windowed_fused(
            ref, hist, sim, w1, eid, eg, qdev, brackets,
            half=plan.half, window=plan.window, ypad=plan.ypad, wpad=plan.wpad,
            dp=plan.dp, kind=kind,
            counts=counts, q_static=q_static, edge_tuple=edge_tuple,
            regular=plan.regular_period, interp=interp, extrapolation=extrapolation,
            extract_mode=extract_mode,
        )

    if assume_finite is True:
        _PLAN_FINITE_HINT[plan] = True
        return call(static=True)
    traced = isinstance(ref, jax.core.Tracer) or isinstance(hist, jax.core.Tracer)
    if traced or assume_finite is False:
        # no host probe possible (or caller pinned the NaN-safe path)
        return call(static=False)

    probe_dev = _pair_finite_probe(ref, hist)
    return speculative_static_dispatch(plan, lambda: bool(probe_dev), lambda static: call(static))


def eqm_train_windowed(ref, hist, plan, quantiles, *, kind: str):
    """EQM train on a windowed doy/5D grouping via the shared-sort merge path
    (``ops.quantile.windowed_group_quantile``) — numerically identical to
    ``eqm_train_from_raw`` on the same grouping, ~1/window of the sort work.

    Matching-shape ref/hist ride one fused program (stack + quantiles +
    factors); the finiteness probe is dispatched alongside it (speculative,
    as in ``windowed_group_quantile``)."""
    from ..ops.quantile import (
        _extract_mode,
        _pair_finite_probe,
        _plan_device_arrays,
        speculative_static_dispatch,
        windowed_group_quantile,
    )

    ref = jnp.asarray(ref)
    hist = jnp.asarray(hist)

    sel_mode = _sel_fused_mode(plan, ref, hist, quantiles)
    if sel_mode is not None:
        from ..ops.selquant import _plan_label_device

        return _eqm_train_windowed_sel(
            ref, hist, _plan_label_device(plan),
            jnp.asarray(quantiles, dtype=ref.dtype),
            G=int(plan.fast_mask.shape[0]), kind=kind, mode=sel_mode,
        )

    pairable = (
        ref.shape == hist.shape
        and ref.dtype == hist.dtype
        and np.ndim(quantiles) == 1
        and plan.nv_host is not None
        # the fused program materializes the stacked merge intermediate:
        # bound it like windowed_group_quantile's chunker (~4 GB)
        and 2 * int(np.prod(ref.shape[:-1])) * plan.w1_gather.shape[0] * plan.wpad * plan.ypad
        <= (1 << 31)
    )
    if not pairable:
        if ref.shape == hist.shape and ref.dtype == hist.dtype:
            both = jnp.concatenate([ref[None], hist[None]], axis=0)
            q2 = windowed_group_quantile(both, plan, quantiles)
            ref_q, hist_q = q2[0], q2[1]
        else:
            ref_q = windowed_group_quantile(ref, plan, quantiles)
            hist_q = windowed_group_quantile(hist, plan, quantiles)
        return get_correction(hist_q, ref_q, kind), hist_q

    w1, eid, eg = _plan_device_arrays(plan)
    qdev = jnp.asarray(quantiles, dtype=ref.dtype)
    extract_mode = _extract_mode()

    def call(static: bool):
        if static:
            counts = tuple(int(c) for c in plan.nv_host)
            q_static = tuple(float(v) for v in np.asarray(quantiles, np.float64))
            edge_tuple = tuple(int(e) for e in plan.edge_ids)
        else:
            counts = q_static = None
            edge_tuple = ()
        return _eqm_train_windowed_fused(
            ref, hist, w1, eid, eg, qdev,
            half=plan.half, window=plan.window, ypad=plan.ypad, wpad=plan.wpad,
            dp=plan.dp, kind=kind,
            counts=counts, q_static=q_static, edge_tuple=edge_tuple,
            regular=plan.regular_period, extract_mode=extract_mode,
        )

    if isinstance(ref, jax.core.Tracer) or isinstance(hist, jax.core.Tracer):
        return call(static=False)  # under an outer trace: no host probe
    probe_dev = _pair_finite_probe(ref, hist)
    return speculative_static_dispatch(plan, lambda: bool(probe_dev), lambda static: call(static))


def dqm_train_windowed(ref, hist, plan, quantiles, *, kind: str):
    """DQM train via the merge path.  Group-mean normalization commutes with
    quantiles (an additive shift / positive scale is order-preserving; a
    negative multiplicative mean flips the order, handled by flipping the
    quantile axis), so the normalized quantiles are derived from raw-value
    quantiles without re-sorting normalized copies."""
    from ..ops.correction import invert
    from ..ops.quantile import windowed_group_quantile

    ref = jnp.asarray(ref)
    hist = jnp.asarray(hist)
    if ref.shape == hist.shape and ref.dtype == hist.dtype:
        q2 = windowed_group_quantile(jnp.concatenate([ref[None], hist[None]], axis=0), plan, quantiles)
        ref_q_raw, hist_q_raw = q2[0], q2[1]
    else:
        ref_q_raw = windowed_group_quantile(ref, plan, quantiles)
        hist_q_raw = windowed_group_quantile(hist, plan, quantiles)
    mu_ref = _windowed_group_mean(ref, plan)
    mu_hist = _windowed_group_mean(hist, plan)

    def normalize(q_raw, mu):
        if kind == "*":
            q_raw = jnp.where(mu[..., None] < 0, jnp.flip(q_raw, axis=-1), q_raw)
        return apply_correction(q_raw, invert(mu[..., None], kind), kind)

    ref_q = normalize(ref_q_raw, mu_ref)
    hist_q = normalize(hist_q_raw, mu_hist)
    af = get_correction(hist_q, ref_q, kind)
    return af, hist_q, get_correction(mu_hist, mu_ref, kind)
