"""Selection-based windowed grouped quantiles (no merge, no per-group sort).

The windowed grouped type-7 quantile (reference ``base.py:261-265`` rolling
construct + ``nbutils.py:113-148`` quantile) needs only ~2*nq+1 ORDER
STATISTICS per (site, group) — not the fully sorted ``window*years``-element
row the merge cascade produces.  This module computes those order statistics
exactly by counting, in three stages:

1. ONE full sort of each site's series, carrying a packed per-element
   group-interval label through the sort (``lax.sort`` payload — no gathers).
   Windowed membership of element ``t`` is a cyclic INTERVAL of groups
   ``[start_t, start_t + len_t)`` whenever the grouping is a rolling window
   over contiguous time (checked host-side from the exact gather matrix;
   see :func:`interval_membership`).
2. Per-block windowed member counts: the sorted order is cut into blocks of
   ``Wb`` elements; each block's per-group member count is an elementwise
   interval test reduced over the block (elementwise work, no gathers), and a
   cumulative sum over blocks yields the exact valid count — and so the
   needed type-7 ranks — per (site, group).
3. Extraction, in one of two exact, bit-identical forms: ``"gather"``
   locates each needed rank's block by a scan over the block counts,
   gathers that one block and picks the member in it; ``"emit"`` (DENSE
   EMISSION) re-scans the sorted stream chunk by chunk, every element
   computing its own member-rank per group and testing it against the
   ≤``slots`` needed ranks that fall inside its chunk, with no random
   access at all.  The rare slot-overflow case of the emission (extreme
   value concentration) reroutes in-program to the exact full-width
   window via ``lax.cond``.

Stage 2's counts are exact for NaN data too (NaNs sort last and are excluded
from membership), so the ranks are computed dynamically from the true valid
counts — one program covers the finite fast case and the NaN case, with no
speculative static/dynamic dispatch.

Bit-parity: the selected left/right elements are the same floats the sorted
row would hold, and the virtual-index/gamma/lerp arithmetic below mirrors
``ops.quantile._quantile_on_sorted`` op for op, so results are bit-identical
to the jitted re-sort oracle (``grouped_nan_quantile`` under ``jax.jit``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "interval_membership",
    "selection_ok",
    "selection_windowed_quantile",
]


def selection_ok(plan, quantiles) -> bool:
    """True when the counting-selection backend can serve this call: the
    plan has interval membership, the quantiles are one vector, and the
    ``selection_backend`` option (``XSDBA_SELECTION_BACKEND`` env var) has
    not turned it off."""
    from ..utils.options import get_option

    return bool(
        get_option("selection_backend")
        and plan is not None
        and plan.sel_labels is not None
        and np.ndim(quantiles) == 1
    )


# labels are packed as start*_PACK + length; _PACK must exceed any group count
_PACK = 1024
# bias added before bitcasting packed int32 labels to f32 for the block
# gather: raw packed values (< 2**19) are DENORMAL f32 bit patterns, which a
# copy that flushes denormals to zero would lose — biased into [2**23, 2**24)
# every label is a normal float and survives the ride bit-exactly
_LABEL_BIAS = 1 << 23


def interval_membership(gather_idx, n_groups: int, T: int):
    """Host-side inversion of a [G, L] gather matrix into per-element cyclic
    group intervals, or None when membership is not interval-shaped.

    Returns ``(start, length)`` int32 arrays of shape [T]: element ``t`` is a
    member of groups ``{(start[t] + j) % G : j < length[t]}``.  Valid only
    when every element's member-group set is a single cyclic interval and the
    gather matrix holds no duplicate entries (both checked).  Rolling doy/5D
    windows on regular calendars pass; leap/standard calendars (the doy
    sequence skips a value in most years) fail and keep the merge path.
    """
    gi = np.asarray(gather_idx)
    G = int(n_groups)
    mem = np.zeros((T, G), dtype=bool)
    n_entries = 0
    for g in range(G):
        m = gi[g]
        m = m[m >= 0]
        n_entries += len(m)
        mem[m, g] = True
    if n_entries != int(mem.sum()):  # duplicate entries: counts would be off
        return None
    cnt = mem.sum(axis=1)
    starts01 = mem & ~np.roll(mem, 1, axis=1)
    ns = starts01.sum(axis=1)
    full = cnt == G
    if not np.all((ns == 1) | (cnt == 0) | full):
        return None
    start = np.argmax(starts01, axis=1).astype(np.int32)
    start[full | (cnt == 0)] = 0
    if G >= _PACK or T >= (1 << 22):  # packed label must fit int32 exactly
        return None
    return start, cnt.astype(np.int32)


def _lerp(left, right, gamma):
    # identical to ops.quantile._lerp (nbutils.py:77-106 symmetric form)
    diff = right - left
    out = left + diff * gamma
    return jnp.where(gamma >= 0.5, right - diff * (1 - gamma), out)


def selection_windowed_quantile_core(
    x,
    labels,
    quantiles,
    *,
    G: int,
    Wb: int = 64,
    nb_chunk: int = 128,
    slots: int = 32,
    g_chunk: int = 64,
    mode: str = "gather",
    alpha: float = 1.0,
    beta: float = 1.0,
):
    """Traceable core: ``x`` [..., T] values, ``labels`` [T] packed
    ``start*_PACK + length`` int32, ``quantiles`` [nq].  Returns [..., G, nq].

    ``mode`` picks the extraction engine over the shared sort + counting
    stages: ``"gather"`` (per-query block row-gather + in-block pick) or
    ``"emit"`` (dense emission, below).  Both are exact and bit-identical.

    ``Wb`` is the sorted-order block width, ``nb_chunk`` the number of blocks
    each membership/emission chunk processes, ``slots`` the per-chunk
    needed-rank window width of the dense emission — all pure performance
    knobs, asserted semantics-free in tests (``slots`` overflow reroutes to
    the exact full-width window in-program).
    """
    x = jnp.asarray(x)
    lead = x.shape[:-1]
    T = x.shape[-1]
    B = 1
    for d in lead:
        B *= d
    xb = x.reshape(B, T)
    q = jnp.asarray(quantiles, dtype=x.dtype)
    nq = q.shape[0]
    # The emit engine's chunk windows require the per-group rank lists to be
    # ascending over the K axis (true iff q is ascending, since the type-7
    # virtual index is monotone in q).  Sort q here and un-permute the output
    # columns at the end — bit-exact, each quantile is computed independently.
    q_order = jnp.argsort(q)
    q_inv = jnp.argsort(q_order)
    q = q[q_order]

    # --- stage 1: one sort per site, labels ride as payload (NaNs last) ---
    lab = jnp.broadcast_to(jnp.asarray(labels, jnp.int32)[None, :], (B, T))
    svals, slab = jax.lax.sort((xb, lab), num_keys=1)

    nbo = -(-T // (Wb * nb_chunk))
    nb = nbo * nb_chunk
    Tp = nb * Wb
    if Tp > T:
        svals = jnp.pad(svals, ((0, 0), (0, Tp - T)), constant_values=jnp.nan)
        slab = jnp.pad(slab, ((0, 0), (0, Tp - T)))  # length 0 -> never member

    g_iota = jnp.arange(G, dtype=jnp.int32)

    # --- stage 2a: per-block member counts, chunked over blocks ---
    def _chunk_hwin(args):
        sv, sl = args  # [B, nb_chunk*Wb]
        a = sl // _PACK
        ln = sl % _PACK
        d0 = g_iota[None, None, :] - a[:, :, None]
        dd = d0 + jnp.where(d0 < 0, G, 0)
        member = (dd < ln[:, :, None]) & ~jnp.isnan(sv)[:, :, None]
        return jnp.sum(
            member.reshape(B, nb_chunk, Wb, G), axis=2, dtype=jnp.int32
        )  # [B, nb_chunk, G]

    sv3 = jnp.moveaxis(svals.reshape(B, nbo, nb_chunk * Wb), 1, 0)
    sl3 = jnp.moveaxis(slab.reshape(B, nbo, nb_chunk * Wb), 1, 0)
    hwin = jax.lax.map(_chunk_hwin, (sv3, sl3))          # [nbo, B, nb_chunk, G]
    hwin = jnp.moveaxis(hwin, 0, 1).reshape(B, nb, G)
    C = jnp.cumsum(hwin, axis=1)                         # inclusive block counts
    n = C[:, -1, :]                                      # [B, G] valid counts

    # --- target ranks: mirrors _quantile_on_sorted's virtual-index math ---
    v = n[..., None].astype(x.dtype)                     # [B, G, 1]
    vi = v * q + (alpha + q * (1 - alpha - beta)) - 1    # [B, G, nq]
    prev = jnp.floor(vi)
    above = vi >= v - 1
    below = vi < 0
    gamma = (vi - prev).astype(x.dtype)
    pi = prev.astype(jnp.int32)
    nmax = jnp.maximum(n, 1)[..., None]
    r_left = jnp.where(above, nmax, jnp.where(below, 1, pi + 1))
    r_right = jnp.where(above, nmax, jnp.where(below, 1, pi + 2))

    if mode == "gather":
        # K = 2*nq + 1 rank queries; the last column selects the max valid
        # value (rank n) used by the NaN-range clip (nbutils.py:144-147)
        r = jnp.concatenate([r_left, r_right, nmax], axis=-1)  # [B, G, K]
        K = 2 * nq + 1
        # --- stage 2b: containing block + local rank, scanned over block chunks ---
        C3 = jnp.moveaxis(C.reshape(B, nbo, nb_chunk, G), 1, 0)  # [nbo, B, nc, G]

        def _search_body(carry, Cc):
            bacc, cpacc = carry
            lt = Cc[:, :, :, None] < r[:, None, :, :]        # [B, nc, G, K]
            bacc = bacc + jnp.sum(lt, axis=1, dtype=jnp.int32)
            cpacc = jnp.maximum(cpacc, jnp.max(jnp.where(lt, Cc[:, :, :, None], 0), axis=1))
            return (bacc, cpacc), None

        z = jnp.zeros((B, G, K), jnp.int32)
        (bstar, cprev), _ = jax.lax.scan(_search_body, (z, z), C3)
        m = r - cprev                                        # local member rank
        bstar = jnp.minimum(bstar, nb - 1)                   # n==0 rows: clamp

        # --- stage 3: gather ONE block per query, pick the m-th member ---
        # chunked over groups: the full gather output [B, G, K, 2*Wb] is
        # gigabytes at production batch; per-chunk it is bounded
        if svals.dtype == jnp.float32:
            # labels ride the value gather bitcast to f32 (one row-gather of
            # 2*Wb instead of two of Wb); the bias keeps every pattern normal
            lab_f = jax.lax.bitcast_convert_type(slab + _LABEL_BIAS, jnp.float32)
            blk = jnp.concatenate(
                [svals.reshape(B, nb, Wb), lab_f.reshape(B, nb, Wb)], axis=-1
            )  # [B, nb, 2*Wb]
        else:
            blk = None

        Gc = min(g_chunk, G)
        ngc = -(-G // Gc)
        Gp = ngc * Gc
        if Gp > G:
            padq = [(0, 0), (0, Gp - G), (0, 0)]
            bstar_p = jnp.pad(bstar, padq)
            m_p = jnp.pad(m, padq)
            g_pad = jnp.pad(g_iota, (0, Gp - G))
        else:
            bstar_p, m_p, g_pad = bstar, m, g_iota

        def _chunk_select(args):
            bs_c, m_c, g_c = args                      # [B, Gc, K], [B, Gc, K], [Gc]
            idx = bs_c.reshape(B, Gc * K, 1)
            if blk is not None:
                got = jnp.take_along_axis(blk, idx, axis=1).reshape(B, Gc, K, 2 * Wb)
                vals_w = got[..., :Wb]
                lab_w = jax.lax.bitcast_convert_type(got[..., Wb:], jnp.int32) - _LABEL_BIAS
            else:
                vals_w = jnp.take_along_axis(svals.reshape(B, nb, Wb), idx, axis=1)
                vals_w = vals_w.reshape(B, Gc, K, Wb)
                lab_w = jnp.take_along_axis(slab.reshape(B, nb, Wb), idx, axis=1)
                lab_w = lab_w.reshape(B, Gc, K, Wb)
            a_w = lab_w // _PACK
            l_w = lab_w % _PACK
            gq = g_c[None, :, None, None]
            dq = gq - a_w
            dq = dq + jnp.where(dq < 0, G, 0)
            member_w = (dq < l_w) & ~jnp.isnan(vals_w)
            csum = jnp.cumsum(member_w.astype(jnp.int32), axis=-1)
            pick = member_w & (csum == m_c[..., None])
            return jnp.sum(jnp.where(pick, vals_w, 0), axis=-1)  # [B, Gc, K]

        xs = (
            jnp.moveaxis(bstar_p.reshape(B, ngc, Gc, K), 1, 0),
            jnp.moveaxis(m_p.reshape(B, ngc, Gc, K), 1, 0),
            g_pad.reshape(ngc, Gc),
        )
        val = jax.lax.map(_chunk_select, xs)                  # [ngc, B, Gc, K]
        val = jnp.moveaxis(val, 0, 1).reshape(B, Gp, K)[:, :G]

        left, right, maxv = val[..., :nq], val[..., nq : 2 * nq], val[..., 2 * nq :]
        interp = _lerp(left, right, gamma)
        out = jnp.where(jnp.isnan(interp), maxv, interp)
        out = jnp.where((n == 0)[..., None], jnp.nan, out)
        return out[..., q_inv].reshape(lead + (G, nq))

    if mode != "emit":
        raise ValueError(f"Unknown selection mode {mode!r} (emit, gather).")

    # --- stage 2b+3: DENSE EMISSION (no search, no gather).  The sorted
    # stream is re-scanned once, densely: every element computes its own
    # member-rank per group (block-cumulative count + in-chunk cumsum) and
    # tests it against the needed ranks that fall inside its chunk — a
    # ``slots``-wide window of each (sorted) rank list, located by pure
    # comparisons against the chunk-boundary counts.  Each needed rank is
    # hit by exactly one element globally, so per-chunk accumulators of
    # value*hit assemble into the full table with a tiny one-hot select.
    # A window only overflows when > slots needed ranks land in ONE chunk
    # (extreme value concentration); the in-program flag then reroutes to
    # the full-width window via lax.cond — exact always, one program.
    Cb4 = C.reshape(B, nbo, nb_chunk, G)
    Chi = Cb4[:, :, -1, :]                               # [B, nchunk, G]
    Clo = jnp.concatenate([jnp.zeros_like(Chi[:, :1]), Chi[:, :-1]], axis=1)

    def _window(rk):
        # rk [B, G, K] sorted over K: per chunk, the first needed-rank index
        # past the chunk start and the number of ranks inside the chunk
        le_lo = rk[:, None, :, :] <= Clo[:, :, :, None]  # [B, C, G, K]
        le_hi = rk[:, None, :, :] <= Chi[:, :, :, None]
        kb = jnp.sum(le_lo, axis=-1, dtype=jnp.int32)    # [B, C, G]
        cross = jnp.sum(le_hi, axis=-1, dtype=jnp.int32) - kb
        return kb, cross

    kbL, crossL = _window(r_left)
    kbR, crossR = _window(r_right)
    overflow = jnp.maximum(jnp.max(crossL), jnp.max(crossR)) > slots

    k_iota = jnp.arange(nq, dtype=jnp.int32)
    Clo3 = jnp.moveaxis(Clo, 1, 0)                       # [C, B, G]

    def _run(S: int):
        s_iota = jnp.arange(S, dtype=jnp.int32)

        def _rho(rk, kb):
            # rho[b,c,g,s] = rk[b,g,kb+s] via a one-hot over the K axis
            sel = k_iota[None, None, None, None, :] == (
                kb[:, :, :, None, None] + s_iota[None, None, None, :, None]
            )                                            # [B, C, G, S, K]
            return jnp.sum(
                jnp.where(sel, rk[:, None, :, None, :], 0), axis=-1
            )                                            # [B, C, G, S]

        rhoL = jnp.moveaxis(_rho(r_left, kbL), 1, 0)     # [C, B, G, S]
        rhoR = jnp.moveaxis(_rho(r_right, kbR), 1, 0)

        def _chunk_emit(args):
            sv, sl, rl_c, rr_c, clo_c = args             # [B,E],[B,E],[B,G,S]x2,[B,G]
            a = sl // _PACK
            ln = sl % _PACK
            d0 = g_iota[None, None, :] - a[:, :, None]
            dd = d0 + jnp.where(d0 < 0, G, 0)
            member = (dd < ln[:, :, None]) & ~jnp.isnan(sv)[:, :, None]
            csum = jnp.cumsum(member.astype(jnp.int32), axis=1)
            R = clo_c[:, None, :] + csum                 # [B, E, G] member rank
            R = jnp.where(member, R, 0)                  # rank 0 never needed
            svw = sv[:, :, None, None]
            hitL = R[..., None] == rl_c[:, None, :, :]   # [B, E, G, S]
            accL = jnp.sum(jnp.where(hitL, svw, 0), axis=1)
            hitR = R[..., None] == rr_c[:, None, :, :]
            accR = jnp.sum(jnp.where(hitR, svw, 0), axis=1)
            hitM = R == nmax[:, None, :, 0]              # rank n: the max value
            accM = jnp.sum(jnp.where(hitM, sv[:, :, None], 0), axis=1)
            return accL, accR, accM                      # [B,G,S],[B,G,S],[B,G]

        accL, accR, accM = jax.lax.map(
            _chunk_emit, (sv3, sl3, rhoL, rhoR, Clo3)
        )                                                # [C, B, G, S] x2, [C, B, G]
        valM = jnp.sum(accM, axis=0)                     # [B, G]

        def _assemble(rk, kb, acc):
            # chunk containing rank k, then (chunk, slot) one-hot select
            cc = jnp.sum(
                Clo[:, :, :, None] < rk[:, None, :, :], axis=1, dtype=jnp.int32
            ) - 1                                        # [B, G, K]
            kb_at = jnp.sum(
                jnp.where(
                    jnp.arange(nbo, dtype=jnp.int32)[None, :, None, None]
                    == cc[:, None, :, :],
                    kb[:, :, :, None],
                    0,
                ),
                axis=1,
            )                                            # [B, G, K]
            flat = cc * S + (k_iota[None, None, :] - kb_at)
            accf = jnp.moveaxis(acc, 0, 1)               # [B, C, G, S]
            accf = jnp.moveaxis(accf, 3, 2).reshape(B, nbo * S, G)
            sel = (
                jnp.arange(nbo * S, dtype=jnp.int32)[None, :, None, None]
                == flat[:, None, :, :]
            )                                            # [B, C*S, G, K]
            return jnp.sum(jnp.where(sel, accf[:, :, :, None], 0), axis=1)

        left = _assemble(r_left, kbL, accL)
        right = _assemble(r_right, kbR, accR)
        interp = _lerp(left, right, gamma)
        out = jnp.where(jnp.isnan(interp), valM[:, :, None], interp)
        return jnp.where((n == 0)[:, :, None], jnp.nan, out)

    if slots >= nq:
        out = _run(nq)                                   # full window: no overflow
    else:
        out = jax.lax.cond(overflow, lambda: _run(nq), lambda: _run(slots))
    return out[..., q_inv].reshape(lead + (G, nq))


@functools.partial(
    jax.jit,
    static_argnames=("G", "Wb", "nb_chunk", "slots", "g_chunk", "mode", "alpha", "beta"),
)
def _selection_core_jit(x, labels, quantiles, *, G, Wb, nb_chunk, slots, g_chunk, mode, alpha, beta):
    return selection_windowed_quantile_core(
        x, labels, quantiles, G=G, Wb=Wb, nb_chunk=nb_chunk, slots=slots,
        g_chunk=g_chunk, mode=mode, alpha=alpha, beta=beta,
    )


def pack_labels(start, length) -> np.ndarray:
    """Pack host interval arrays into the single int32 label the core sorts."""
    return (np.asarray(start, np.int32) * _PACK + np.asarray(length, np.int32)).astype(
        np.int32
    )


def selection_windowed_quantile(
    x,
    plan,
    quantiles,
    alpha: float = 1.0,
    beta: float = 1.0,
    Wb: int = 64,
    nb_chunk: int = 128,
    slots: int = 32,
    g_chunk: int = 64,
    mode: str | None = None,
):
    """Windowed grouped quantile via counting selection (see module doc).

    ``plan`` is a :class:`~xsdba_tpu.utils.grouper.WindowMergePlan` whose
    ``sel_labels`` is not None.  Bit-identical to the jitted re-sort oracle
    (``grouped_nan_quantile`` of the plan's gather matrix under ``jax.jit``).
    ``mode`` (``"gather"`` / ``"emit"``) defaults to the platform's engine
    when that is a selection engine, else ``"gather"``.
    """
    if plan.sel_labels is None:
        raise ValueError("plan has no interval membership; use the merge path")
    x = jnp.asarray(x)
    G = int(plan.fast_mask.shape[0])
    lab = _plan_label_device(plan)

    # bound peak memory: the block gather materializes [B, G, K, 2*Wb]
    nq = int(np.shape(quantiles)[0])
    K = 2 * nq + 1
    per_site = G * K * 2 * Wb + 2 * (-(-x.shape[-1] // Wb)) * G
    max_chunk = max(1, (1 << 31) // max(per_site, 1))
    lead = x.shape[:-1]
    B = 1
    for d in lead:
        B *= d

    if mode is None:
        from .quantile import windowed_engine

        mode = windowed_engine(plan, quantiles)
        if mode == "merge":
            mode = "gather"

    def run(xc):
        return _selection_core_jit(
            xc,
            lab,
            jnp.asarray(quantiles, x.dtype),
            G=G,
            Wb=Wb,
            nb_chunk=nb_chunk,
            slots=slots,
            g_chunk=g_chunk,
            mode=mode,
            alpha=alpha,
            beta=beta,
        )

    if B <= max_chunk:
        return run(x)
    xf = x.reshape((B, x.shape[-1]))
    chunks = [run(xf[i : i + max_chunk]) for i in range(0, B, max_chunk)]
    out = jnp.concatenate(chunks, axis=0)
    return out.reshape(lead + out.shape[1:])


_LABEL_CACHE: "object" = None


def _plan_label_device(plan):
    global _LABEL_CACHE
    import weakref

    if _LABEL_CACHE is None:
        _LABEL_CACHE = weakref.WeakKeyDictionary()
    hit = _LABEL_CACHE.get(plan)
    if hit is None:
        hit = jnp.asarray(plan.sel_labels)
        _LABEL_CACHE[plan] = hit
    return hit
