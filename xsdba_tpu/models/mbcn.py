"""MBCn and NpdfTransform — multivariate bias adjustment.

Reference: ``adjustment.py:1718-1973`` (MBCn), ``adjustment.py:1239-1391`` +
``_adjustment.py:977-1057`` (NpdfTransform), with the npdft engine in
``models/_npdft.py``.  Group blocks are static gather matrices; the per-block
loops of the reference collapse into batched cores (blocks are a leading
batch axis).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.correction import equally_spaced_nodes
from ..ops.interp import interp1d_table
from ..ops.quantile import nan_quantile
from ..ops.rank import rank_pct_rescaled
from ..ops.rotation import rand_rot_matrix
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from ._npdft import npdft_adjust_core, npdft_train_core, standardize_lastaxis
from ._wrap import to_device_cached
from .base import Adjust, TrainAdjust
from .eqm import QuantileDeltaMapping

# rotations owe float64-reference parity: a default-precision f32 matmul
# may run in TF32 on GPUs
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["MBCn", "NpdfTransform"]

# peak elements per gathered training chunk (patchable for tests)
_TRAIN_CHUNK_BUDGET = 1 << 27


def _to_vtime_layout(da: DataArray, pts_dim: str) -> DataArray:
    """Normalize to the cores' [V, ..., T] dim order."""
    order = (pts_dim,) + tuple(d for d in da.dims if d not in (pts_dim, "time")) + ("time",)
    return da.transpose(*order) if da.dims != order else da


def _mbcn_group(group) -> Grouper:
    group = Grouper(group) if isinstance(group, str) else group
    if group.prop == "month":
        raise NotImplementedError(
            "Monthly grouping is not currently supported in the MBCn class."
        )
    if group.add_dims:
        raise NotImplementedError("`add_dims` is not supported in the MBCn class.")
    return group


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("interp", "extrap", "n_escore"))
def _mbcn_train_block(refa, hista, gidx_chunk, rotj, qj, *, interp, extrap, n_escore):
    """One npdft training pass over a chunk of group blocks.

    Module-level jit: a closure-local ``jax.jit`` would recompile on every
    ``MBCn.train`` call.
    """
    from ..ops.segment import gather_groups

    refb = jnp.moveaxis(gather_groups(refa, gidx_chunk), 0, -2)   # [..., C, V, Lw]
    histb = jnp.moveaxis(gather_groups(hista, gidx_chunk), 0, -2)
    return npdft_train_core.__wrapped__(
        refb, histb, rotj, qj, interp=interp, extrap=extrap, n_escore=n_escore
    )


@_partial(jax.jit, static_argnames=("n_chunks", "chunk", "interp", "extrap", "n_escore"))
def _mbcn_train_chunked(refa, hista, gip, rotj, qj, *, n_chunks, chunk, interp, extrap, n_escore):
    Lw = gip.shape[-1]

    def body(gc):
        return _mbcn_train_block.__wrapped__(
            refa, hista, gc, rotj, qj, interp=interp, extrap=extrap, n_escore=n_escore
        )

    return jax.lax.map(body, gip.reshape(n_chunks, chunk, Lw))


def _stacked_to_blocks(da: DataArray, gi, pts_dim: str):
    """[V, ..., T] stacked array -> gathered blocks [..., G, V, L]."""
    arr = to_device_cached(da.move_dim_last("time").data)  # [V, ..., T]
    from ..ops.segment import gather_groups

    g = gather_groups(arr, gi.gather_idx)             # [V, ..., G, L]
    return jnp.moveaxis(g, 0, -2)                     # [..., G, V, L]


class MBCn(TrainAdjust):
    r"""N-dimensional pdf transform bias adjustment (Cannon 2018).

    Train: iterative univariate quantile corrections in ``n_iter`` random
    rotations of the standardized multivariate space, factors stored per
    (group block, iteration, variable).  Adjust: replay the stored factors on
    sim, run a univariate base adjustment (QDM) per variable, and reorder it
    by the npdft ranks.  Parameters mirror reference adjustment.py:1718-1973.
    """

    _allow_diff_calendars = False
    _allow_diff_training_times = False
    _allow_diff_time_sizes = False

    @classmethod
    def _train(
        cls,
        ref: DataArray,
        hist: DataArray,
        *,
        base_kws: dict[str, Any] | None = None,
        adj_kws: dict[str, Any] | None = None,
        n_escore: int = -1,
        n_iter: int = 20,
        pts_dim: str = "multivar",
        rot_matrices=None,
    ):
        base_kws = dict(base_kws or {})
        adj_kws = dict(adj_kws or {})
        base_kws.setdefault("nquantiles", 20)
        base_kws.setdefault("group", Grouper("time", 1))
        adj_kws.setdefault("interp", "nearest")
        adj_kws.setdefault("extrapolation", "constant")
        group = _mbcn_group(base_kws["group"])

        if np.isscalar(base_kws["nquantiles"]):
            quantiles = equally_spaced_nodes(int(base_kws["nquantiles"]))
        else:
            quantiles = np.asarray(base_kws["nquantiles"])

        # the cores run in [V, ..., T] layout — normalize any input dim order
        ref = _to_vtime_layout(ref, pts_dim)
        hist = _to_vtime_layout(hist, pts_dim)

        V = int(np.shape(ref.data)[ref.dims.index(pts_dim)])
        if rot_matrices is None:
            rot = rand_rot_matrix(V, num=max(n_iter, 2))[:n_iter]
        else:
            rot = jnp.asarray(rot_matrices if not isinstance(rot_matrices, DataArray) else rot_matrices.data)

        gi = group.indexes(ref.time)
        refa = to_device_cached(ref.move_dim_last("time").data)    # [V, ..., T]
        hista = to_device_cached(hist.move_dim_last("time").data)
        dtype = refa.dtype
        rotj = jnp.asarray(rot, dtype=dtype)
        qj = jnp.asarray(quantiles, dtype=dtype)

        # Chunk over group blocks (lax.map) so windowed-doy training never
        # materializes the full [batch, G, V, window*years] tensor — each
        # block trains independently, like the reference's per-block loop
        # (_adjustment.py:386-417) but batched within each chunk.
        G, Lw = gi.gather_idx.shape
        batch = int(np.prod(refa.shape[:-1]))
        chunk = max(1, min(G, _TRAIN_CHUNK_BUDGET // max(batch * Lw, 1)))
        gidx = jnp.asarray(gi.gather_idx)

        if chunk >= G:
            af_q, escores = _mbcn_train_block(
                refa, hista, gidx, rotj, qj,
                interp=adj_kws["interp"], extrap=adj_kws["extrapolation"], n_escore=int(n_escore),
            )
        else:
            n_chunks = -(-G // chunk)
            pad = n_chunks * chunk - G
            gip = jnp.concatenate([gidx, jnp.full((pad, Lw), -1, gidx.dtype)], axis=0) if pad else gidx
            af_q, escores = _mbcn_train_chunked(
                refa, hista, gip, rotj, qj,
                n_chunks=n_chunks, chunk=chunk,
                interp=adj_kws["interp"], extrap=adj_kws["extrapolation"], n_escore=int(n_escore),
            )
            # [n_chunks, ..., C, I, V, nq] -> [..., G, I, V, nq]
            af_q = jnp.moveaxis(af_q, 0, -5)
            af_q = af_q.reshape(af_q.shape[:-5] + (n_chunks * chunk,) + af_q.shape[-3:])[..., :G, :, :, :]
            escores = jnp.moveaxis(escores, 0, -3)
            escores = escores.reshape(escores.shape[:-3] + (n_chunks * chunk,) + escores.shape[-1:])[..., :G, :]

        gdim = group.prop_name if gi.prop != "group" else "group"
        vnames = np.asarray(ref.coords.get(pts_dim, np.arange(V)))
        # extra batch dims (e.g. site) ride ahead of the grouped axes
        bdims = tuple(d for d in ref.dims if d not in (pts_dim, "time"))
        bcoords = {d: ref.coords[d] for d in bdims if d in ref.coords}
        ds = Dataset(
            {
                "af_q": DataArray(
                    af_q,
                    bdims + (gdim, "iterations", pts_dim + "_prime", "quantiles"),
                    {**bcoords, gdim: np.arange(gi.n_groups), "quantiles": quantiles, pts_dim + "_prime": vnames},
                    {"standard_name": "Adjustment factors", "long_name": "Quantile mapping adjustment factors"},
                    "af_q",
                ),
                "escores": DataArray(
                    escores, bdims + (gdim, "iterations"), {**bcoords, gdim: np.arange(gi.n_groups)}, {}, "escores"
                ),
                "rot_matrices": DataArray(
                    rot, ("iterations", pts_dim, pts_dim + "_prime"), {pts_dim: vnames, pts_dim + "_prime": vnames}, {}, "rot_matrices"
                ),
            }
        )
        params = {
            "group": group,
            "quantiles": quantiles,
            "interp": adj_kws["interp"],
            "extrapolation": adj_kws["extrapolation"],
            "pts_dims": [pts_dim, pts_dim + "_prime"],
            "n_escore": int(n_escore),
        }
        return ds, params

    def _adjust(
        self,
        sim: DataArray,
        ref: DataArray,
        hist: DataArray,
        *,
        base: type[TrainAdjust] = QuantileDeltaMapping,
        base_kws_vars: dict[str, Any] | None = None,
        adj_kws: dict[str, Any] | None = None,
        period_dim: str | None = None,
    ):
        # With period_dim, sim is a stack_periods output whose extra dim flows
        # through every core as a leading batch axis (the reference's
        # apply_ufunc dims=[period_dim, "time"] path, _adjustment.py:539-541);
        # sim's time length must still match ref's.
        self._check_matching_time_sizes(ref, hist)
        if sim.sizes["time"] != ref.sizes["time"]:
            raise ValueError("`sim` must have the same time length as `ref` (slice stacked periods accordingly).")

        pts_dim = self.pts_dims[0]
        group: Grouper = self.group
        # normalize to the cores' [V, ..., T] layout; restore sim's original
        # dim order on the way out
        orig_dims = sim.dims

        sim = _to_vtime_layout(sim, pts_dim)
        ref = _to_vtime_layout(ref, pts_dim)
        hist = _to_vtime_layout(hist, pts_dim)
        vnames = [str(v) for v in np.asarray(sim.coords[pts_dim])]
        base_kws_vars = {k: dict(v) for k, v in (base_kws_vars or {}).items()}
        for v in vnames:
            base_kws_vars.setdefault(v, {})
            g = base_kws_vars[v].pop("group", group)
            g = Grouper(g) if isinstance(g, str) else g
            if g != group:
                raise ValueError(f"`group` input in _train and _adjust must be the same. Got {group} and {g}")
            base_kws_vars[v].setdefault("nquantiles", np.asarray(self.ds["af_q"].coords["quantiles"]))
        adj_kws = dict(adj_kws or {})
        adj_kws.setdefault("interp", self.interp)
        adj_kws.setdefault("extrapolation", self.extrapolation)

        gi = group.indexes(ref.time)
        gi_sim = group.indexes(sim.time)

        from .. import processing as _proc

        var_attrs = sim.attrs.get("_variable_attrs", {})
        ref_vs = [_extract_var(ref, iv, pts_dim, var_attrs.get(v, {}), v) for iv, v in enumerate(vnames)]
        hist_vs = [_extract_var(hist, iv, pts_dim, var_attrs.get(v, {}), v) for iv, v in enumerate(vnames)]
        sim_vs = [_extract_var(sim, iv, pts_dim, var_attrs.get(v, {}), v) for iv, v in enumerate(vnames)]

        af_q_all = jnp.asarray(self.ds["af_q"].data)
        rots = jnp.asarray(self.ds["rot_matrices"].data, dtype=af_q_all.dtype)
        quantiles = jnp.asarray(self.ds["af_q"].coords["quantiles"], dtype=af_q_all.dtype)

        G, Lw = gi_sim.gather_idx.shape
        simc = sim.move_dim_last("time")
        batch = int(np.prod(simc.shape[:-1]))
        chunk = max(1, min(G, _TRAIN_CHUNK_BUDGET // max(batch * Lw, 1)))
        group_idx = jnp.asarray(gi_sim.group_idx)
        slot = jnp.asarray(gi_sim.scatter_slot)

        scen = jnp.zeros(simc.shape, dtype=af_q_all.dtype)   # [V, ..., T] layout
        for g0 in range(0, G, chunk):
            g1 = min(g0 + chunk, G)
            rows_ref = gi.gather_idx[g0:g1]
            rows_sim = gi_sim.gather_idx[g0:g1]

            # --- 1. univariate base adjustment per variable, per block ------
            scen_blocks = [
                _per_block_univariate(base, ref_vs[iv], hist_vs[iv], sim_vs[iv], rows_ref, rows_sim, base_kws_vars[v], adj_kws)
                for iv, v in enumerate(vnames)
            ]
            scen_block = jnp.stack(scen_blocks, axis=-2)      # [..., C, V, Lw]

            # --- 2. npdft adjustment of standardized sim blocks -------------
            from ..ops.segment import gather_groups

            sim_arr = jnp.asarray(simc.data)                  # [V, ..., T]
            simb = jnp.moveaxis(gather_groups(sim_arr, jnp.asarray(rows_sim)), 0, -2)  # [..., C, V, Lw]
            simb_std = standardize_lastaxis(simb)
            npdft_block = npdft_adjust_core(
                simb_std,
                af_q_all[..., g0:g1, :, :, :],
                rots,
                quantiles,
                interp=self.interp,
                extrap=self.extrapolation,
            )

            # --- 3. reorder the univariate scen by the npdft ranks ----------
            reordered = _proc._reordering_core(npdft_block, scen_block)   # [..., C, V, Lw]

            # --- 4. write back window centers for this chunk's groups -------
            r2 = jnp.moveaxis(reordered, -2, 0)               # [V, ..., C, Lw]
            in_chunk = (group_idx >= g0) & (group_idx < g1)
            lg = jnp.clip(group_idx - g0, 0, g1 - g0 - 1)
            vals = r2[..., lg, slot]                          # [V, ..., T]
            scen = jnp.where(in_chunk, vals, scen)

        out = DataArray(scen, simc.dims, dict(simc.coords), dict(sim.attrs), "scen")
        if simc.dims != orig_dims:
            out = out.transpose(*orig_dims)
        return out


def _extract_var(da: DataArray, iv: int, pts_dim: str, attrs: dict, name: str) -> DataArray:
    ax = da.dims.index(pts_dim)
    data = jnp.take(jnp.asarray(da.data), iv, axis=ax)
    dims = tuple(d for d in da.dims if d != pts_dim)
    coords = {k: v for k, v in da.coords.items() if k != pts_dim}
    return DataArray(data, dims, coords, dict(attrs), name)


def _per_block_univariate(base, ref_v, hist_v, sim_v, rows_ref, rows_sim, base_kws, adj_kws):
    """Train+adjust the univariate base per windowed group block, batched.

    Reference ``_adjustment.py:552-559``: inside each block the base is
    trained with group="time" on the block members — i.e. the block axis IS
    the group axis, so this is one grouped QDM over the gather matrices.
    Returns gathered scen blocks [..., G, Lw].
    """
    from ..ops.segment import gather_groups
    from ..processing import _adapt_freq_grouped, _jitter_core
    from ..utils.units import convert_units_to

    kws = dict(base_kws)
    nquantiles = kws.pop("nquantiles")
    if np.isscalar(nquantiles):
        nquantiles = equally_spaced_nodes(int(nquantiles))
    kind = kws.pop("kind", "+")
    adapt_freq_thresh = kws.pop("adapt_freq_thresh", None)
    jitter_under = kws.pop("jitter_under_thresh_value", None)
    if kws:
        raise NotImplementedError(f"Unsupported base_kws_vars options: {sorted(kws)}")

    refa = to_device_cached(ref_v.move_dim_last("time").data)
    hista = to_device_cached(hist_v.move_dim_last("time").data)
    sima = to_device_cached(sim_v.move_dim_last("time").data)
    q = jnp.asarray(nquantiles, dtype=refa.dtype)

    if jitter_under is not None:
        lo = convert_units_to(jitter_under, ref_v.units or "")
        refa = _jitter_core(refa, lo, None, None)
        hista = _jitter_core(hista, lo, None, None)
        sima = _jitter_core(sima, lo, None, None)

    refg = gather_groups(refa, jnp.asarray(rows_ref))      # [..., C, Lw]
    histg = gather_groups(hista, jnp.asarray(rows_ref))
    simg = gather_groups(sima, jnp.asarray(rows_sim))

    if adapt_freq_thresh is not None:
        th = convert_units_to(adapt_freq_thresh, ref_v.units or "")
        histg, P0r, P0h, pth, _ = _adapt_freq_grouped(refg, histg, th)
        simg, *_ = _adapt_freq_grouped(None, simg, th, P0_ref=P0r, P0_hist=P0h, pth=pth)

    # QDM train on blocks
    ref_q = nan_quantile(refg, q, axis=-1)
    hist_q = nan_quantile(histg, q, axis=-1)
    if kind == "*":
        af = ref_q / hist_q
    else:
        af = ref_q - hist_q
    # QDM adjust within each block
    rnk = rank_pct_rescaled(simg, axis=-1)
    qtab = jnp.broadcast_to(q, af.shape)
    af_t = interp1d_table(rnk, qtab, af, adj_kws["interp"], adj_kws["extrapolation"])
    return simg * af_t if kind == "*" else simg + af_t


class NpdfTransform(Adjust):
    r"""N-dimensional pdf transform (Pitié 2005 / Cannon 2018 step 1).

    One-shot scheme: iterative univariate adjustment of hist & sim toward ref
    in random rotations of the multivariate space
    (reference adjustment.py:1239-1391, _adjustment.py:977-1057).
    Returns scen (the transformed sim); with ``extra_output``, also scenh
    (transformed hist) and escores.
    """

    @classmethod
    def _adjust(
        cls,
        ref: DataArray,
        hist: DataArray,
        sim: DataArray,
        *,
        base: type[TrainAdjust] = QuantileDeltaMapping,
        base_kws: dict[str, Any] | None = None,
        adj_kws: dict[str, Any] | None = None,
        n_escore: int = 0,
        n_iter: int = 20,
        pts_dim: str = "multivar",
        rot_matrices=None,
    ):
        import warnings

        base_kws = dict(base_kws or {})
        adj_kws = dict(adj_kws or {})
        if "kind" in base_kws:
            warnings.warn(f'The adjustment kind cannot be controlled when using {cls.__name__}, it defaults to "+".', stacklevel=2)
        base_kws.setdefault("kind", "+")
        base_kws.setdefault("nquantiles", 20)
        group = Grouper(base_kws.pop("group", "time")) if isinstance(base_kws.get("group", "time"), str) else base_kws.pop("group")
        if np.isscalar(base_kws["nquantiles"]):
            quantiles = equally_spaced_nodes(int(base_kws["nquantiles"]))
        else:
            quantiles = np.asarray(base_kws["nquantiles"])
        interp = adj_kws.get("interp", "nearest")
        extrap = adj_kws.get("extrapolation", "constant")
        from .eqm import EmpiricalQuantileMapping

        if base is QuantileDeltaMapping:
            base_name = "qdm"
        elif base is EmpiricalQuantileMapping:
            base_name = "eqm"
        else:
            # any TrainAdjust subclass (reference adjustment.py:1283-1307):
            # run the reference's python loop over rotations, dispatching
            # each univariate step through the base's own public train/adjust
            base_name = None

        # normalize to the cores' [V, ..., T] layout
        ref = _to_vtime_layout(ref, pts_dim)
        hist = _to_vtime_layout(hist, pts_dim)
        sim = _to_vtime_layout(sim, pts_dim)

        V = int(np.shape(ref.data)[ref.dims.index(pts_dim)])
        if rot_matrices is None:
            rot = rand_rot_matrix(V, num=max(n_iter, 2))[:n_iter]
        else:
            rot = jnp.asarray(rot_matrices if not isinstance(rot_matrices, DataArray) else rot_matrices.data)

        gi = group.indexes(ref.time)
        gi_sim = group.indexes(sim.time)

        refa = to_device_cached(ref.move_dim_last("time").data)   # [V, ..., T]
        hista = to_device_cached(hist.move_dim_last("time").data)
        sima = to_device_cached(sim.move_dim_last("time").data)
        refa = jnp.moveaxis(refa, 0, -2)                     # [..., V, T]
        hista = jnp.moveaxis(hista, 0, -2)
        sima = jnp.moveaxis(sima, 0, -2)

        if base_name is None:
            scenh, scens, escores = _npdf_loop_general(
                cls, base, base_kws, adj_kws, group, quantiles,
                ref, hist, sim, refa, hista, sima,
                jnp.asarray(rot, dtype=refa.dtype), int(n_escore),
            )
            return cls._npdft_wrap_outputs(scenh, scens, escores, sim, hist)

        from ._npdft import npdf_transform_core

        scenh, scens, escores = npdf_transform_core(
            refa,
            hista,
            sima,
            jnp.asarray(rot, dtype=refa.dtype),
            jnp.asarray(quantiles, dtype=refa.dtype),
            jnp.asarray(gi.gather_idx),
            jnp.asarray(gi.group_idx),
            jnp.asarray(gi.scatter_slot),
            jnp.asarray(gi_sim.gather_idx),
            jnp.asarray(gi_sim.group_idx),
            jnp.asarray(gi_sim.scatter_slot),
            jnp.asarray(gi.frac_idx, dtype=refa.dtype),
            jnp.asarray(gi.positions, dtype=refa.dtype),
            jnp.asarray(gi_sim.frac_idx, dtype=refa.dtype),
            jnp.asarray(gi_sim.positions, dtype=refa.dtype),
            interp=interp,
            extrap=extrap,
            n_escore=int(n_escore),
            base=base_name,
        )

        return cls._npdft_wrap_outputs(scenh, scens, escores, sim, hist)

    @classmethod
    def _npdft_wrap_outputs(cls, scenh, scens, escores, sim, hist):
        def _wrap(a, like, name):
            arr = jnp.moveaxis(a, -2, 0)
            lc = like.move_dim_last("time")
            da = DataArray(arr, lc.dims, dict(lc.coords), dict(like.attrs), name)
            return da.transpose(*like.dims) if lc.dims != like.dims else da

        # escores: [batch..., n_iter] — batch dims are sim's dims without the
        # leading pts_dim and trailing time (the cores' [batch, V, T] layout)
        bdims = sim.dims[1:-1]
        bcoords = {d: sim.coords[d] for d in bdims if d in sim.coords}
        return Dataset(
            {
                "scen": _wrap(scens, sim, "scen"),
                "scenh": _wrap(scenh, hist, "scenh"),
                "escores": DataArray(escores, bdims + ("iterations",), bcoords, {}, "escores"),
            }
        )


def _npdf_loop_general(cls, base, base_kws, adj_kws, group, quantiles, ref, hist, sim, refa, hista, sima, rots, n_escore):
    """NpdfTransform with an arbitrary TrainAdjust base: the reference's
    per-iteration loop (``_adjustment.py:1005-1037``) — rotate, train the base
    on the rotated pair, adjust rotated hist & sim, rotate back — dispatched
    through the base class's own public train/adjust (``skip_input_checks``
    avoids re-validating the rotated, unit-less space each iteration)."""
    from ..ops.escore import escore as escore_fn
    from ..utils.options import set_options

    def wrap(a, like):
        arr = jnp.moveaxis(a, -2, 0)
        lc = like.move_dim_last("time")
        return DataArray(arr, lc.dims, dict(lc.coords), dict(like.attrs), like.name)

    Th = refa.shape[-1]
    stride = max(1, int(-(-Th // n_escore))) if n_escore > 0 else 1
    mu = jnp.nanmean(refa, axis=-1, keepdims=True)
    sd = jnp.nanstd(refa, axis=-1, ddof=1, keepdims=True)
    ref_n = ((refa - mu) / sd)[..., ::stride]

    train_kws = dict(base_kws)
    train_kws["nquantiles"] = np.asarray(quantiles)
    escores = []
    h, s = hista, sima
    for i in range(rots.shape[0]):
        R = rots[i]
        refp = jnp.einsum("ij,...jl->...il", R, refa, precision=_HIGHEST)
        hp = jnp.einsum("ij,...jl->...il", R, h, precision=_HIGHEST)
        sp = jnp.einsum("ij,...jl->...il", R, s, precision=_HIGHEST)
        with set_options(extra_output=False, as_dataset=False):
            ADJ = base.train(wrap(refp, ref), wrap(hp, hist), group=group, skip_input_checks=True, **train_kws)
            scenhp = ADJ.adjust(wrap(hp, hist), skip_input_checks=True, **adj_kws)
            # sim must carry its OWN time coords: the base adjustment derives
            # its group indexes (and any calendar logic) from the wrapped time
            scensp = ADJ.adjust(wrap(sp, sim), skip_input_checks=True, **adj_kws)
        hb = jnp.moveaxis(jnp.asarray(scenhp.move_dim_last("time").data), 0, -2)
        sb = jnp.moveaxis(jnp.asarray(scensp.move_dim_last("time").data), 0, -2)
        h = jnp.einsum("ji,...jl->...il", R, hb, precision=_HIGHEST)
        s = jnp.einsum("ji,...jl->...il", R, sb, precision=_HIGHEST)
        if n_escore >= 0:
            hn = (h - mu) / sd
            escores.append(escore_fn(ref_n, hn[..., ::stride]))
        else:
            escores.append(jnp.full(h.shape[:-2], jnp.nan, h.dtype))
    return h, s, jnp.stack(escores, axis=-1)
