"""Empirical Quantile Mapping and Quantile Delta Mapping.

Device re-design of reference ``adjustment.py:414-528`` (EQM) and ``:674-742``
(QDM): train is one fused jitted gather->sort->lerp over static group indexes;
adjust is one fused table lookup + correction.
"""

from __future__ import annotations

import warnings
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..ops.correction import ADDITIVE, apply_correction, equally_spaced_nodes
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from . import _algos
from ._wrap import device_brackets, fold_add_dims, grouped_var, scen_like, to_compute
from .base import TrainAdjust

__all__ = ["EmpiricalQuantileMapping", "QuantileDeltaMapping"]


class EmpiricalQuantileMapping(TrainAdjust):
    r"""Empirical Quantile Mapping: :math:`F^{-1}_{ref}(F_{hist}(sim))`.

    Train computes per-group quantiles of ``ref`` and ``hist`` and adjustment
    factors between them; adjust interpolates the factors at each sim value.
    Parameters and behavior mirror reference ``adjustment.py:414-528``:
    ``nquantiles`` (int -> bin-midpoint nodes), ``kind`` (+/*), ``group``,
    optional jitter / frequency-adaptation preprocessing, ``max_tail_factor``;
    adjust takes ``interp`` (nearest/linear/cubic) and ``extrapolation``
    (constant/nan).
    """

    _allow_diff_calendars = False
    _allow_diff_training_times = False

    @classmethod
    def _train(
        cls,
        ref: DataArray,
        hist: DataArray,
        *,
        nquantiles: int | np.ndarray = 20,
        kind: str = ADDITIVE,
        group: str | Grouper = "time",
        adapt_freq_thresh: str | None = None,
        jitter_under_thresh_value: str | None = None,
        jitter_over_thresh_value: str | None = None,
        jitter_over_thresh_upper_bnd: str | None = None,
        max_tail_factor: float | None = None,
    ) -> tuple[Dataset, dict[str, Any]]:
        group = Grouper(group) if isinstance(group, str) else group
        if np.isscalar(nquantiles):
            quantiles = equally_spaced_nodes(int(nquantiles))
        else:
            quantiles = np.asarray(nquantiles)

        gi = group.indexes(ref.time)
        if group.add_dims:
            # pooled training over the extra dims (reference base.py:413)
            (refa, hista), bdims, bcoords, n_add = fold_add_dims(group, ref, hist)
            gi_t = gi.expand(n_add)
        else:
            refa, bdims, bcoords = to_compute(ref)
            hista, _, _ = to_compute(hist)
            gi_t = gi
        quantiles = quantiles.astype(refa.dtype)  # .dtype reads metadata; np.asarray would fetch the whole device array

        hist_q_raw = None
        if max_tail_factor is not None:
            # quantiles of hist before preprocessing (reference _adjustment.py:146-149)
            from ..ops.quantile import grouped_nan_quantile

            hist_q_raw = grouped_nan_quantile(hista, gi_t.gather_idx, quantiles)

        hista = _apply_jitter(hista, hist, jitter_under_thresh_value, jitter_over_thresh_value, jitter_over_thresh_upper_bnd)
        if adapt_freq_thresh is None:
            if gi_t.merge_plan is not None:
                # windowed doy/5D groupings: the platform's windowed engine
                # (ops.quantile.windowed_engine) instead of the window-fold
                # amplified gather
                af, hist_q = _algos.eqm_train_windowed(refa, hista, gi_t.merge_plan, jnp.asarray(quantiles), kind=kind)
            else:
                # memory-bounded path: no full [..., G, L] gather materialized
                af, hist_q = _algos.eqm_train_from_raw(refa, hista, jnp.asarray(gi_t.gather_idx), jnp.asarray(quantiles), kind=kind)
            P0_ref = P0_hist = pth = None
        else:
            refg, histg, P0_ref, P0_hist, pth = _preprocess(
                refa, hista, gi_t, hist, adapt_freq_thresh, None, None, None
            )
            af, hist_q = _algos.eqm_train_core(refg, histg, quantiles, kind=kind)

        qdim = ("quantiles", quantiles)
        ds = Dataset(
            {
                "af": grouped_var(af, bdims, bcoords, gi, qdim, name="af", attrs={"standard_name": "Adjustment factors", "long_name": "Quantile mapping adjustment factors"}),
                "hist_q": grouped_var(hist_q, bdims, bcoords, gi, qdim, name="hist_q", attrs={"standard_name": "Model quantiles", "long_name": "Quantiles of model on the reference period, after preprocess"}),
            }
        )
        if hist_q_raw is not None:
            ds["hist_q_raw"] = grouped_var(hist_q_raw, bdims, bcoords, gi, qdim, name="hist_q_raw", attrs={"standard_name": "Model quantiles", "long_name": "Quantiles of model on the reference period, before preprocess"})
        if adapt_freq_thresh is not None:
            ds["P0_ref"] = grouped_var(P0_ref, bdims, bcoords, gi, name="P0_ref")
            ds["P0_hist"] = grouped_var(P0_hist, bdims, bcoords, gi, name="P0_hist")
            ds["pth"] = grouped_var(pth, bdims, bcoords, gi, name="pth")

        return ds, {
            "group": group,
            "kind": kind,
            "adapt_freq_thresh": adapt_freq_thresh,
            "max_tail_factor": max_tail_factor,
        }

    def _adjust(self, sim: DataArray, interp: str = "nearest", extrapolation: str = "constant", mode: str = "blend"):
        group: Grouper = self.group
        gi = group.indexes(sim.time)
        sima, _, _ = to_compute(sim)
        sima = _adjust_preprocess(self, sima, sim, gi)

        hist_q = jnp.asarray(self.ds["hist_q"].data)
        af = jnp.asarray(self.ds["af"].data)

        if _use_reference_interp(mode, gi):
            af_t = _reference_af_lookup(sima, hist_q, af, gi, interp, extrapolation)
            scen = apply_correction(sima, af_t, self.kind)
        else:
            scen = _algos.qm_adjust_core(
                sima,
                hist_q,
                af,
                device_brackets(gi, interp),
                kind=self.kind,
                interp=interp,
                extrapolation=extrapolation,
                tables_compact=True,  # trained tables: ascending, NaN rows whole
            )
        scen = _apply_max_tail_mask(self, sima, scen, gi, interp)
        return scen_like(sim, scen)


class QuantileDeltaMapping(EmpiricalQuantileMapping):
    r"""Quantile Delta Mapping (reference ``adjustment.py:674-742``).

    Same training as EQM; adjust ranks each sim value within its group
    (percentile), looks the factors up at that percentile and applies them —
    preserving the simulated change signal per quantile.
    """

    @classmethod
    def _train(cls, ref, hist, **kwargs):
        ds, params = super()._train(ref, hist, **kwargs)
        ds["af"].attrs["long_name"] = "Quantile delta mapping adjustment factors"
        return ds, params

    def _adjust(
        self,
        sim: DataArray,
        interp: str = "nearest",
        extrapolation: str = "constant",
        rank_window: bool | None = None,
        mode: str = "blend",
    ):
        group: Grouper = self.group
        gi = group.indexes(sim.time)
        # rank over the full training window or only group members
        # (reference _adjustment.py:858-872: window ranking is the new default
        # path when `rank_window` is set).
        if rank_window is None and group.window > 1:
            # reference _adjustment.py:858-871: unset rank_window on a
            # windowed group warns that windowed ranking becomes the only
            # behaviour in xsdba>=0.8
            warnings.warn(
                "QDM method can now perform the adjustment step by expanding "
                "the time dimension with the same window as used in the "
                "training. This can already be used by setting "
                "`rank_window = True`. This will be the only possible "
                "behaviour in `xsdba>=0.8`. The current behaviour is obtained "
                "by setting `rank_window = False` and will be deprecated in "
                "`xsdba>=0.8`.",
                category=DeprecationWarning,
                stacklevel=2,
            )
        gi_rank = gi if rank_window else Grouper(group.name).indexes(sim.time)
        sima, _, _ = to_compute(sim)
        sima = _adjust_preprocess(self, sima, sim, gi)

        af = jnp.asarray(self.ds["af"].data)
        quantiles = jnp.asarray(self.ds["af"].coords["quantiles"], dtype=sima.dtype)

        if _use_reference_interp(mode, gi):
            # reference mode consumes only the rank step from the device:
            # compute sim_q alone (the grouped AF lookup + correction the
            # full core would run are discarded here), then do the exact AF
            # lookup on host — the shared quantile nodes act as each group's
            # xq (reference _adjustment.py:874-880 + utils.py:466-480)
            from ..ops.segment import grouped_rank

            sim_q = grouped_rank(
                sima,
                jnp.asarray(gi_rank.gather_idx),
                jnp.asarray(gi_rank.group_idx),
                jnp.asarray(gi_rank.scatter_slot),
                pct=True,
            )
            G = len(gi.positions)
            xq = np.broadcast_to(np.asarray(quantiles, np.float64), (G, quantiles.shape[0]))
            af_t = _reference_af_lookup(sim_q, xq, af, gi, interp, extrapolation)
            scen = apply_correction(sima, af_t, self.kind)
        else:
            scen, sim_q = _algos.qdm_adjust_core(
                sima,
                af,
                quantiles,
                device_brackets(gi, interp),
                jnp.asarray(gi_rank.gather_idx),
                jnp.asarray(gi_rank.group_idx),
                jnp.asarray(gi_rank.scatter_slot),
                kind=self.kind,
                interp=interp,
                extrapolation=extrapolation,
            )
        scen = _apply_max_tail_mask(self, sima, scen, gi, interp)
        out = Dataset({"scen": scen_like(sim, scen), "sim_q": scen_like(sim, sim_q, name="sim_q")})
        from ..utils.options import EXTRA_OUTPUT, get_option

        if get_option(EXTRA_OUTPUT):
            return out
        return out["scen"]


def _apply_jitter(hista, hist_da, jitter_under_thresh_value, jitter_over_thresh_value, jitter_over_thresh_upper_bnd):
    """Optional jitter preprocessing of hist (reference _adjustment.py:55-68)."""
    from ..processing import _jitter_core
    from ..utils.units import convert_units_to

    if (jitter_over_thresh_value is None) ^ (jitter_over_thresh_upper_bnd is None):
        raise ValueError(
            "`jitter_over_thresh_value` and `jitter_over_thresh_upper_bnd` must both "
            "be specified or both be `None`."
        )
    if jitter_under_thresh_value or jitter_over_thresh_value:
        lower = convert_units_to(jitter_under_thresh_value, hist_da.units) if jitter_under_thresh_value else None
        upper = convert_units_to(jitter_over_thresh_value, hist_da.units) if jitter_over_thresh_value else None
        bnd = convert_units_to(jitter_over_thresh_upper_bnd, hist_da.units) if jitter_over_thresh_value else None
        hista = _jitter_core(hista, lower, upper, bnd)
    return hista


def _preprocess(
    refa,
    hista,
    gi,
    hist_da,
    adapt_freq_thresh,
    jitter_under_thresh_value,
    jitter_over_thresh_value,
    jitter_over_thresh_upper_bnd,
):
    """Training-time preprocessing (reference ``_adjustment.py:32-83``).

    Returns gathered (refg, histg, P0_ref, P0_hist, pth); the P0/pth outputs
    are NaN dummies unless adapt_freq runs.
    """
    from ..ops.segment import gather_groups
    from ..processing import _adapt_freq_grouped, _jitter_core
    from ..utils.units import convert_units_to

    hista = _apply_jitter(hista, hist_da, jitter_under_thresh_value, jitter_over_thresh_value, jitter_over_thresh_upper_bnd)

    refg = gather_groups(refa, gi.gather_idx)
    histg = gather_groups(hista, gi.gather_idx)
    G = gi.n_groups
    batch = np.shape(hista)[:-1]
    nanfill = jnp.full(batch + (G,), jnp.nan, dtype=jnp.asarray(hista).dtype)
    if adapt_freq_thresh is None:
        return refg, histg, nanfill, nanfill, nanfill
    thresh = convert_units_to(adapt_freq_thresh, hist_da.units)
    histg_ad, P0_ref, P0_hist, pth, _ = _adapt_freq_grouped(refg, histg, thresh)
    return refg, histg_ad, P0_ref, P0_hist, pth


def _use_reference_interp(mode: str, gi) -> bool:
    """True when the exact reference-parity grouped lookup should run.

    ``mode="blend"`` is the device path (separable cyclic blend);
    ``mode="reference"`` evaluates the reference's scipy-griddata
    triangulation on host (utils.py:380-400) — parity runs, not perf runs.
    The ungrouped 1-D path is already bit-faithful, so "reference" only
    changes behavior for grouped configs."""
    if mode not in ("blend", "reference"):
        raise ValueError(f"Unknown interpolation mode {mode!r} (blend, reference).")
    return mode == "reference" and gi.prop != "group"


def _reference_af_lookup(values, xq, yq, gi, interp, extrapolation):
    """Host exact grouped AF lookup at ``values`` (float64 throughout)."""
    from ..ops.interp import interp_on_quantiles_reference

    newg = gi.frac_idx if interp != "nearest" else gi.positions[gi.group_idx]
    out = interp_on_quantiles_reference(
        np.asarray(values, np.float64),
        newg,
        np.asarray(xq, np.float64),
        np.asarray(yq, np.float64),
        gi.positions,
        method=interp,
        extrap=extrapolation,
    )
    return jnp.asarray(out, jnp.asarray(values).dtype)


def _adjust_preprocess(obj, sima, sim_da, gi):
    """Adjust-time adapt_freq reuse of trained P0/pth (reference
    ``_adjustment.py:639-645``)."""
    if obj.get("adapt_freq_thresh") is None:
        return sima
    from ..processing import _adapt_freq_apply_core
    from ..utils.units import convert_units_to

    thresh = convert_units_to(obj.adapt_freq_thresh, obj.train_units)
    # reference re-runs adapt_freq on sim with group="time" semantics
    gi_time = Grouper(obj.group.name).indexes(sim_da.time)
    P0_ref = jnp.asarray(obj.ds["P0_ref"].data)
    P0_hist = jnp.asarray(obj.ds["P0_hist"].data)
    pth = jnp.asarray(obj.ds["pth"].data)
    return _adapt_freq_apply_core(sima, gi_time, thresh, P0_ref, P0_hist, pth)


def _apply_max_tail_mask(obj, sima, scen, gi, interp):
    """Skip adjustment where sim exceeds ``max_tail_factor`` times the last raw
    hist quantile (reference ``_adjustment.py:647-673``)."""
    if obj.get("max_tail_factor") is None:
        return scen
    from ._algos import broadcast_groups_core

    last_q = jnp.asarray(obj.ds["hist_q_raw"].data)[..., -1]
    interp_b = interp if gi.prop != "dayofyear" else "nearest"
    last_q_t = broadcast_groups_core(last_q, device_brackets(gi, interp_b))
    mask = sima > obj.max_tail_factor * last_q_t
    return jnp.where(mask, sima, scen)
