"""Scaling and LOCI adjustments.

Reference: ``adjustment.py:933-1050`` (classes), ``_adjustment.py:889-974``
(compute).  Both are group-mean methods — one fused segment reduction on device.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..ops.correction import ADDITIVE, MULTIPLICATIVE, get_correction
from ..ops.quantile import vecquantiles
from ..ops.segment import gather_groups
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from . import _algos
from ._wrap import device_brackets, fold_add_dims, grouped_var, scen_like, to_compute
from .base import TrainAdjust

__all__ = ["LOCI", "Scaling"]


class Scaling(TrainAdjust):
    """Scale ref/hist group means onto sim (reference adjustment.py:1005-1050)."""

    _allow_diff_calendars = False
    _allow_diff_training_times = False

    @classmethod
    def _train(cls, ref: DataArray, hist: DataArray, *, group: str | Grouper = "time", kind: str = ADDITIVE) -> tuple[Dataset, dict[str, Any]]:
        group = Grouper(group) if isinstance(group, str) else group
        gi = group.indexes(ref.time)
        if group.add_dims:
            (refa, hista), bdims, bcoords, n_add = fold_add_dims(group, ref, hist)
            gi_t = gi.expand(n_add)
        else:
            refa, bdims, bcoords = to_compute(ref)
            hista, _, _ = to_compute(hist)
            gi_t = gi
        af = _algos.scaling_train_core(refa, hista, gi_t.gather_idx, gi_t.gather_idx, kind=kind)
        ds = Dataset({"af": grouped_var(af, bdims, bcoords, gi, name="af", attrs={"standard_name": "Adjustment factors"})})
        return ds, {"group": group, "kind": kind}

    def _adjust(self, sim: DataArray, interp: str = "nearest"):
        gi = self.group.indexes(sim.time)
        sima, _, _ = to_compute(sim)
        scen = _algos.scaling_adjust_core(
            sima,
            jnp.asarray(self.ds["af"].data),
            device_brackets(gi, interp),
            kind=self.kind,
        )
        return scen_like(sim, scen)


@jax.jit
def _loci_train_core(refg, histg, thresh):
    """LOCI train (reference ``_adjustment.py:889-915``): map the wet-day
    threshold into hist-space per group, ratio of mean exceedances."""
    q = jnp.nanmean(jnp.where(jnp.isnan(refg), jnp.nan, (refg <= thresh).astype(refg.dtype)), axis=-1)
    s_thresh = vecquantiles(histg, q, axis=-1)
    ws = jnp.where(histg >= s_thresh[..., None], histg, jnp.nan)
    wo = jnp.where(refg >= thresh, refg, jnp.nan)
    ms = jnp.nanmean(ws, axis=-1)
    mo = jnp.nanmean(wo, axis=-1)
    af = get_correction(ms - s_thresh, mo - thresh, MULTIPLICATIVE)
    return af, s_thresh


@jax.jit
def _loci_adjust_core(sima, af, hist_thresh, thresh, brackets):
    """LOCI adjust (reference ``_adjustment.py:918-935``):
    ``(af * (sim - sth) + thresh).clip(0)``."""
    from ._algos import broadcast_groups_core

    sth = broadcast_groups_core(hist_thresh, brackets)
    fac = broadcast_groups_core(af, brackets)
    return jnp.clip(fac * (sima - sth) + thresh, 0, None)


class LOCI(TrainAdjust):
    """Local Intensity Scaling — wet-day threshold mapping + intensity scaling
    (Schmidli et al. 2006; reference adjustment.py:933-1002)."""

    _allow_diff_calendars = False
    _allow_diff_training_times = False

    @classmethod
    def _train(cls, ref: DataArray, hist: DataArray, *, thresh: str, group: str | Grouper = "time") -> tuple[Dataset, dict[str, Any]]:
        from ..utils.units import convert_units_to

        group = Grouper(group) if isinstance(group, str) else group
        th = convert_units_to(thresh, ref.units)
        gi = group.indexes(ref.time)
        if group.add_dims:
            (refa, hista), bdims, bcoords, n_add = fold_add_dims(group, ref, hist)
            gi_t = gi.expand(n_add)
        else:
            refa, bdims, bcoords = to_compute(ref)
            hista, _, _ = to_compute(hist)
            gi_t = gi
        refg = gather_groups(refa, gi_t.gather_idx)
        histg = gather_groups(hista, gi_t.gather_idx)
        af, s_thresh = _loci_train_core(refg, histg, jnp.asarray(th, dtype=refa.dtype))
        ds = Dataset(
            {
                "af": grouped_var(af, bdims, bcoords, gi, name="af", attrs={"standard_name": "Adjustment factors"}),
                "hist_thresh": grouped_var(s_thresh, bdims, bcoords, gi, name="hist_thresh", attrs={"units": ref.units}),
            }
        )
        return ds, {"group": group, "thresh": th}

    def _adjust(self, sim: DataArray, interp: str = "linear"):
        gi = self.group.indexes(sim.time)
        sima, _, _ = to_compute(sim)
        scen = _loci_adjust_core(
            sima,
            jnp.asarray(self.ds["af"].data),
            jnp.asarray(self.ds["hist_thresh"].data),
            jnp.asarray(self.thresh, dtype=sima.dtype),
            device_brackets(gi, interp),
        )
        return scen_like(sim, scen)
