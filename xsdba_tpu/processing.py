"""Pre/post-processing operations.

Device re-design of reference ``processing.py`` + ``_processing.py``: jitter,
frequency adaptation, normalization, standardization, rank reordering —
all as jitted array cores plus thin labeled wrappers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops.quantile import vecquantiles
from .ops.rank import average_rank
from .ops.segment import gather_groups, scatter_back
from .utils.container import DataArray, Dataset
from .utils.formatting import update_history
from .utils.grouper import GroupIndexes, Grouper, parse_group
from .utils.rng import next_key
from .utils.units import convert_units_to

__all__ = [
    "adapt_freq",
    "broadcast",
    "estimate_delta_from_cf",
    "get_clusters",
    "interp_on_quantiles",
    "rank",
    "sort_along_dim",
    "escore",
    "from_additive_space",
    "grouped_time_indexes",
    "jitter",
    "jitter_over_thresh",
    "jitter_under_thresh",
    "normalize",
    "reordering",
    "spectral_filter",
    "stack_periods",
    "stack_variables",
    "standardize",
    "to_additive_space",
    "uniform_noise_like",
    "unstack_periods",
    "unstack_variables",
    "unstandardize",
]


# ---------------------------------------------------------------------------
# jitter — reference processing.py:124-257
# ---------------------------------------------------------------------------


def _jitter_core(x, lower: float | None, upper: float | None, upper_bnd: float | None, key=None, lower_bnd: float | None = None):
    """Replace values below ``lower`` with U(lower_bnd, lower) noise and
    values above ``upper`` with U(upper, upper_bnd) noise.  NaN-preserving.
    ``lower_bnd`` defaults to machine epsilon (noise stays strictly
    positive)."""
    x = jnp.asarray(x)
    key = next_key() if key is None else key
    out = x
    if lower is not None:
        lo_bnd = jnp.finfo(x.dtype).eps if lower_bnd is None else lower_bnd
        k1, key = jax.random.split(key)
        noise = jax.random.uniform(k1, x.shape, dtype=x.dtype, minval=lo_bnd, maxval=lower)
        out = jnp.where(out < lower, noise, out)
    if upper is not None:
        if upper_bnd is None:
            raise ValueError("`upper_bnd` must be given with `upper`.")
        k2, _ = jax.random.split(key)
        noise = jax.random.uniform(k2, x.shape, dtype=x.dtype, minval=upper, maxval=upper_bnd)
        out = jnp.where(out > upper, noise, out)
    return jnp.where(jnp.isnan(x), jnp.nan, out)


def jitter(
    x: DataArray,
    lower: str | None = None,
    upper: str | None = None,
    minimum: str | None = None,
    maximum: str | None = None,
) -> DataArray:
    """Jitter under ``lower`` and/or over ``upper`` (reference
    processing.py:124-224).  ``minimum``/``maximum`` bound the noise."""
    lo = convert_units_to(lower, x.units) if lower is not None else None
    up = convert_units_to(upper, x.units) if upper is not None else None
    mn = convert_units_to(minimum, x.units) if minimum is not None else None
    mx = convert_units_to(maximum, x.units) if maximum is not None else None
    out = _jitter_core(x.data, lo, up, mx, lower_bnd=mn)
    res = x.copy(data=out)
    res.attrs["history"] = update_history(f"jitter(x, lower={lower}, upper={upper})", x)
    return res


def jitter_under_thresh(x: DataArray, thresh: str) -> DataArray:
    """Replace values below ``thresh`` with uniform noise in (0, thresh)
    (reference processing.py:227-257) — removes ties at zero before
    multiplicative adjustments."""
    return jitter(x, lower=thresh)


def jitter_over_thresh(x: DataArray, thresh: str, upper_bnd: str) -> DataArray:
    """Replace values above ``thresh`` with uniform noise in
    (thresh, upper_bnd) (reference processing.py:198-224)."""
    return jitter(x, upper=thresh, maximum=upper_bnd)


def uniform_noise_like(da: DataArray, low: float = 1e-6, high: float = 1e-3) -> DataArray:
    """Uniform noise with da's shape (reference processing.py:304-320)."""
    data = jax.random.uniform(next_key(), np.shape(da.data), minval=low, maxval=high)
    return da.copy(data=data.astype(da.dtype))


# ---------------------------------------------------------------------------
# adapt_freq — reference _processing.py:20-142, processing.py:50-121
# ---------------------------------------------------------------------------


def _rank_random_tiebreak(v, key):
    """Percentile rank in [0,1] with random tie-breaking (reference
    utils.py:575-638 use_random_tiebreak branch): noise in U(0.1, 0.25) is
    added to the integer ranks, then re-ranked."""
    rnk = average_rank(v, axis=-1)
    noise = jax.random.uniform(key, v.shape, dtype=v.dtype, minval=0.1, maxval=0.25)
    rnk = average_rank(jnp.where(jnp.isnan(rnk), jnp.nan, rnk + noise), axis=-1)
    nvalid = jnp.sum(~jnp.isnan(v), axis=-1, keepdims=True).astype(v.dtype)
    rnk = rnk / jnp.where(nvalid == 0, 1, nvalid)
    mn = jnp.nanmin(rnk, axis=-1, keepdims=True)
    mx = jnp.nanmax(rnk, axis=-1, keepdims=True)
    denom = jnp.where(mx - mn == 0, 1, mx - mn)
    return mx * (rnk - mn) / denom


def _ecdf_lastaxis(v, thresh):
    le = jnp.nansum(jnp.where(jnp.isnan(v), 0, (v <= thresh).astype(v.dtype)), axis=-1)
    n = jnp.sum(~jnp.isnan(v), axis=-1)
    return le / jnp.where(n == 0, 1, n)


def _adapt_freq_grouped(refg, simg, thresh, P0_ref=None, P0_hist=None, pth=None, key=None):
    """Frequency adaptation on gathered group matrices [..., G, L].

    Implements reference ``_processing.py:74-135``: the fraction
    ``dP0 = (P0_hist - P0_ref)/P0_hist`` of below-threshold sim values with the
    smallest tie-broken ranks is replaced by U(thresh, pth) noise, where
    ``pth = ref-quantile at P0_hist``.

    Returns (sim_ad [..., G, L], P0_ref, P0_hist, pth, dP0 each [..., G]).
    """
    key = next_key() if key is None else key
    simg = jnp.asarray(simg)
    P0_sim = _ecdf_lastaxis(simg, thresh)
    if P0_hist is None:
        P0_hist = P0_sim
    if P0_ref is None:
        P0_ref = _ecdf_lastaxis(jnp.asarray(refg), thresh)
    dP0 = jnp.where(P0_hist == 0, jnp.nan, (P0_hist - P0_ref) / jnp.where(P0_hist == 0, 1, P0_hist))
    if pth is None:
        pth = vecquantiles(jnp.asarray(refg), P0_hist, axis=-1)
        pth = jnp.where(dP0 > 0, pth, jnp.nan)

    k1, k2 = jax.random.split(key)
    rnk = _rank_random_tiebreak(simg, k1)
    no_adapt = (dP0 <= 0) | jnp.isnan(dP0)
    ratio = jnp.where(P0_hist == 0, jnp.inf, P0_ref / jnp.where(P0_hist == 0, 1, P0_hist))
    preserve = (
        (rnk < (ratio * P0_sim)[..., None])
        | (rnk > P0_sim[..., None])
        | jnp.isnan(simg)
    )
    noise = (pth[..., None] - thresh) * jax.random.uniform(k2, simg.shape, dtype=simg.dtype) + thresh
    sim_ad = jnp.where(no_adapt[..., None], simg, jnp.where(preserve, simg, noise))
    return sim_ad, P0_ref, P0_hist, pth, dP0


def _adapt_freq_core(refa, sima, gi: GroupIndexes, thresh, key=None):
    """Training-path adapt_freq over raw [..., T] arrays: gather by group,
    adapt, return the *gathered* adapted sim (quantile computation consumes
    the gathered matrix directly) and per-group P0/pth."""
    refg = gather_groups(refa, gi.gather_idx)
    simg = gather_groups(sima, gi.gather_idx)
    sim_ad, P0_ref, P0_hist, pth, _ = _adapt_freq_grouped(refg, simg, thresh, key=key)
    return sim_ad, P0_ref, P0_hist, pth


def _adapt_freq_apply_core(sima, gi: GroupIndexes, thresh, P0_ref, P0_hist, pth, key=None):
    """Adjust-path adapt_freq reusing trained P0/pth (reference
    ``_adjustment.py:639-645``); returns the adapted time series."""
    simg = gather_groups(sima, gi.gather_idx)
    sim_ad, *_ = _adapt_freq_grouped(None, simg, thresh, P0_ref=P0_ref, P0_hist=P0_hist, pth=pth, key=key)
    return scatter_back(sim_ad, gi.group_idx, gi.scatter_slot)


@parse_group
def adapt_freq(
    ref: DataArray,
    sim: DataArray,
    *,
    group: str | Grouper = "time",
    thresh: str = "0 mm d-1",
) -> Dataset:
    """Adapt the frequency of below-threshold values of sim to match ref
    (Themessl et al. 2012; reference processing.py:50-121).

    Returns a Dataset with ``sim_ad``, ``pth``, ``dP0``, ``P0_ref``, ``P0_hist``.
    """
    group = Grouper(group) if isinstance(group, str) else group
    th = convert_units_to(thresh, sim.units)
    gi = group.indexes(sim.time)
    simc = sim.move_dim_last("time")
    refc = ref.move_dim_last("time")
    refg = gather_groups(jnp.asarray(refc.data), gi.gather_idx)
    simg = gather_groups(jnp.asarray(simc.data), gi.gather_idx)
    sim_ad_g, P0_ref, P0_hist, pth, dP0 = _adapt_freq_grouped(refg, simg, th)
    sim_ad = scatter_back(sim_ad_g, gi.group_idx, gi.scatter_slot)

    from .models._wrap import grouped_var, scen_like

    bdims = simc.dims[:-1]
    bcoords = {d: simc.coords[d] for d in bdims if d in simc.coords}
    out = Dataset(
        {
            "sim_ad": scen_like(sim, sim_ad, name="sim_ad"),
            "pth": grouped_var(pth, bdims, bcoords, gi, name="pth"),
            "dP0": grouped_var(dP0, bdims, bcoords, gi, name="dP0"),
            "P0_ref": grouped_var(P0_ref, bdims, bcoords, gi, name="P0_ref"),
            "P0_hist": grouped_var(P0_hist, bdims, bcoords, gi, name="P0_hist"),
        }
    )
    out["sim_ad"].attrs.update(sim.attrs)
    out["sim_ad"].attrs["history"] = update_history(f"adapt_freq(ref, sim, group={group.name!r}, thresh={thresh!r})", sim)
    return out


# ---------------------------------------------------------------------------
# normalize / standardize — reference processing.py:260-358, _processing.py:145-181
# ---------------------------------------------------------------------------


@parse_group
def normalize(
    data: DataArray,
    norm: DataArray | None = None,
    *,
    group: str | Grouper = "time",
    kind: str = "+",
) -> tuple[DataArray, DataArray]:
    """Remove the group-wise mean (kind-aware).  Returns (anomaly, norm)
    (reference processing.py:260-301)."""
    from .models._algos import broadcast_groups_core
    from .models._wrap import device_brackets
    from .ops.correction import apply_correction, invert

    group = Grouper(group) if isinstance(group, str) else group
    gi = group.indexes(data.time)
    datac = data.move_dim_last("time")
    x = jnp.asarray(datac.data)
    if norm is None:
        normv = jnp.nanmean(gather_groups(x, gi.gather_idx), axis=-1)
    else:
        normv = jnp.asarray(norm.data)
    factors = broadcast_groups_core(invert(normv, kind), device_brackets(gi, "nearest"))
    anom = apply_correction(x, factors, kind)

    from .models._wrap import grouped_var, scen_like

    bdims = datac.dims[:-1]
    bcoords = {d: datac.coords[d] for d in bdims if d in datac.coords}
    out = scen_like(data, anom, name=data.name)
    out.attrs.update(data.attrs)
    norm_da = grouped_var(normv, bdims, bcoords, gi, name="norm", attrs={"units": data.units})
    return out, norm_da


def standardize(da: DataArray, mean=None, std=None, dim: str = "time"):
    """(x - mean)/std along dim; returns (standardized, mean, std)
    (reference processing.py:323-350)."""
    dac = da.move_dim_last(dim)
    x = jnp.asarray(dac.data)
    mu = jnp.nanmean(x, axis=-1, keepdims=True) if mean is None else mean
    sig = jnp.nanstd(x, axis=-1, keepdims=True) if std is None else std
    from .models._wrap import scen_like

    out = scen_like(da, (x - mu) / sig, name=da.name)
    out.attrs.update(da.attrs)
    return out, mu, sig


def unstandardize(da: DataArray, mean, std, dim: str = "time"):
    dac = da.move_dim_last(dim)
    from .models._wrap import scen_like

    out = scen_like(da, jnp.asarray(dac.data) * std + mean, name=da.name)
    out.attrs.update(da.attrs)
    return out


# ---------------------------------------------------------------------------
# reordering — reference processing.py:361-390, _processing.py:184-247
# ---------------------------------------------------------------------------


def _reordering_core(ref, sim):
    """sort(sim)[argsort(argsort(ref))] along the last axis."""
    sim_sorted = jnp.sort(sim, axis=-1)
    order = jnp.argsort(jnp.argsort(ref, axis=-1), axis=-1)
    return jnp.take_along_axis(sim_sorted, order, axis=-1)


def reordering(ref: DataArray, sim: DataArray, group: str | Grouper = "time") -> DataArray:
    """Reorder sim so its rank structure matches ref's (Schaake shuffle;
    reference processing.py:361-390), optionally within each group block."""
    group = Grouper(group) if isinstance(group, str) else group
    refc = ref.move_dim_last("time")
    simc = sim.move_dim_last("time")
    rv, sv = jnp.asarray(refc.data), jnp.asarray(simc.data)
    if group.prop == "group":
        out = _reordering_core(rv, sv)
    else:
        # reorder within each group's (optionally window-expanded) members:
        # gather into [..., G, Lw] (NaN padded — pads rank last on both
        # sides, and padding both ref and sim identically leaves the ranks of
        # real elements untouched), reorder flat per group, then each
        # timestep reads its own (group, center-slot) cell.  For window > 1
        # that cell is the middle-of-window column — exactly the reference's
        # ``_reordering_2d`` (``_processing.py:205-210``: flat reorder over
        # [time, window], keep ``[:, window // 2]``).
        gi = group.indexes(sim.time)
        gidx = jnp.asarray(gi.gather_idx)
        pad = gidx < 0
        safe = jnp.clip(gidx, 0, rv.shape[-1] - 1)
        rg = jnp.where(pad, jnp.nan, rv[..., safe])
        sg = jnp.where(pad, jnp.nan, sv[..., safe])
        og = _reordering_core(rg, sg)                       # [..., G, Lw]
        Lw = og.shape[-1]
        flat = og.reshape(og.shape[:-2] + (og.shape[-2] * Lw,))
        pos = jnp.asarray(gi.group_idx.astype(np.int64) * Lw + gi.scatter_slot)
        out = flat[..., pos]
    from .models._wrap import scen_like

    res = scen_like(sim, out, name=sim.name)
    res.attrs.update(sim.attrs)
    res.attrs["history"] = update_history("reordering(ref, sim)", sim)
    return res


# ---------------------------------------------------------------------------
# stack_variables / unstack_variables — reference processing.py:736-826
# ---------------------------------------------------------------------------


def stack_variables(ds: Dataset, rechunk: bool = True, dim: str = "multivar") -> DataArray:
    """Stack Dataset variables into one DataArray along a leading ``dim``
    (alphabetical order).  Per-variable attrs are preserved for
    :func:`unstack_variables`; units are blanked on the stacked array.
    ``rechunk`` is accepted for reference signature parity (processing.py:736)
    and ignored — there is no dask layer here."""
    items = sorted(ds.items(), key=lambda e: e[0])
    names = [nm for nm, _ in items]
    first = items[0][1]
    data = jnp.stack([jnp.asarray(v.data) for _, v in items], axis=0)
    coords = dict(first.coords)
    coords[dim] = np.array(names)
    attrs = dict(ds.attrs)
    attrs["units"] = ""
    attrs["_variable_attrs"] = {nm: dict(v.attrs) for nm, v in items}
    return DataArray(data, (dim,) + first.dims, coords, attrs, "multivariate")


def unstack_variables(da: DataArray, dim: str | None = None) -> Dataset:
    """Inverse of :func:`stack_variables`."""
    dim = dim or next((d for d in da.dims if d in da.coords and np.asarray(da.coords[d]).dtype.kind in "US"), None)
    if dim is None:
        raise ValueError("No variable coordinate found, were attributes removed?")
    names = [str(n) for n in np.asarray(da.coords[dim])]
    ax = da.dims.index(dim)
    var_attrs = da.attrs.get("_variable_attrs", {})
    out = {}
    for i, nm in enumerate(names):
        sub_dims = tuple(d for d in da.dims if d != dim)
        data = jnp.take(jnp.asarray(da.data), i, axis=ax)
        coords = {k: v for k, v in da.coords.items() if k != dim}
        attrs = dict(var_attrs.get(nm, {}))
        out[nm] = DataArray(data, sub_dims, coords, attrs, nm)
    ds_attrs = {k: v for k, v in da.attrs.items() if k not in ("units", "_variable_attrs")}
    return Dataset(out, ds_attrs)


def escore(tgt: DataArray, sim: DataArray, dims=("multivar", "time"), N: int = 0, scale: bool = False) -> DataArray:
    """Energy score between two multivariate arrays (reference
    processing.py:393-489): optional even subsampling of N points and
    standardization by tgt's mean/std."""
    from .ops.escore import escore as escore_core

    tgtc = tgt.move_dim_last(dims[1])
    simc = sim.move_dim_last(dims[1])
    tv = jnp.asarray(tgtc.data)
    sv = jnp.asarray(simc.data)
    # move the multivar dim to -2
    vax = tgtc.dims.index(dims[0])
    tv = jnp.moveaxis(tv, vax, -2)
    sv = jnp.moveaxis(sv, simc.dims.index(dims[0]), -2)
    if N > 0:
        step_t = max(1, int(np.ceil(tv.shape[-1] / N)))
        step_s = max(1, int(np.ceil(sv.shape[-1] / N)))
        tv = tv[..., ::step_t]
        sv = sv[..., ::step_s]
    if scale:
        mu = jnp.nanmean(tv, axis=-1, keepdims=True)
        sd = jnp.nanstd(tv, axis=-1, ddof=1, keepdims=True)
        tv = (tv - mu) / sd
        sv = (sv - mu) / sd
    out = escore_core(tv, sv)
    bdims = tuple(d for d in tgtc.dims if d not in dims)
    res = DataArray(out, bdims, {d: tgt.coords[d] for d in bdims if d in tgt.coords}, {}, "escores")
    res.attrs["long_name"] = "Energy dissimilarity metric"
    res.attrs["description"] = "Escores computed from paired standardized observations."
    return res


# ---------------------------------------------------------------------------
# additive-space transforms — reference processing.py:492-733
# ---------------------------------------------------------------------------


def to_additive_space(
    data: DataArray,
    lower_bound: str,
    upper_bound: str | None = None,
    trans: str = "log",
    clip_next_to_bounds: str | None = None,
) -> DataArray:
    """Map a bounded variable into an additive space via log/logit
    (Alavoine & Grenier 2022; reference processing.py:492-612)."""
    lb = convert_units_to(lower_bound, data.units)
    ub = convert_units_to(upper_bound, data.units) if upper_bound is not None else None
    x = jnp.asarray(data.data)

    if clip_next_to_bounds is not None:
        if clip_next_to_bounds == "strict":
            lo = float(jnp.nanmin(x))
            hi = float(jnp.nanmax(x))
            if lo < lb or (ub is not None and hi > ub):
                raise ValueError("Data exceeds the given bounds and clip_next_to_bounds='strict'.")
        elif clip_next_to_bounds != "permissive":
            raise ValueError("clip_next_to_bounds must be None, 'strict' or 'permissive'.")
        eps = jnp.finfo(jnp.float32).eps
        span = (ub - lb) if ub is not None else max(abs(lb), 1.0)
        x = jnp.clip(x, lb + eps * span, (ub - eps * span) if ub is not None else None)

    if trans == "log":
        out = jnp.log(x - lb)
    elif trans == "logit":
        if ub is None:
            raise ValueError("`upper_bound` is required for the logit transform.")
        xp = (x - lb) / (ub - lb)
        out = jnp.log(xp / (1 - xp))
    else:
        raise NotImplementedError("`trans` must be one of 'log' or 'logit'.")

    res = data.copy(data=out)
    res.attrs["xsdba_transform"] = trans
    res.attrs["xsdba_transform_lower"] = float(lb)
    if ub is not None:
        res.attrs["xsdba_transform_upper"] = float(ub)
    if "units" in res.attrs:
        res.attrs["xsdba_transform_units"] = res.attrs.pop("units")
        res.attrs["units"] = ""
    res.attrs["history"] = update_history(f"to_additive_space(data, trans={trans!r})", data)
    return res


def from_additive_space(
    data: DataArray,
    lower_bound: str | None = None,
    upper_bound: str | None = None,
    trans: str | None = None,
    units: str | None = None,
) -> DataArray:
    """Inverse of :func:`to_additive_space` (reference processing.py:615-733)."""
    if trans is None and lower_bound is None and units is None:
        try:
            trans = data.attrs["xsdba_transform"]
            units = data.attrs["xsdba_transform_units"]
            lb = float(data.attrs["xsdba_transform_lower"])
            ub = float(data.attrs["xsdba_transform_upper"]) if trans == "logit" else None
        except KeyError as err:
            raise ValueError(
                f"Attribute {err!s} must be present on the input data or all parameters must be given as arguments."
            ) from err
    elif trans is not None and lower_bound is not None and units is not None and (upper_bound is not None or trans == "log"):
        lb = convert_units_to(lower_bound, units)
        ub = convert_units_to(upper_bound, units) if trans == "logit" else None
    else:
        raise ValueError("Either all parameters are attributes of data, or all are given as arguments.")

    x = jnp.asarray(data.data)
    if trans == "log":
        out = jnp.exp(x) + lb
    elif trans == "logit":
        xp = 1 / (1 + jnp.exp(-x))
        out = xp * (ub - lb) + lb
    else:
        raise NotImplementedError("`trans` must be one of 'log' or 'logit'.")

    res = data.copy(data=out)
    for k in ("xsdba_transform", "xsdba_transform_lower", "xsdba_transform_upper", "xsdba_transform_units"):
        res.attrs.pop(k, None)
    res.attrs["units"] = units
    res.attrs["history"] = update_history(f"from_additive_space(data, trans={trans!r})", data)
    return res


# ---------------------------------------------------------------------------
# stack_periods / unstack_periods — reference base.py:1072-1381
# ---------------------------------------------------------------------------


_UNIFORM_CALENDARS = ("noleap", "365_day", "all_leap", "366_day", "360_day")

_ANCHOR_MONTHS = {
    "JAN": 1, "FEB": 2, "MAR": 3, "APR": 4, "MAY": 5, "JUN": 6,
    "JUL": 7, "AUG": 8, "SEP": 9, "OCT": 10, "NOV": 11, "DEC": 12,
}


def _anchor_month(start_anchored: bool, anchor: str | None) -> int:
    """Effective *start* anchor month of a Y/Q/M offset.

    End-anchored offsets bin identically to the start-anchored offset rooted
    one month later (YE-JUN periods are Jul..Jun years = YS-JUL periods;
    pandas defaults the end anchor to DEC, whose start equivalent is JAN)."""
    if start_anchored:
        return _ANCHOR_MONTHS[anchor.upper()] if anchor else 1
    am = _ANCHOR_MONTHS[anchor.upper()] if anchor else 12
    return am % 12 + 1


def _period_unit_ids(time, base: str, anchor_month: int):
    """Absolute integer id of the base-frequency period holding each timestep
    (the static equivalent of the reference's ``resample(...).groups``
    anchoring, base.py:1198-1229)."""
    if base == "D":
        return time.ordinal.astype(np.int64)
    p = {"Y": 12, "A": 12, "Q": 3, "M": 1}[base]
    return (time.year.astype(np.int64) * 12 + (time.month - 1) - (anchor_month - 1)) // p


def _virtual_next_uid(time, base: str, anchor_month: int, srcfreq: str):
    """Unit id of the element one sampling step past the end (the reference's
    ``time2`` extra step, base.py:1188-1196)."""
    from .utils.calendar import TimeIndex, _ordinal_to_ymd

    if srcfreq == "MS":
        m = int(time.year[-1]) * 12 + int(time.month[-1])  # next month
        y, mo = divmod(m, 12)
        ext = TimeIndex(np.array([y]), np.array([mo + 1]), np.array([1]), time.calendar, None)
    else:
        step = int(np.median(np.diff(time.ordinal))) if len(time) > 1 else 1
        y, mo, d = _ordinal_to_ymd(np.array([time.ordinal[-1] + step]), time.calendar)
        ext = TimeIndex(y, mo, d, time.calendar, None)
    return int(_period_unit_ids(ext, base, anchor_month)[0])


def stack_periods(
    da: DataArray,
    window: int = 30,
    stride: int | None = None,
    min_length: int | None = None,
    freq: str = "YS",
    dim: str = "period",
    align_days: bool = True,
    pad_value=np.nan,
) -> DataArray:
    """Stack (possibly overlapping) multi-period windows into a new ``period``
    dimension (reference base.py:1072-1270).

    ``window``/``stride``/``min_length`` are in units of ``freq`` (any
    start-anchored Y/Q/M offset, with anchors and multiples, plus D/W).
    Reversible with :func:`unstack_periods` when ``stride`` divides ``window``
    into an odd number of parts.  Parameters are stored in attrs (the
    container equivalent of the reference's coord attrs).
    """
    from .utils.calendar import parse_offset

    stride = stride or window
    min_length = min_length or window
    if stride > window:
        raise ValueError(f"Stride must be less than or equal to window. Got {stride} > {window}.")

    time = da.time
    mult, base, start_anchored, anchor = parse_offset(freq)
    if base not in ("Y", "A", "Q", "M", "D"):
        raise NotImplementedError(f"stack_periods does not support base frequency {base!r}.")
    am = _anchor_month(start_anchored, anchor) if base != "D" else 1
    cal = time.calendar
    srcfreq = time.infer_freq() or "D"

    # day-alignment guard (reference base.py:1160-1178)
    if srcfreq == "D" and align_days:
        if base in ("Y", "A") and cal not in _UNIFORM_CALENDARS:
            raise ValueError(
                f"Stacking {window}{freq} periods will result in unaligned day-of-year. "
                "Consider converting the calendar of your data to one with uniform year "
                "lengths, or pass `align_days=False` to disable this check."
            )
        if base in ("Q", "M") and window > 1 and cal != "360_day":
            raise ValueError(
                f"Stacking {window}{freq} periods will result in unaligned day-of-month. "
                "Consider using a 360_day calendar, or pass `align_days=False`."
            )

    dac = da.move_dim_last("time")
    x = np.asarray(dac.data)
    T = x.shape[-1]
    uid = _period_unit_ids(time, base, am)
    rel = uid - uid[0]
    rel_ext = _virtual_next_uid(time, base, am, srcfreq) - uid[0]

    stride_u, win_u, minl_u = stride * mult, window * mult, min_length * mult
    p_months = {"Y": 12, "A": 12, "Q": 3, "M": 1}.get(base)
    first_is_period_start = (
        base == "D" or ((int(time.year[0]) * 12 + int(time.month[0]) - 1 - (am - 1)) % p_months == 0)
    )

    segments = []
    k = 0
    while True:
        su = k * stride_u
        sidx = int(np.searchsorted(rel, su, side="left"))
        if sidx >= T:
            break
        w0 = rel[sidx]  # window anchors on the unit period of the stride start
        chk_u = w0 + (minl_u if min_length < window else win_u)
        if rel_ext < chk_u:  # open-ended: the (min-)window is not complete
            break
        if (
            sidx == 0
            and base in ("Y", "A", "Q")
            and min_length == window
            and not first_is_period_start
        ):
            # fractionally-incomplete first period (reference base.py:1216-1224)
            k += 1
            continue
        eidx = int(np.searchsorted(rel, w0 + win_u, side="left"))
        segments.append((sidx, min(eidx, T)))
        k += 1

    if not segments:
        raise ValueError("No complete periods found; series shorter than `min_length`.")

    lengths = [e - s for s, e in segments]
    L = max(lengths)
    out = np.full(x.shape[:-1] + (len(segments), L), pad_value, dtype=x.dtype)
    for pnum, (s, e) in enumerate(segments):
        out[..., pnum, : e - s] = x[..., s:e]

    # per-period boundaries of stride-long unit sections, for unstacking
    nwin = window // stride
    secbounds = []
    for s, e in segments:
        rel2 = uid[s:e] - uid[s]
        sb = [int(np.searchsorted(rel2, j * stride_u, side="left")) for j in range(nwin + 1)]
        sb[-1] = min(sb[-1], e - s)
        secbounds.append(sb)

    coords = {c: v for c, v in dac.coords.items() if c != "time"}
    coords[dim] = np.array(
        [f"{time.year[s]:04d}-{time.month[s]:02d}-{time.day[s]:02d}" for s, _ in segments]
    )
    # placeholder time coordinate (reference base.py:1256: `start` argument)
    from .utils.calendar import date_range as _date_range

    coords["time"] = _date_range("1970-01-01", periods=L, freq=srcfreq, calendar=cal)
    res = DataArray(out, dac.dims[:-1] + (dim, "time"), coords, dict(da.attrs), da.name)
    res.attrs["_stack_periods"] = {
        "window": window,
        "stride": stride,
        "freq": freq,
        "segments": [list(se) for se in segments],
        "secbounds": secbounds,
        "T": T,
        "time_ymd": (time.year.copy(), time.month.copy(), time.day.copy()),
        "calendar": cal,
        "unequal_lengths": int(len(set(lengths)) > 1),
    }
    return res


def unstack_periods(da: DataArray, dim: str = "period") -> DataArray:
    """Inverse of :func:`stack_periods`: keep the center-most stride of each
    window; the series ends come from the first/last windows (reference
    base.py:1272-1381)."""
    params = da.attrs.get("_stack_periods")
    if params is None:
        raise ValueError("`da` must have been created by stack_periods (missing params attr).")
    window, stride = params["window"], params["stride"]
    if (window / stride) % 2 != 1:
        raise NotImplementedError(
            "`unstack_periods` can only work with a stride that divides the window "
            f"into an odd number of parts. Got {window} / {stride}."
        )
    segments = params["segments"]
    secbounds = params["secbounds"]
    T = params["T"]
    dac = da.move_dim_last("time")
    ax = dac.dims.index(dim)
    x = np.asarray(dac.data)
    out = np.full(x.shape[:ax] + x.shape[ax + 1 : -1] + (T,), np.nan, dtype=x.dtype)
    nwin = window // stride
    mid = (nwin - 1) // 2
    nseg = len(segments)
    for pnum, (s, e) in enumerate(segments):
        seg = np.take(x, pnum, axis=ax)
        length = e - s
        sb = secbounds[pnum]
        keep0 = 0 if pnum == 0 else min(sb[mid], length)
        keep1 = length if pnum == nseg - 1 else min(sb[mid + 1], length)
        out[..., s + keep0 : s + keep1] = seg[..., keep0:keep1]

    dims = tuple(d for d in dac.dims if d != dim)
    coords = {c: v for c, v in dac.coords.items() if c not in (dim, "time")}
    if "time_ymd" in params:
        from .utils.calendar import TimeIndex

        y, m, d = params["time_ymd"]
        coords["time"] = TimeIndex(y, m, d, params["calendar"], None)
    res = DataArray(out, dims, coords, {k: v for k, v in da.attrs.items() if k != "_stack_periods"}, da.name)
    return res


# ---------------------------------------------------------------------------
# spectral filter — reference processing.py:921-1161
# ---------------------------------------------------------------------------


def _dct2(x, axis):
    """Type-II DCT along ``axis`` (orthonormal), via FFT (Makhoul 1980)."""
    x = jnp.moveaxis(x, axis, -1)
    N = x.shape[-1]
    v = jnp.concatenate([x[..., ::2], x[..., 1::2][..., ::-1]], axis=-1)
    V = jnp.fft.fft(v, axis=-1)
    k = jnp.arange(N)
    factor = 2 * jnp.exp(-1j * jnp.pi * k / (2 * N))
    out = jnp.real(V * factor)
    # orthonormalization
    scale = jnp.where(k == 0, jnp.sqrt(1 / (4 * N)), jnp.sqrt(1 / (2 * N)))
    return jnp.moveaxis(out * scale, -1, axis)


def _idct2(X, axis):
    """Inverse of :func:`_dct2` (type-III DCT, orthonormal), via FFT."""
    X = jnp.moveaxis(X, axis, -1)
    N = X.shape[-1]
    k = jnp.arange(N)
    scale = jnp.where(k == 0, jnp.sqrt(1 / (4 * N)), jnp.sqrt(1 / (2 * N)))
    Xu = X / scale
    Xrev = jnp.concatenate([jnp.zeros_like(Xu[..., :1]), Xu[..., :0:-1]], axis=-1)
    V = (Xu - 1j * Xrev) * jnp.exp(1j * jnp.pi * k / (2 * N)) / 2
    v = jnp.fft.ifft(V, axis=-1)
    h = (N + 1) // 2
    x = jnp.zeros_like(X)
    x = x.at[..., ::2].set(jnp.real(v[..., :h]))
    x = x.at[..., 1::2].set(jnp.real(v[..., h:][..., ::-1]))
    return jnp.moveaxis(x, -1, axis)


def cos2_mask_func(da, low, high):
    """Cosine-squared low-pass mask (reference processing.py:950-984):
    1 below ``low``, cos^2 ramp between, 0 above ``high``."""
    ramp = jnp.cos(((da - low) / (high - low)) * (jnp.pi / 2)) ** 2
    return jnp.where(da < low, 1.0, jnp.where(da > high, 0.0, ramp))


def estimate_delta_from_cf(da: DataArray) -> str:
    """Estimate the grid length scale from a latitude-like coordinate
    (reference processing.py:1042-1058: ``da.cf["Y"]``).  Finds a coordinate
    whose units are degrees-north (or is named lat/latitude/y) and returns
    the spacing as a quantity string — degrees are converted to km at
    111.2 km/degree."""
    for name, coord in da.coords.items():
        attrs = getattr(coord, "attrs", {}) if hasattr(coord, "attrs") else {}
        units = attrs.get("units")
        is_y = units in ("degrees", "degrees_north") or name in ("lat", "latitude", "y")
        if not is_y:
            continue
        vals = np.sort(np.asarray(coord.data if hasattr(coord, "data") else coord, dtype=np.float64))
        if len(vals) < 2:
            continue
        # median spacing: robust to duplicated values (step 0) and to
        # non-uniform (e.g. Gaussian) grids, where the first gap alone
        # misrepresents the grid scale
        diffs = np.diff(vals)
        step = float(np.median(diffs[diffs > 0])) if (diffs > 0).any() else 0.0
        if step == 0.0:
            raise ValueError(f"Coordinate {name!r} has no distinct values to estimate a grid spacing from.")
        if units in ("degrees", "degrees_north") or (units is None and name in ("lat", "latitude")):
            # explicit degree units, or a latitude-named coord (degrees is
            # the only sensible reading) — NOT a bare "y", which on a
            # projected grid is meters and must declare its units
            return f"{step * 111.2} km"
        if units is None:
            raise ValueError(
                f"Coordinate {name!r} has no units attribute; set one (e.g. 'degrees_north', 'km') "
                "or pass `delta` explicitly."
            )
        return f"{step} {units}"
    raise ValueError("Could not find a latitude-like coordinate (units 'degrees_north' or name lat/latitude/y) to estimate the grid scale from.")


def spectral_filter(
    da: DataArray,
    dims: list[str],
    lam_long: str | None = None,
    lam_short: str | None = None,
    delta: str | None = None,
    alpha_low_high: tuple[float, float] | None = None,
    mask_func=cos2_mask_func,
) -> DataArray:
    """DCT low-pass filter over spatial dims (Denis et al. 2002; reference
    processing.py:1063-1161).  Bounds given either as wavelengths + grid
    resolution ``delta`` (estimated from a latitude coordinate when omitted,
    reference processing.py:1135-1137), or directly as normalized
    wavenumbers."""
    if isinstance(dims, str):
        dims = [dims]
    if alpha_low_high is not None:
        alpha_low, alpha_high = alpha_low_high
    else:
        if lam_long is None or lam_short is None:
            raise ValueError("Either `alpha_low_high` or (`lam_long`, `lam_short`) must be given.")
        if delta is None:
            delta = estimate_delta_from_cf(da)
        from .utils.units import str2quantity

        d = str2quantity(delta).to("m").magnitude
        alpha_low = 2 * d / str2quantity(lam_long).to("m").magnitude
        alpha_high = 2 * d / str2quantity(lam_short).to("m").magnitude

    x = jnp.asarray(da.data)
    axes = [da.dims.index(d) for d in dims]
    # normalized radial wavenumber alpha = sqrt(sum (i_d/N_d)^2)
    alpha2 = jnp.zeros(tuple(x.shape[a] for a in axes))
    for pos, a in enumerate(axes):
        N = x.shape[a]
        idx = (jnp.arange(N) / N) ** 2
        shape = [1] * len(axes)
        shape[pos] = N
        alpha2 = alpha2 + idx.reshape(shape)
    alpha = jnp.sqrt(alpha2)
    mask = mask_func(alpha, alpha_low, alpha_high)

    coeffs = x
    for a in axes:
        coeffs = _dct2(coeffs, a)
    # broadcast mask onto the full array shape
    full = [1] * x.ndim
    for pos, a in enumerate(axes):
        full[a] = x.shape[a]
    coeffs = coeffs * mask.reshape(full)
    out = coeffs
    for a in axes:
        out = _idct2(out, a)

    res = da.copy(data=out)
    res.attrs["history"] = update_history(
        f"spectral_filter(da, dims={dims}, alpha=({float(alpha_low):.4g}, {float(alpha_high):.4g}))", da
    )
    return res


def grouped_time_indexes(times, group):
    """Integer time-index blocks per group and windowed group (reference
    processing.py:829-918): returns (g_idxs [G, L], gw_idxs [G, Lw]) with -1
    padding.  On device this is just the Grouper's static lowering."""
    group = Grouper(group) if isinstance(group, str) else group
    gi_w = group.indexes(times)
    gi = Grouper(group.name).indexes(times) if group.window > 1 else gi_w
    return gi.gather_idx, gi_w.gather_idx


# ---------------------------------------------------------------------------
# public array utilities mirrored from reference utils.py
# ---------------------------------------------------------------------------


def rank(da: DataArray, dim: str = "time", pct: bool = False, use_random_tiebreak: bool = False) -> DataArray:
    """Rank data along a dimension (reference utils.py:575-638): average ranks
    starting at 1; with ``pct`` rescaled to span [0, 1]."""
    from .ops.rank import average_rank, rank_pct_rescaled

    dac = da.move_dim_last(dim)
    x = jnp.asarray(dac.data)
    if use_random_tiebreak:
        # noise in U(0.1, 0.25) breaks ties on the integer ranks without
        # reordering distinct values (reference utils.py:619-627)
        r0 = average_rank(x, axis=-1)
        noise = jax.random.uniform(next_key(), x.shape, dtype=x.dtype, minval=0.1, maxval=0.25)
        out = average_rank(jnp.where(jnp.isnan(r0), jnp.nan, r0 + noise), axis=-1)
        if pct:
            nvalid = jnp.sum(~jnp.isnan(x), axis=-1, keepdims=True).astype(out.dtype)
            out = out / jnp.where(nvalid == 0, 1, nvalid)
            mn = jnp.nanmin(out, axis=-1, keepdims=True)
            mx = jnp.nanmax(out, axis=-1, keepdims=True)
            out = mx * (out - mn) / jnp.where(mx - mn == 0, 1, mx - mn)
    else:
        out = rank_pct_rescaled(x, axis=-1) if pct else average_rank(x, axis=-1)
    from .models._wrap import scen_like

    res = scen_like(da, out, name=da.name)
    res.attrs["units"] = ""
    return res


def sort_along_dim(da: DataArray, dim: str = "time") -> DataArray:
    """Sort values along a dimension (reference utils.py:516-542)."""
    dac = da.move_dim_last(dim)
    from .models._wrap import scen_like

    out = scen_like(da, jnp.sort(jnp.asarray(dac.data), axis=-1), name=da.name)
    out.attrs.update(da.attrs)
    return out


def get_clusters(data: DataArray, u1, u2, dim: str = "time") -> Dataset:
    """Cluster count/max/positions along ``dim`` (reference utils.py:844-921)."""
    from .ops.clusters import cluster_fields

    dac = data.move_dim_last(dim)
    x = jnp.asarray(dac.data)
    fields = cluster_fields(x, u1, u2, max_clusters=x.shape[-1] // 2)
    bdims = dac.dims[:-1]
    bcoords = {d: dac.coords[d] for d in bdims if d in dac.coords}
    C = fields["start"].shape[-1]
    mk = lambda v, nm: DataArray(v, bdims + ("cluster",), {**bcoords, "cluster": np.arange(C)}, {}, nm)
    return Dataset(
        {
            "start": mk(fields["start"], "start"),
            "end": mk(fields["end"], "end"),
            "maxpos": mk(fields["maxpos"], "maxpos"),
            "maximum": mk(fields["maximum"], "maximum"),
            "nclusters": DataArray(fields["nclusters"], bdims, bcoords, {}, "nclusters"),
        }
    )


@parse_group
def broadcast(
    grouped: DataArray,
    x: DataArray,
    *,
    group: str | Grouper = "time",
    interp: str = "nearest",
    sel: dict[str, DataArray] | None = None,
) -> DataArray:
    """Broadcast a grouped array ([..., prop]) back onto ``x``'s time axis
    (reference ``utils.py:181-248``): nearest selection by group id, or
    linear interpolation over the fractional group index with cyclic group
    padding.  ``sel`` maps additional grouped dimensions to per-time
    coordinates of ``x`` (e.g. ``{"quantiles": sim_rank}``): those dims are
    consumed by pointwise nearest selection / linear interpolation — the
    separable equivalent of the reference's multi-dim ``.sel``/``.interp``."""
    from .ops.correction import broadcast_group_factors

    group = Grouper(group) if isinstance(group, str) else group
    gi = group.indexes(x.time)
    prop = group.prop_name if gi.prop != "group" else "group"
    gc = grouped.move_dim_last(prop)
    out = broadcast_group_factors(
        jnp.asarray(gc.data),
        jnp.asarray(gi.frac_idx),
        jnp.asarray(gi.group_idx),
        gi.positions,
        interp=interp,
    )
    bdims = gc.dims[:-1]
    for key, selda in (sel or {}).items():
        if key not in bdims:
            raise ValueError(f"sel key {key!r} is not a dimension of the grouped array {bdims}.")
        coord = jnp.asarray(np.asarray(gc.coords[key], dtype=np.float64), out.dtype)
        # align sel values onto (bdims - key) + time by dim name
        sc = selda.move_dim_last("time") if "time" in selda.dims else selda
        tgt_dims = tuple(d for d in bdims if d != key) + ("time",)
        vshape = [1] * len(tgt_dims)
        for d, n in zip(sc.dims, np.shape(sc.data)):
            if d not in tgt_dims:
                raise ValueError(f"sel value for {key!r} has unknown dim {d!r}.")
            vshape[tgt_dims.index(d)] = n
        vals = jnp.asarray(sc.data).reshape(vshape) if sc.dims != tgt_dims else jnp.asarray(sc.data)
        ax = bdims.index(key)
        moved = jnp.moveaxis(out, ax, -1)  # (bdims - key) + (time, K)
        if interp == "nearest":
            idx = jnp.argmin(jnp.abs(coord[None, :] - vals[..., None]), axis=-1)
            out = jnp.take_along_axis(moved, idx[..., None], axis=-1)[..., 0]
        else:
            hi = jnp.clip(jnp.searchsorted(coord, vals), 1, coord.shape[0] - 1)
            lo = hi - 1
            clo, chi = coord[lo], coord[hi]
            w = jnp.clip((vals - clo) / jnp.where(chi == clo, 1.0, chi - clo), 0.0, 1.0)
            vlo = jnp.take_along_axis(moved, lo[..., None], axis=-1)[..., 0]
            vhi = jnp.take_along_axis(moved, hi[..., None], axis=-1)[..., 0]
            out = vlo * (1 - w) + vhi * w
            # reference semantics: xarray .interp returns NaN outside the
            # coordinate span (no extrapolation) — the clip above would
            # otherwise silently constant-extrapolate out-of-range sels
            out = jnp.where((vals < coord[0]) | (vals > coord[-1]), jnp.nan, out)
        bdims = tuple(d for d in bdims if d != key)
    coords = {d: gc.coords[d] for d in bdims if d in gc.coords}
    coords["time"] = x.time
    return DataArray(out, bdims + ("time",), coords, dict(grouped.attrs), grouped.name)


@parse_group
def interp_on_quantiles(
    newx: DataArray,
    xq: DataArray,
    yq: DataArray,
    *,
    group: str | Grouper = "time",
    method: str = "linear",
    extrapolation: str = "constant",
    mode: str = "blend",
) -> DataArray:
    """Public grouped/ungrouped quantile-table interpolation (reference
    utils.py:409-513).

    ``mode="blend"`` (default) runs the device separable cyclic blend for
    grouped lookups; ``mode="reference"`` evaluates the reference's exact
    scipy-griddata triangulation on host (utils.py:380-400) — use it when
    bit-parity with xsdba outputs matters more than speed.  The ungrouped
    1-D path is identical either way."""
    from .ops.interp import interp1d_table, interp_on_quantiles_grouped, interp_on_quantiles_reference

    if mode not in ("blend", "reference"):
        raise ValueError(f"Unknown interpolation mode {mode!r} (blend, reference).")
    group = Grouper(group) if isinstance(group, str) else group
    v = jnp.asarray(newx.move_dim_last("time").data)
    xqv = jnp.asarray(xq.data)
    yqv = jnp.asarray(yq.data)
    grouped = not (group.prop == "group" or (group.prop_name not in xq.dims and group.prop_name not in yq.dims))
    if not grouped:
        out = interp1d_table(v, xqv, yqv, method, extrapolation)
    else:
        gi = group.indexes(newx.time)
        G = len(gi.positions)
        # reference utils.py:476-480: a prop-less table is shared by all groups
        if group.prop_name not in xq.dims:
            # insert the group axis for ANY prop-less xq — a multi-dim xq
            # carrying batch dims would otherwise have its last-but-one batch
            # axis silently misread as the group axis downstream
            xqv = jnp.broadcast_to(
                xqv[..., None, :], xqv.shape[:-1] + (G,) + xqv.shape[-1:]
            )
        if mode == "reference":
            newg = gi.frac_idx if method != "nearest" else gi.positions[gi.group_idx]
            out = jnp.asarray(
                interp_on_quantiles_reference(
                    np.asarray(v, np.float64),
                    newg,
                    np.asarray(xqv, np.float64),
                    np.asarray(yqv, np.float64),
                    gi.positions,
                    method=method,
                    extrap=extrapolation,
                ),
                v.dtype,
            )
        else:
            out = interp_on_quantiles_grouped(
                v,
                jnp.asarray(gi.frac_idx, dtype=v.dtype),
                xqv,
                yqv,
                jnp.asarray(gi.positions, dtype=v.dtype),
                method,
                extrapolation,
            )
    from .models._wrap import scen_like

    return scen_like(newx, out, name=newx.name)
