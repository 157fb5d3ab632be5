"""Parity of the windowed-quantile engines (XLA merge cascade, counting
selection) vs the exact gather+re-sort path."""

import numpy as np
import pytest

from xsdba_tpu.ops.quantile import grouped_nan_quantile, windowed_group_quantile
from xsdba_tpu.utils.calendar import date_range
from xsdba_tpu.utils.grouper import Grouper


def _series(calendar, years, n_sites, seed=0):
    start = "2001-01-01"
    # enough periods for `years` full years in either calendar
    t = date_range(start, periods=366 * years, freq="D", calendar=calendar)
    # crop to whole years is unnecessary — edge handling must cope anyway
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (n_sites, len(t)))
    # sprinkle NaNs
    x[rng.random(x.shape) < 0.01] = np.nan
    return t, x


@pytest.mark.parametrize("calendar", ["noleap", pytest.param("standard", marks=pytest.mark.slow)])
@pytest.mark.parametrize("window", [5, pytest.param(31, marks=pytest.mark.slow)])
def test_windowed_doy_quantile_matches_resort(calendar, window):
    t, x = _series(calendar, years=6, n_sites=3)
    gi = Grouper("time.dayofyear", window=window).indexes(t)
    assert gi.merge_plan is not None
    assert gi.merge_plan.n_fast > 0
    q = np.array([0.01, 0.1, 0.5, 0.9, 0.99])

    want = np.asarray(grouped_nan_quantile(x, gi.gather_idx, q))
    got = np.asarray(windowed_group_quantile(x, gi.merge_plan, q, engine="merge"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("engine", ["merge", "gather", "emit"])
@pytest.mark.parametrize("window", [9, 13, 16, 21, 24, 27])
def test_window_sweep_engines_exact(window, engine):
    """Every windowed-quantile engine across window sizes (odd and even,
    below and above 16) against the jitted re-sort oracle, with scattered
    NaNs: the selection engines are bit-identical, the merge cascade agrees
    to ulp level (strict-f32 static gamma vs the device's FMA-contracted
    one; see the precision note on ``windowed_group_quantile``)."""
    import jax
    import jax.numpy as jnp

    t, x = _series("noleap", years=3, n_sites=2, seed=100 + window)
    gi = Grouper("time.dayofyear", window=window).indexes(t)
    q = np.array([0.02, 0.1, 0.33, 0.5, 0.9, 0.98])
    want = np.asarray(
        jax.jit(lambda xx, qq: grouped_nan_quantile(xx, gi.gather_idx, qq))(
            jnp.asarray(x), jnp.asarray(q)
        )
    )
    got = np.asarray(windowed_group_quantile(x, gi.merge_plan, q, engine=engine))
    if engine == "merge":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def test_5d_grouping_merge_plan_matches():
    t, x = _series("noleap", years=5, n_sites=2, seed=3)
    gi = Grouper("5D", window=3).indexes(t)
    assert gi.merge_plan is not None
    q = np.array([0.25, 0.5, 0.75])
    want = np.asarray(grouped_nan_quantile(x, gi.gather_idx, q))
    got = np.asarray(windowed_group_quantile(x, gi.merge_plan, q, engine="merge"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_no_plan_for_month_or_unwindowed():
    t, _ = _series("noleap", years=3, n_sites=1)
    assert Grouper("time.month").indexes(t).merge_plan is None
    assert Grouper("time.dayofyear").indexes(t).merge_plan is None


@pytest.mark.parametrize("kind", [pytest.param("+", marks=pytest.mark.slow), "*"])
def test_dqm_train_windowed_matches_chunked(kind):
    import jax.numpy as jnp

    from xsdba_tpu.models._algos import dqm_train_from_raw, dqm_train_windowed

    t, x = _series("noleap", years=5, n_sites=2, seed=7)
    ref = np.abs(x) + 0.5
    hist = np.abs(np.roll(x, 7, axis=-1)) * 1.3 + 0.2
    gi = Grouper("time.dayofyear", window=15).indexes(t)
    q = np.linspace(0.05, 0.95, 9)

    af_w, hq_w, sc_w = dqm_train_windowed(ref, hist, gi.merge_plan, jnp.asarray(q), kind=kind)
    af_c, hq_c, sc_c = dqm_train_from_raw(ref, hist, jnp.asarray(gi.gather_idx), jnp.asarray(q), kind=kind)
    np.testing.assert_allclose(np.asarray(sc_w), np.asarray(sc_c), rtol=1e-10, equal_nan=True)
    np.testing.assert_allclose(np.asarray(hq_w), np.asarray(hq_c), rtol=1e-9, atol=1e-11, equal_nan=True)
    np.testing.assert_allclose(np.asarray(af_w), np.asarray(af_c), rtol=1e-9, atol=1e-11, equal_nan=True)


@pytest.mark.slow
def test_eqm_model_windowed_dispatch():
    """End-to-end: EQM train with doy+window grouping goes through the merge
    path and adjusts identically to the chunked path."""
    import jax.numpy as jnp

    from xsdba_tpu import DataArray, EmpiricalQuantileMapping
    from xsdba_tpu.models._algos import eqm_train_from_raw

    t, x = _series("noleap", years=6, n_sites=1)
    ref = DataArray(x[0] + 1.0, ("time",), {"time": t}, {"units": "K"}, "tas")
    hist = DataArray(x[0] * 1.1 + 3.0, ("time",), {"time": t}, {"units": "K"}, "tas")
    eqm = EmpiricalQuantileMapping.train(ref, hist, group="time.dayofyear", window=31, nquantiles=20)
    gi = Grouper("time.dayofyear", window=31).indexes(t)
    af_c, hq_c = eqm_train_from_raw(
        jnp.asarray(x[0] + 1.0), jnp.asarray(x[0] * 1.1 + 3.0),
        jnp.asarray(gi.gather_idx), jnp.asarray(eqm.ds["af"].coords["quantiles"]), kind="+",
    )
    np.testing.assert_allclose(np.asarray(eqm.ds["af"].data), np.asarray(af_c), rtol=1e-10, equal_nan=True)
    scen = eqm.adjust(hist, interp="linear")
    assert np.isfinite(np.asarray(scen.data)).mean() > 0.99


def test_windowed_quantile_nan_data_dispatch():
    """NaN data must take the exact (gather) extraction and still match the
    re-sort path; the speculative static path is discarded."""
    import jax.numpy as jnp

    from xsdba_tpu.ops.correction import equally_spaced_nodes
    from xsdba_tpu.ops.quantile import grouped_nan_quantile, windowed_group_quantile
    from xsdba_tpu.utils.grouper import Grouper

    rng = np.random.default_rng(7)
    t = date_range("2000-01-01", periods=365 * 4, freq="D", calendar="noleap")
    gi = Grouper("time.dayofyear", window=11).indexes(t)
    x = rng.normal(0, 1, (3, len(t)))
    x[0, 100:200] = np.nan  # a NaN gap
    x[2, :] = np.nan        # an all-NaN site
    q = equally_spaced_nodes(7)
    got = np.asarray(windowed_group_quantile(jnp.asarray(x), gi.merge_plan, jnp.asarray(q)))
    want = np.asarray(grouped_nan_quantile(jnp.asarray(x), gi.gather_idx, jnp.asarray(q)))
    # NaN data takes the exact-count gather extraction: value-exact to ulps
    # (the finite path is bit-exact; see the tests above)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)
    # second call exercises the no-speculation path (plan hint is now False)
    got2 = np.asarray(windowed_group_quantile(jnp.asarray(x), gi.merge_plan, jnp.asarray(q)))
    np.testing.assert_allclose(got2, want, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_windowed_fused_trace_safe_under_outer_jit():
    """The fused train+adjust wrapper must be traceable under an outer jit /
    lax.scan: the speculative host finiteness probe (a ``bool(device scalar)``)
    is impossible there, so the call must fall back to the NaN-safe dynamic
    extraction — and ``assume_finite=True`` must pin the static fast path
    instead.  Both must match the eager result."""
    import jax
    import jax.numpy as jnp

    from xsdba_tpu.models._algos import eqm_train_adjust_windowed
    from xsdba_tpu.models._wrap import device_brackets
    from xsdba_tpu.ops.correction import equally_spaced_nodes

    t = date_range("2001-01-01", periods=365 * 2, freq="D", calendar="noleap")
    gi = Grouper("5D", window=3).indexes(t)  # 73 groups: cheap compile
    rng = np.random.default_rng(11)
    T = len(t)
    ref = jnp.asarray(rng.normal(10, 2, (2, T)))
    hist = jnp.asarray(rng.normal(12, 3, (2, T)))
    sim = jnp.asarray(rng.normal(13, 3, (2, T)))
    q = jnp.asarray(equally_spaced_nodes(5).astype(np.float64))
    br = device_brackets(gi, "linear")

    want, _, _ = eqm_train_adjust_windowed(ref, hist, sim, gi.merge_plan, q, br, kind="+")
    want = np.asarray(want)

    @jax.jit
    def dyn(r):
        s, _, _ = eqm_train_adjust_windowed(r, hist, sim, gi.merge_plan, q, br, kind="+")
        return s

    @jax.jit
    def pinned(r):
        s, _, _ = eqm_train_adjust_windowed(
            r, hist, sim, gi.merge_plan, q, br, kind="+", assume_finite=True
        )
        return s

    np.testing.assert_allclose(np.asarray(dyn(ref)), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(pinned(ref)), want, rtol=1e-12)

    # train-only wrapper under a trace (the non-pairable fallback path)
    from xsdba_tpu.models._algos import eqm_train_windowed

    af_want, _ = eqm_train_windowed(ref, hist, gi.merge_plan, q, kind="+")

    @jax.jit
    def train_dyn(r):
        af, _ = eqm_train_windowed(r, hist, gi.merge_plan, q, kind="+")
        return af

    np.testing.assert_allclose(np.asarray(train_dyn(ref)), np.asarray(af_want), rtol=1e-12)


def test_windowed_fused_nan_dispatch_matches_two_call():
    """NaN ref data must discard the speculative static run of the fused
    train+adjust and match the two-call (train -> adjust) sequence."""
    import jax.numpy as jnp

    from xsdba_tpu.models._algos import (
        eqm_train_adjust_windowed,
        eqm_train_windowed,
        qm_adjust_core,
    )
    from xsdba_tpu.models._wrap import device_brackets
    from xsdba_tpu.ops.correction import equally_spaced_nodes

    t = date_range("2001-01-01", periods=365 * 2, freq="D", calendar="noleap")
    gi = Grouper("5D", window=3).indexes(t)
    rng = np.random.default_rng(13)
    T = len(t)
    ref = np.asarray(rng.normal(10, 2, (3, T)))
    ref[0, 40:160] = np.nan
    ref[2, :] = np.nan
    ref = jnp.asarray(ref)
    hist = jnp.asarray(rng.normal(12, 3, (3, T)))
    sim = jnp.asarray(rng.normal(13, 3, (3, T)))
    q = jnp.asarray(equally_spaced_nodes(5).astype(np.float64))
    br = device_brackets(gi, "linear")

    scen, af, hq = eqm_train_adjust_windowed(ref, hist, sim, gi.merge_plan, q, br, kind="+")
    af2, hq2 = eqm_train_windowed(ref, hist, gi.merge_plan, q, kind="+")
    scen2 = qm_adjust_core(sim, hq2, af2, br, kind="+", interp="linear", extrapolation="constant")
    np.testing.assert_allclose(np.asarray(af), np.asarray(af2), rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(np.asarray(scen), np.asarray(scen2), rtol=1e-12, equal_nan=True)
    # second call takes the no-speculation branch (plan hint now False)
    scen3, _, _ = eqm_train_adjust_windowed(ref, hist, sim, gi.merge_plan, q, br, kind="+")
    np.testing.assert_allclose(np.asarray(scen3), np.asarray(scen2), rtol=1e-12, equal_nan=True)


def test_ocean_mask_rides_static_path():
    """All-NaN site rows (ocean-masked production grids) are static-safe:
    the probe accepts them, the static strip extraction masks them to NaN,
    and values match the exact gather oracle.  Partial-NaN rows still take
    the dynamic path."""
    import jax.numpy as jnp

    from xsdba_tpu.ops.correction import equally_spaced_nodes
    from xsdba_tpu.ops.quantile import (
        _PLAN_FINITE_HINT,
        _finite_probe,
        grouped_nan_quantile,
        windowed_group_quantile,
    )

    rng = np.random.default_rng(7)
    t = date_range("2000-01-01", periods=365 * 4, freq="D", calendar="noleap")
    gi = Grouper("time.dayofyear", window=11).indexes(t)
    x = rng.normal(0, 1, (4, len(t)))
    x[2, :] = np.nan
    x[3, :] = np.nan
    q = equally_spaced_nodes(7)

    assert bool(_finite_probe(jnp.asarray(x)))  # homogeneous rows: static-safe
    assert not bool(_finite_probe(jnp.asarray(np.where(np.arange(len(t)) < 50, np.nan, x[:1]))))

    # engine="merge" pins the MERGE backend: the probe/static-extraction pair
    # under test is merge-path machinery (the selection backend, the
    # default when the plan has interval membership, needs no probe)
    got = np.asarray(
        windowed_group_quantile(jnp.asarray(x), gi.merge_plan, jnp.asarray(q), engine="merge")
    )
    assert _PLAN_FINITE_HINT.get(gi.merge_plan) is True  # stayed on the fast path
    assert np.isnan(got[2]).all() and np.isnan(got[3]).all()
    want = np.asarray(grouped_nan_quantile(jnp.asarray(x), gi.gather_idx, jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_ocean_mask_fused_train_adjust():
    """Fused windowed train+adjust with an ocean-masked ref site: the masked
    static path must match the two-call sequence (NaN af -> NaN scen for the
    masked site; finite sites unaffected)."""
    import jax.numpy as jnp

    from xsdba_tpu.models._algos import (
        eqm_train_adjust_windowed,
        eqm_train_windowed,
        qm_adjust_core,
    )
    from xsdba_tpu.models._wrap import device_brackets
    from xsdba_tpu.ops.correction import equally_spaced_nodes

    t = date_range("2001-01-01", periods=365 * 2, freq="D", calendar="noleap")
    gi = Grouper("5D", window=3).indexes(t)
    rng = np.random.default_rng(17)
    T = len(t)
    ref = np.asarray(rng.normal(10, 2, (3, T)))
    ref[1, :] = np.nan  # ocean site
    ref = jnp.asarray(ref)
    hist = np.asarray(rng.normal(12, 3, (3, T)))
    hist[1, :] = np.nan
    hist = jnp.asarray(hist)
    sim = jnp.asarray(rng.normal(13, 3, (3, T)))
    q = jnp.asarray(equally_spaced_nodes(5).astype(np.float64))
    br = device_brackets(gi, "linear")

    scen, af, hq = eqm_train_adjust_windowed(ref, hist, sim, gi.merge_plan, q, br, kind="+")
    af2, hq2 = eqm_train_windowed(ref, hist, gi.merge_plan, q, kind="+")
    scen2 = qm_adjust_core(sim, hq2, af2, br, kind="+", interp="linear", extrapolation="constant")
    assert np.isnan(np.asarray(scen[1])).all() and np.isnan(np.asarray(af[1])).all()
    np.testing.assert_allclose(np.asarray(scen), np.asarray(scen2), rtol=1e-12, equal_nan=True)
    # finite sites must equal a run on finite-only data
    scen_f, _, _ = eqm_train_adjust_windowed(ref[::2], hist[::2], sim[::2], gi.merge_plan, q, br, kind="+")
    np.testing.assert_allclose(np.asarray(scen)[::2], np.asarray(scen_f), rtol=1e-12)


def test_flat_extract_matches_strip_bitexact():
    """The flat constant-index gather must be bit-identical to the strip
    extraction on finite data, including all-NaN (ocean-mask) rows.
    Flipped through the runtime option — the engine choice is a static arg of
    the compiled core, so each setting genuinely traces its own program."""
    from xsdba_tpu import set_options

    t, x = _series("noleap", years=6, n_sites=4, seed=9)
    x = x.astype(np.float32)
    x[1] = np.nan  # one ocean-masked site
    gi = Grouper("time.dayofyear", window=5).indexes(t)
    q = np.linspace(0.02, 0.98, 20).astype(np.float32)

    with set_options(extract_mode="strip"):
        want = np.asarray(windowed_group_quantile(x, gi.merge_plan, q, engine="merge"))
    with set_options(extract_mode="flat"):
        got = np.asarray(windowed_group_quantile(x, gi.merge_plan, q, engine="merge"))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1]).all() and not np.isnan(got[0]).any()
    # the one-hot matmul form (extract_mode="matmul", Precision.HIGHEST) must
    # also be bit-identical (it supersedes both under the mode option)
    with set_options(extract_mode="matmul"):
        got_mm = np.asarray(windowed_group_quantile(x, gi.merge_plan, q, engine="merge"))
    np.testing.assert_array_equal(got_mm, want)
    # and the default ("auto") is the flat gather
    with set_options(extract_mode="auto"):
        got_f = np.asarray(windowed_group_quantile(x, gi.merge_plan, q, engine="merge"))
    np.testing.assert_array_equal(got_f, want)
