"""Import-path parity of ``xsdba_tpu.utils`` with reference ``xsdba.utils``,
plus semantics of the small host-side helpers."""

import numpy as np
import pytest

import xsdba_tpu.utils as xu
from xsdba_tpu import DataArray, date_range
from xsdba_tpu.utils.grouper import Grouper

# every public helper the reference exposes through xsdba.utils / xsdba.units
REFERENCE_UTILS_NAMES = [
    "add_cyclic_bounds",
    "apply_correction",
    "best_pc_orientation_full",
    "best_pc_orientation_simple",
    "bin_width_estimator",
    "broadcast",
    "copy_all_attrs",
    "ecdf",
    "ensure_longest_doy",
    "eps_cholesky",
    "equally_spaced_nodes",
    "get_clusters",
    "get_clusters_1d",
    "get_correction",
    "get_op",
    "histogram",
    "interp_on_quantiles",
    "invert",
    "map_cdf",
    "map_cdf_1d",
    "optimal_transport",
    "pc_matrix",
    "pint2cfattrs",
    "rand_rot_matrix",
    "random_tiebreak",
    "rank",
    "sort_along_dim",
]


def test_reference_names_resolve():
    missing = [n for n in REFERENCE_UTILS_NAMES if getattr(xu, n, None) is None]
    assert not missing, missing


class TestHelpers:
    def test_get_clusters_1d(self):
        # reference utils.py:788-840 semantics: runs above u2 with a max > u1
        s, e, mp, mv = xu.get_clusters_1d(np.array([0.0, 3, 3, 0, 1, 5, 1, 0, 2, 0]), 4, 0.5)
        np.testing.assert_array_equal(s, [4])
        np.testing.assert_array_equal(e, [6])
        np.testing.assert_array_equal(mp, [5])
        np.testing.assert_array_equal(mv, [5.0])
        # the run [1,2] has max 3 <= u1=4 -> excluded; run [8] max 2 -> excluded

    def test_map_cdf_1d(self):
        x = np.arange(100.0)
        y = np.arange(0.0, 200.0, 2.0)
        got = xu.map_cdf_1d(x, y, 100.0)
        # reference utils.py:35-44 formula: -inf prepended, side="right"
        q = np.searchsorted(np.r_[-np.inf, np.sort(y)], 100.0, side="right") / 101
        assert abs(got - np.nanquantile(x, q)) < 1e-12

    def test_add_cyclic_bounds(self):
        da = DataArray(np.arange(12.0), ("month",), {"month": np.arange(1, 13)}, {}, "x")
        p = xu.add_cyclic_bounds(da, "month", cyclic_coords=False)
        assert p.shape == (14,)
        assert p.data[0] == 11 and p.data[-1] == 0
        assert p.coords["month"][0] == 0 and p.coords["month"][-1] == 13
        pc = xu.add_cyclic_bounds(da, "month", cyclic_coords=True)
        assert pc.coords["month"][0] == 12 and pc.coords["month"][-1] == 1

    def test_random_tiebreak_preserves_order(self):
        rng = np.random.default_rng(0)
        x = np.round(rng.normal(0, 1, 200), 1)  # heavy ties
        da = DataArray(x, ("time",), {"time": date_range("2000-01-01", periods=200, freq="D")}, {}, "x")
        rt = np.asarray(xu.random_tiebreak(da, "time").data)
        assert len(np.unique(rt)) == 200  # ties broken
        # non-tied relative order unchanged: sorting keys agree where x unique
        assert (np.sign(np.subtract.outer(x, x))[np.abs(np.subtract.outer(x, x)) > 1e-9]
                == np.sign(np.subtract.outer(rt, rt))[np.abs(np.subtract.outer(x, x)) > 1e-9]).all()

    def test_ensure_longest_doy_aligns(self):
        rng = np.random.default_rng(1)
        ga = DataArray(rng.normal(0, 1, 365), ("dayofyear",), {"dayofyear": np.arange(1, 366)}, {}, "a")
        gb = DataArray(rng.normal(0, 1, 360), ("dayofyear",), {"dayofyear": np.arange(1, 361)}, {}, "b")

        @xu.ensure_longest_doy
        def diff(x, y):
            assert x.shape == y.shape
            return np.asarray(x.data) - np.asarray(y.data)

        with pytest.warns(UserWarning, match="longest range"):
            d = diff(ga, gb)
        assert d.shape == (365,)

    def test_broadcast_nearest_and_linear(self):
        rng = np.random.default_rng(2)
        t = date_range("2001-01-01", periods=365, freq="D", calendar="standard")
        x = DataArray(rng.normal(0, 1, 365), ("time",), {"time": t}, {}, "x")
        g = Grouper("time.month")
        mu = g.apply("mean", x)
        bt = xu.broadcast(mu, x, group=g, interp="nearest")
        mo = np.asarray(t.month)
        for m in (1, 7, 12):
            np.testing.assert_allclose(np.asarray(bt.data)[mo == m], np.asarray(mu.data)[m - 1])
        bl = np.asarray(xu.broadcast(mu, x, group=g, interp="linear").data)
        assert np.isfinite(bl).all()
        # mid-month (frac == position) hits the group value exactly
        gi = g.indexes(t)
        hit = np.isin(gi.frac_idx, gi.positions)
        if hit.any():
            np.testing.assert_allclose(bl[hit], np.asarray(mu.data)[gi.group_idx[hit]], rtol=1e-12)

    def test_pint2cfattrs(self):
        assert xu.pint2cfattrs("K", is_difference=True) == {"units": "K", "units_metadata": "temperature: difference"}
        assert xu.pint2cfattrs("K", is_difference=False) == {"units": "K", "units_metadata": "temperature: on_scale"}
        assert xu.pint2cfattrs("K")["units_metadata"] == "temperature: unknown"
        assert xu.pint2cfattrs("mm/d") == {"units": "mm/d"}

    def test_copy_all_attrs(self):
        from xsdba_tpu import Dataset

        a = DataArray(np.arange(3.0), ("x",), {}, {"units": "K"}, "a")
        ds = Dataset({"a": a})
        ref = Dataset({"a": a.copy(attrs={"units": "K", "long_name": "temp"})}, )
        ref.attrs["global"] = 1
        xu.copy_all_attrs(ds, ref)
        assert ds.attrs["global"] == 1
        assert ds["a"].attrs["long_name"] == "temp"


def test_profiling_helpers(tmp_path):
    """trace() writes a TensorBoard-loadable capture; timed() syncs with
    block_until_ready and returns (best_seconds, output)."""
    import os

    import jax
    import jax.numpy as jnp

    from xsdba_tpu.utils.profiling import timed, trace

    @jax.jit
    def f(x):
        return jnp.sort(x, axis=-1)

    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 64)))
    d = str(tmp_path / "trace")
    with trace(d):
        f(x).block_until_ready()
    assert sum(len(fs) for _, _, fs in os.walk(d)) > 0
    best, out = timed(f, x, reps=2)
    assert best > 0 and out.shape == (8, 64)


def test_timelonlatseries_attrs_match_reference():
    """tas -> temperature attrs, pr -> precip attrs, anything else raises
    (reference testing/sdba_utils.py:42-57)."""
    from xsdba_tpu.testing import timelonlatseries

    tas = timelonlatseries(np.zeros(5), "tas")
    assert tas.attrs["units"] == "K" and tas.attrs["kind"] == "+"
    pr = timelonlatseries(np.zeros(5), "pr")
    assert pr.attrs["units"] == "kg m-2 s-1" and pr.attrs["kind"] == "*"
    with pytest.raises(ValueError, match="not supported"):
        timelonlatseries(np.zeros(5), "tasmax")


def test_rand_rot_matrix_f64_orthogonal():
    """dtype=float64 must generate AND orthogonalize in f64 (a cast-up f32
    QR is only ~1e-7 orthogonal)."""
    import jax.numpy as jnp

    from xsdba_tpu.ops.rotation import rand_rot_matrix

    R = rand_rot_matrix(6, num=4, dtype=jnp.float64)
    assert R.dtype == jnp.float64
    err = float(jnp.max(jnp.abs(R @ jnp.swapaxes(R, -1, -2) - jnp.eye(6, dtype=R.dtype))))
    assert err < 1e-12


def test_sel_list_missing_label_raises():
    da = DataArray(
        np.arange(6.0).reshape(2, 3), ("site", "x"),
        {"site": np.array(["a", "b"]), "x": np.arange(3)}, {}, "v",
    )
    got = da.sel(site=["b", "a"])
    np.testing.assert_array_equal(np.asarray(got.data), [[3, 4, 5], [0, 1, 2]])
    with pytest.raises(KeyError, match="not found"):
        da.sel(site=["a", "zzz"])


def test_to_xarray_dataset_branch(monkeypatch):
    """to_xarray on a Dataset must take the Dataset branch (it has no
    .coords); exercised against a stub xarray module (none is installed)."""
    import sys
    import types

    from xsdba_tpu.utils.container import Dataset, to_xarray

    fake = types.ModuleType("xarray")

    class FakeDA:
        def __init__(self, data=None, dims=None, coords=None, attrs=None, name=None):
            self.data, self.dims, self.coords, self.attrs, self.name = data, dims, coords, attrs, name

    class FakeDS:
        def __init__(self, data_vars, attrs=None):
            self.data_vars, self.attrs = data_vars, attrs

    fake.DataArray, fake.Dataset = FakeDA, FakeDS
    monkeypatch.setitem(sys.modules, "xarray", fake)

    da = DataArray(np.arange(3.0), ("x",), {"x": np.arange(3)}, {"units": ""}, "v")
    out = to_xarray(Dataset({"v": da}, attrs={"k": 1}))
    assert isinstance(out, FakeDS) and out.attrs == {"k": 1}
    assert isinstance(out.data_vars["v"], FakeDA)
    np.testing.assert_array_equal(out.data_vars["v"].data, np.arange(3.0))


def test_set_options_global_visible_across_threads():
    """A main-thread global set_options must be visible in worker threads
    (the reference's OPTIONS dict is process-global)."""
    from concurrent.futures import ThreadPoolExecutor

    from xsdba_tpu.utils.options import EXTRA_OUTPUT, get_option, set_options

    assert get_option(EXTRA_OUTPUT) is False
    with set_options(extra_output=True):
        with ThreadPoolExecutor(max_workers=1) as pool:
            assert pool.submit(get_option, EXTRA_OUTPUT).result() is True
    assert get_option(EXTRA_OUTPUT) is False
