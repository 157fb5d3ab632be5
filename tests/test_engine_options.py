"""Runtime engine options (``set_options`` / env vars) — VERDICT r4 #4.

Every windowed-quantile engine choice must be flippable at runtime through
``set_options`` with no source edit, and both settings of each flip must
agree on the same inputs (bit-identical where the engines share extraction
arithmetic, ulp-level across the static-gamma FMA boundary — see the
precision note on ``windowed_group_quantile``).  Reference options pattern:
``xsdba/options.py:28-83``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xsdba_tpu import set_options
from xsdba_tpu.options import OPTIONS
from xsdba_tpu.ops.correction import equally_spaced_nodes
from xsdba_tpu.ops.quantile import windowed_group_quantile
from xsdba_tpu.ops.selquant import selection_ok, selection_windowed_quantile
from xsdba_tpu.utils.calendar import date_range
from xsdba_tpu.utils.grouper import Grouper


def _problem(years=6, n_sites=4, window=31, seed=11):
    t = date_range("1980-01-01", periods=365 * years, freq="D", calendar="noleap")
    gi = Grouper("time.dayofyear", window=window).indexes(t)
    rng = np.random.default_rng(seed)
    x = rng.normal(10, 3, (n_sites, len(t))).astype(np.float32)
    x[0, ::17] = np.nan  # partial-NaN row exercises the dynamic/NaN paths
    q = equally_spaced_nodes(20).astype(np.float32)
    return gi, x, q


def test_selection_backend_option_flip():
    """selection_backend=False must route to the merge path; both engines
    agree to ulp on identical inputs, flipped purely through the option."""
    gi, x, q = _problem()
    plan = gi.merge_plan
    with set_options(selection_backend=True):
        assert selection_ok(plan, q)  # CPU test env: selection is the default
        a = np.asarray(windowed_group_quantile(x, plan, q))
    with set_options(selection_backend=False):
        assert not selection_ok(plan, q)
        b = np.asarray(windowed_group_quantile(x, plan, q))
    np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6, equal_nan=True)


def test_selection_mode_option_bit_identical():
    """emit and gather extraction engines are bit-identical; the ``auto``
    default resolves to the platform's engine."""
    gi, x, q = _problem(window=5)
    plan = gi.merge_plan
    xj = jnp.asarray(x)
    with set_options(selection_mode="emit"):
        a = np.asarray(selection_windowed_quantile(xj, plan, q))
    with set_options(selection_mode="gather"):
        b = np.asarray(selection_windowed_quantile(xj, plan, q))
    with set_options(selection_mode="auto"):
        c = np.asarray(selection_windowed_quantile(xj, plan, q))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_extract_mode_option_bit_identical():
    """strip / flat / matmul static extraction engines, flipped through the
    option, must be bit-identical; ``auto`` is the flat gather."""
    gi, x, q = _problem(window=5, seed=23)
    x = np.where(np.isnan(x), 1.0, x).astype(np.float32)  # static path: finite
    plan = gi.merge_plan
    outs = {}
    with set_options(selection_backend=False):
        for mode in ("strip", "flat", "matmul"):
            with set_options(extract_mode=mode):
                outs[mode] = np.asarray(windowed_group_quantile(x, plan, q))
        with set_options(extract_mode="auto"):
            outs["auto"] = np.asarray(windowed_group_quantile(x, plan, q))
    for k in ("flat", "matmul", "auto"):
        np.testing.assert_array_equal(outs[k], outs["strip"], err_msg=k)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_windowed_engine_chosen_by_platform(monkeypatch, backend):
    """The windowed-quantile engine is a function of the platform (the
    measured winner on each), overridable only through the engine options;
    plans without interval membership take the merge engine everywhere."""
    import jax

    from xsdba_tpu.ops.quantile import windowed_engine

    gi, _, q = _problem(window=5)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert windowed_engine(gi.merge_plan, q) == "gather"
    with set_options(selection_mode="emit"):
        assert windowed_engine(gi.merge_plan, q) == "emit"
    with set_options(selection_backend=False):
        assert windowed_engine(gi.merge_plan, q) == "merge"
    t = date_range("1980-01-01", periods=366 * 4, freq="D", calendar="standard")
    leap = Grouper("time.dayofyear", window=31).indexes(t).merge_plan
    assert windowed_engine(leap, q) == "merge"


def test_table_lookup_chosen_by_platform(monkeypatch):
    """The partitioned table lookup takes the Triton kernel only on the GPU,
    and only for the linear / constant f32 case it implements."""
    import jax

    from xsdba_tpu.ops.interp import use_triton_kernel

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert use_triton_kernel("linear", "constant", 50, jnp.float32)
    assert not use_triton_kernel("cubic", "constant", 50, jnp.float32)
    assert not use_triton_kernel("nearest", "constant", 50, jnp.float32)
    assert not use_triton_kernel("linear", "nan", 50, jnp.float32)
    assert not use_triton_kernel("linear", "constant", 50, jnp.float64)
    assert not use_triton_kernel("linear", "constant", 200, jnp.float32)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not use_triton_kernel("linear", "constant", 50, jnp.float32)


def test_main_path_imports_no_tpu_kernel():
    """A windowed EQM train + adjust and a QDM monthly step import no Mosaic
    TPU module (nothing in the package can reach one)."""
    import sys

    from xsdba_tpu import DataArray, EmpiricalQuantileMapping, QuantileDeltaMapping

    t = date_range("1990-01-01", periods=365 * 3, freq="D", calendar="noleap")
    rng = np.random.default_rng(4)
    mk = lambda v: DataArray(v, ("time",), {"time": t}, {"units": "K"}, "tas")
    ref, hist = mk(rng.normal(280, 3, len(t))), mk(rng.normal(282, 4, len(t)))
    eqm = EmpiricalQuantileMapping.train(
        ref, hist, group=Grouper("time.dayofyear", window=31), nquantiles=15
    )
    assert np.isfinite(np.asarray(eqm.adjust(hist).data)).all()
    qdm = QuantileDeltaMapping.train(ref, hist, group="time.month", nquantiles=15)
    assert np.isfinite(np.asarray(qdm.adjust(hist, interp="linear").data)).all()
    # the Mosaic TPU lowering (every TPU Pallas module imports it)
    mosaic = [m for m in sys.modules if m.split(".")[:4] == ["jax", "_src", "pallas", "mosaic"]]
    assert not mosaic, mosaic


def test_option_validation_and_view():
    with pytest.raises(ValueError, match="Invalid value"):
        set_options(selection_mode="bogus")
    with pytest.raises(ValueError, match="Unknown options"):
        set_options(selection_banckend=True)
    assert "selection_backend" in OPTIONS
    with set_options(selection_backend=False):
        assert OPTIONS["selection_backend"] is False
    assert OPTIONS["selection_backend"] is True


def test_env_var_default(monkeypatch):
    """Process defaults come from XSDBA_* env vars (no source edit needed).

    Tests the env parsing directly (a module reload would fork the option
    stack out from under modules that bound it at import)."""
    from xsdba_tpu.utils.options import _env_bool

    assert _env_bool("XSDBA_NOT_SET_ANYWHERE", True) is True
    assert _env_bool("XSDBA_NOT_SET_ANYWHERE", False) is False
    for raw, want in [("0", False), ("false", False), ("off", False),
                      ("1", True), ("true", True), ("ON", True)]:
        monkeypatch.setenv("XSDBA_SELECTION_BACKEND_TESTVAR", raw)
        assert _env_bool("XSDBA_SELECTION_BACKEND_TESTVAR", True) is want, raw
