"""Test configuration: run on a virtual 8-device CPU mesh with float64 enabled.

Mirrors the reference's dask-parity strategy (SURVEY §4): sharded-vs-single
parity replaces chunked-vs-numpy parity; float64 on CPU gives reference-grade
numerics for parity checks while the library stays dtype-generic for f32 on
the card.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# the CPU unless JAX_PLATFORMS names another platform (the card-only tests:
# JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: the suite is compile-bound on CPU (hundreds of
# small jits); caching executables across runs cuts iteration wall time.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import compile_cache  # noqa: E402

compile_cache.enable(jax, min_compile_secs=0.3)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def random():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Tests marked ``gpu`` need the card: they skip unless JAX's default
    device is a GPU (decided here, at run time, never at import)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (on the card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")
    return devs


@pytest.fixture
def timeseries():
    """Factory for synthetic daily series (analogue of reference
    testing/helpers.py:48-113)."""
    from xsdba_tpu.utils.calendar import date_range

    def _make(values, start="2000-01-01", freq="D", calendar="standard", units=None, name="tas"):
        from xsdba_tpu import DataArray

        values = np.asarray(values)
        time = date_range(start, periods=values.shape[-1], freq=freq, calendar=calendar)
        attrs = {"units": units} if units else {}
        return DataArray(values, dims=("time",) if values.ndim == 1 else tuple(f"d{i}" for i in range(values.ndim - 1)) + ("time",), coords={"time": time}, attrs=attrs, name=name)

    return _make
