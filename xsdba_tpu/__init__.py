"""xsdba_tpu — statistical downscaling and bias adjustment in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
Ouranosinc/xsdba: train/adjust bias-adjustment schemes (quantile mapping and
friends), time grouping lowered to static indexes, processing utilities, and
diagnostics — all as jit-compiled operators over dense ``[site..., time]``
device arrays, sharded over device meshes with ``jax.sharding``.
"""

from .utils.calendar import TimeIndex, date_range
from .utils.container import DataArray, Dataset
from .utils.grouper import Grouper
from .utils.options import get_option, set_options

__version__ = "0.4.0"

__all__ = [
    "DataArray",
    "Dataset",
    "Grouper",
    "TimeIndex",
    "date_range",
    "get_option",
    "set_options",
]


def __getattr__(name):
    # Lazy public API: adjustment classes, processing, detrending.
    # (importlib, not `from . import` — the latter re-enters __getattr__.)
    import importlib

    if name.startswith("_"):
        raise AttributeError(f"module 'xsdba_tpu' has no attribute {name!r}")
    for modname in ("models", "processing", "detrending", "properties", "measures"):
        try:
            mod = importlib.import_module(f".{modname}", __name__)
        except ModuleNotFoundError:
            continue
        if name == modname:
            return mod
        if hasattr(mod, name):
            return getattr(mod, name)
    raise AttributeError(f"module 'xsdba_tpu' has no attribute {name!r}")
