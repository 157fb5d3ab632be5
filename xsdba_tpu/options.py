"""Alias module mirroring the reference's ``xsdba.options`` import path."""

from .utils.options import (  # noqa: F401
    AS_DATASET,
    EXTRA_OUTPUT,
    EXTRACT_FLAT,
    EXTRACT_MODE,
    OPTIONS,
    SELECTION_BACKEND,
    SELECTION_MODE,
    get_option,
    set_options,
)
