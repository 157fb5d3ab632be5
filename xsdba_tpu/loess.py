"""Alias module mirroring the reference's ``xsdba.loess`` import path.

The kernel lives in :mod:`xsdba_tpu.ops.loess` (exact windowed form plus an
O(n log n) FFT-convolution interior for equal spacing; reference
loess.py:50-260's per-point numba loop re-designed as batched array code).
"""

from .ops.loess import loess_smoothing  # noqa: F401
