"""Hand-written GPU kernels (Pallas, Triton route), each kept only while it
beats the plain XLA form end to end on the card (PERF.md)."""

from .interp import interp_rows

__all__ = ["interp_rows"]
