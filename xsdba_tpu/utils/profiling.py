"""Profiling / tracing helpers (SURVEY §5: the reference ships none — dask
task-name patching was its only observability; here the JAX profiler is the
native tool and these wrappers make it one line).

``trace`` captures a TensorBoard-loadable device trace; ``timed`` measures
the wall time of a callable up to ``block_until_ready`` on its outputs.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["timed", "trace"]


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Capture a JAX profiler trace into ``logdir`` (TensorBoard format).

    >>> with trace("/tmp/xsdba-trace"):
    ...     scen = eqm.adjust(sim)
    """
    import jax

    jax.profiler.start_trace(logdir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, reps: int = 3, warmup: int = 1, **kwargs):
    """Best-of-``reps`` wall time of ``fn(*args, **kwargs)``, synchronized
    with ``block_until_ready`` on every output.

    Returns ``(best_seconds, last_output)``.
    """
    import jax
    import numpy as np

    out = None
    for _ in range(max(warmup, 0)):
        out = jax.block_until_ready(fn(*args, **kwargs))
    best = np.inf
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, out
