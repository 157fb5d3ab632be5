"""Deterministic randomness.

The reference uses the unseeded global numpy RNG (jitter, adapt_freq, OTC,
rotation matrices).  Under jit randomness must be explicit: this module keeps a
process-global JAX PRNG key that ops split from.  Reproducibility is the
default (seed 0); call :func:`seed` to change it — the reference's own tests
seed numpy the same way.
"""

from __future__ import annotations

import jax

__all__ = ["next_key", "seed"]

_state = {"key": None}  # created lazily: a key at import time would
# initialize the JAX backend as a side effect of `import xsdba_tpu`,
# before the user can configure platform or x64


def seed(s: int) -> None:
    """Seed the global PRNG stream."""
    _state["key"] = jax.random.key(s)


def next_key():
    """Return a fresh subkey (splits the global key; seed 0 on first use)."""
    if _state["key"] is None:
        _state["key"] = jax.random.key(0)
    _state["key"], sub = jax.random.split(_state["key"])
    return sub
