"""Where the repository's scripts and tests keep JAX's persistent compile cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting: JAX reads it
and nothing here overrides it.  Otherwise the cache goes to the fixed,
gitignored ``<repo>/.jax_cache`` (a fixed path, so later runs find what
earlier ones compiled).  The library itself sets no cache.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO = os.path.dirname(os.path.abspath(__file__))


def cache_dir() -> str:
    """The directory the compile cache lives in for this process."""
    return os.environ.get(ENV) or os.path.join(REPO, ".jax_cache")


def enable(jax, min_compile_secs: float = 1.0) -> str:
    """Turn the persistent cache on for programs that take at least
    ``min_compile_secs`` to compile; returns the cache directory."""
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return cache_dir()
