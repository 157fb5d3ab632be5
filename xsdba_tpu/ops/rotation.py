"""Random rotation matrices — SO(N) via QR (Mezzadri 2007).

Reference ``utils.py:924-974``, with JAX PRNG instead of the global numpy RNG.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.rng import next_key

__all__ = ["rand_rot_matrix"]


@functools.partial(jax.jit, static_argnames=("n", "num", "dtype"))
def _rand_rot_jit(key, *, n: int, num: int, dtype):
    # generate AND orthogonalize in the requested dtype: a float32 QR cast
    # up would only be orthogonal to ~1e-7
    Z = jax.random.normal(key, (num, n, n), dtype=dtype)
    Q, R = jnp.linalg.qr(Z)
    d = jnp.diagonal(R, axis1=-2, axis2=-1)
    lam = d / jnp.abs(d)
    return Q * lam[..., None, :]


def rand_rot_matrix(n: int, num: int = 1, key=None, dtype=jnp.float32):
    """Generate ``num`` random rotation matrices of size n x n.

    Haar-uniform over SO(n): QR of a standard normal matrix with the sign
    fix ``Q · diag(r_ii/|r_ii|)`` (reference utils.py:963-974).  One jitted
    program instead of an eager chain of ~7 dispatches.  Returns [num, n, n] (or [n, n] if num == 1).
    """
    key = next_key() if key is None else key
    out = _rand_rot_jit(key, n=n, num=num, dtype=dtype)
    return out[0] if num == 1 else out
