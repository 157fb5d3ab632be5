"""Per-row quantile-table lookup as a Pallas kernel on the Triton route.

The adjust-time lookup in partition layout — values [..., L] where every row
has its own monotone table (xs, ys) [..., nq] — runs once per QM adjust.
XLA compiles ``ops.interp._interp_unrolled`` (the same arithmetic, and this
kernel's reference) into fusions that, inside the fused QDM train+adjust
program, cost several times this kernel (PERF.md).  Here one program takes
one table row and a power-of-two block of that row's values: the table
entries are scalar loads, the locate (summed comparisons) and the bound
selection stay in registers, and the values are read once and written once;
the row's tail block is masked.

Semantics: ``method='linear'``, ``extrap='constant'`` on compacted tables
(NaN pairs pre-sorted to +inf, per-row valid counts); values equal the XLA
form's (tests/test_pallas.py, interpret mode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["interp_rows"]


def _body(v, xk, yk, nv, nq: int):
    """Locate + select + lerp for values ``v`` [TL] against the table whose
    k-th entries ``xk(k)``/``yk(k)`` are scalars, ``nv`` valid."""
    inf = jnp.float32(jnp.inf)
    cnt = jnp.zeros(v.shape, dtype=jnp.int32)
    for k in range(nq):
        cnt = cnt + (xk(k) <= v).astype(jnp.int32)
    k0 = jnp.clip(cnt - 1, 0, jnp.maximum(nv - 2, 0))
    last = jnp.clip(nv - 1, 0, nq - 1)

    x0 = jnp.zeros_like(v)
    x1 = jnp.zeros_like(v)
    y0 = jnp.zeros_like(v)
    y1 = jnp.zeros_like(v)
    x_last = jnp.zeros_like(v)
    y_last = jnp.zeros_like(v)
    for k in range(nq):
        xv = xk(k)
        yv = yk(k)
        m0 = k0 == k
        x0 = jnp.where(m0, xv, x0)
        y0 = jnp.where(m0, yv, y0)
        if k < nq - 1:
            x1 = jnp.where(m0, xk(k + 1), x1)
            y1 = jnp.where(m0, yk(k + 1), y1)
        else:
            x1 = jnp.where(m0, inf, x1)
            y1 = jnp.where(m0, yv, y1)
        ml = last == k
        x_last = jnp.where(ml, xv, x_last)
        y_last = jnp.where(ml, yv, y_last)

    # a single-valid-pair table pairs y0 with the NaN pad slot (x != x: NaN)
    y1 = jnp.where(y1 != y1, y0, y1)
    dx = x1 - x0
    t = jnp.where(dx > 0, (v - x0) / jnp.where(dx == 0, 1.0, dx), 0.0)
    t = jnp.where(jnp.abs(t) < inf, t, 0.0)
    out = y0 + t * (y1 - y0)
    out = jnp.where(v < xk(0), yk(0), out)
    out = jnp.where(v > x_last, y_last, out)
    out = jnp.where(nv == 0, jnp.float32(jnp.nan), out)
    return jnp.where(v != v, jnp.float32(jnp.nan), out)


def _kernel(v_ref, xs_ref, ys_ref, nv_ref, o_ref, *, nq: int, tl: int):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    r = pl.program_id(0)
    cols = pl.program_id(1) * tl + jnp.arange(tl)
    mask = cols < v_ref.shape[1]
    v = plt.load(v_ref.at[r, cols], mask=mask, other=0.0)
    out = _body(v, lambda k: xs_ref[r, k], lambda k: ys_ref[r, k], nv_ref[r], nq)
    plt.store(o_ref.at[r, cols], out, mask=mask)


@functools.partial(jax.jit, static_argnames=("interpret",))
def interp_rows(v, xs, ys, nvalid, interpret: bool = False):
    """v [..., L] f32; xs/ys [..., nq] compacted per-row tables and nvalid
    [...] (leading dims broadcastable to v's) -> [..., L].

    Linear interpolation, constant extrapolation.  Grid: one program per
    (row, block of ``min(1024, next_pow2(L))`` values)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    lead = v.shape[:-1]
    L = v.shape[-1]
    nq = xs.shape[-1]
    R = 1
    for d in lead:
        R *= d
    x2 = jnp.broadcast_to(xs, lead + (nq,)).reshape(R, nq)
    y2 = jnp.broadcast_to(ys, lead + (nq,)).reshape(R, nq)
    n2 = jnp.broadcast_to(nvalid, lead).reshape(R).astype(jnp.int32)
    tl = min(1024, max(128, pl.next_power_of_2(L)))
    out = pl.pallas_call(
        functools.partial(_kernel, nq=nq, tl=tl),
        out_shape=jax.ShapeDtypeStruct((R, L), v.dtype),
        grid=(R, pl.cdiv(L, tl)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=max(1, min(4, tl // 256)), num_stages=1),
        interpret=interpret,
        name="interp_rows",
    )(v.reshape(R, L), x2, y2, n2)
    return out.reshape(v.shape)
