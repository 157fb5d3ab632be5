"""Triton-route table-lookup kernel vs its XLA reference (interpret mode on
the CPU; the compiled kernel runs on the card in ``chip_smoke.py``)."""

import numpy as np
import pytest

from xsdba_tpu.ops.interp import _compact_nan_pairs, _interp_unrolled
from xsdba_tpu.ops.pallas import interp_rows


def _tables(random, lead, nq):
    import jax.numpy as jnp

    xs = np.sort(random.normal(0, 2, lead + (nq,)), axis=-1)
    ys = random.normal(0, 1, lead + (nq,))
    # NaN pairs in some tables
    rows_x, rows_y = xs.reshape(-1, nq), ys.reshape(-1, nq)  # views
    rows_x[min(3, len(rows_x) - 1), 5] = np.nan
    rows_y[1, 7] = np.nan
    return _compact_nan_pairs(jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32))


def test_interp_kernel_matches_xla(random):
    """Row layout [R, L] with one table per row, including a single-pair
    table, an empty table and NaN values."""
    import jax.numpy as jnp

    R, L, nq = 6, 300, 20
    xsc, ysc, nv = _tables(random, (R,), nq)
    nv = nv.at[4].set(1).at[5].set(0)
    v = random.normal(size=(R, L)) * 2
    v[2, 10] = np.nan
    vj = jnp.asarray(v, jnp.float32)
    want = np.asarray(_interp_unrolled(vj, xsc, ysc, nv, "linear", "constant"))
    got = np.asarray(interp_rows(vj, xsc, ysc, nv, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6, equal_nan=True)


def test_interp_kernel_3d_matches_xla(random):
    """Partition layout [B, Gp, Lp] (the wired adjust-path call)."""
    import jax.numpy as jnp

    B, Gp, Lp, nq = 4, 16, 96, 13
    xsc, ysc, nv = _tables(random, (B, Gp), nq)
    v = random.normal(0, 3, (B, Gp, Lp))
    v[2, 5, 10] = np.nan
    vj = jnp.asarray(v, jnp.float32)
    want = np.asarray(_interp_unrolled(vj, xsc, ysc, nv, "linear", "constant"))
    got = np.asarray(interp_rows(vj, xsc, ysc, nv, interpret=True))
    # fp-identical up to FMA fusion differences (1-2 ulp f32)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6, equal_nan=True)


def test_interp_kernel_masked_tail_and_broadcast_tables(random):
    """Rows longer than one 1024-value block with a ragged tail, and tables
    shared across the leading batch dim (QDM's quantile nodes)."""
    import jax.numpy as jnp

    B, Gp, Lp, nq = 2, 3, 1100, 9
    xsc, ysc, nv = _tables(random, (1, Gp), nq)
    vj = jnp.asarray(random.normal(0, 3, (B, Gp, Lp)), jnp.float32)
    want = np.asarray(_interp_unrolled(vj, xsc, ysc, nv, "linear", "constant"))
    got = np.asarray(interp_rows(vj, xsc, ysc, nv, interpret=True))
    assert got.shape == (B, Gp, Lp)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6, equal_nan=True)


@pytest.mark.gpu
def test_interp_kernel_compiled_on_card(gpu, random):
    """The kernel as compiled for the card, at the heavy cell's regular
    layout width, against the XLA form."""
    import jax.numpy as jnp

    B, Gp, Lp, nq = 8, 365, 150, 50
    xsc, ysc, nv = _tables(random, (B, Gp), nq)
    vj = jnp.asarray(random.normal(0, 3, (B, Gp, Lp)), jnp.float32)
    want = np.asarray(_interp_unrolled(vj, xsc, ysc, nv, "linear", "constant"))
    got = np.asarray(interp_rows(vj, xsc, ysc, nv))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6, equal_nan=True)
