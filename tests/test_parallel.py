"""Sharded-vs-single-device parity — the device analogue of the reference's
dask-parity tests (SURVEY §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from xsdba_tpu.parallel.mesh import SITE_AXIS, shard_sites, site_mesh, site_sharding


@pytest.fixture
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return site_mesh(jax.devices()[:8])


def _problem(n_sites=16, n_years=2):
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import _example_problem

    return _example_problem(n_sites=n_sites, n_years=n_years, dtype=np.float64)


def test_mesh_construction(mesh):
    assert mesh.axis_names == (SITE_AXIS,)
    assert mesh.devices.size == 8


def test_sharded_qdm_matches_unsharded(mesh):
    from functools import partial

    from xsdba_tpu.models._algos import qdm_train_adjust_core

    args = _problem()
    fn = partial(qdm_train_adjust_core.__wrapped__, kind="+", interp="linear", extrapolation="constant")

    # unsharded
    want = np.asarray(jax.jit(fn)(*args))

    # sharded over sites
    data_sharding = site_sharding(mesh, 2)
    repl = NamedSharding(mesh, P())
    ref, hist, sim, *rest = args
    ref_s, hist_s, sim_s = (jax.device_put(a, data_sharding) for a in (ref, hist, sim))
    rest_s = tuple(jax.device_put(a, repl) for a in rest)
    with mesh:
        got = jax.jit(fn, out_shardings=data_sharding)(ref_s, hist_s, sim_s, *rest_s)
        got.block_until_ready()
    assert got.sharding.spec[0] == SITE_AXIS
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_sharded_windowed_eqm_matches_unsharded(mesh):
    """The heavy production config (doy+31-window EQM, fused train+adjust)
    is pure site-data-parallelism: sharded output must match unsharded."""
    from xsdba_tpu.models._algos import eqm_train_adjust_windowed
    from xsdba_tpu.models._wrap import device_brackets
    from xsdba_tpu.ops.correction import equally_spaced_nodes
    from xsdba_tpu.utils.calendar import date_range
    from xsdba_tpu.utils.grouper import Grouper

    n_sites, n_years = 8, 2
    t = date_range("1950-01-01", periods=365 * n_years, freq="D", calendar="noleap")
    gi = Grouper("time.dayofyear", window=31).indexes(t)
    rng = np.random.default_rng(7)
    T = len(t)
    ref = jnp.asarray(rng.normal(10, 2, (n_sites, T)))
    hist = jnp.asarray(rng.normal(12, 3, (n_sites, T)))
    sim = jnp.asarray(rng.normal(13, 3, (n_sites, T)))
    q = jnp.asarray(equally_spaced_nodes(10).astype(np.float64))
    br = device_brackets(gi, "linear")

    want, _, _ = eqm_train_adjust_windowed(ref, hist, sim, gi.merge_plan, q, br, kind="+")
    want = np.asarray(want)

    ds = site_sharding(mesh, 2)
    ref_s, hist_s, sim_s = (jax.device_put(a, ds) for a in (ref, hist, sim))
    with mesh:
        got, _, _ = eqm_train_adjust_windowed(ref_s, hist_s, sim_s, gi.merge_plan, q, br, kind="+")
        got.block_until_ready()
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_shard_sites_layout(mesh):
    x = jnp.arange(8.0 * 10).reshape(8, 10)
    xs = shard_sites(x, mesh)
    assert xs.sharding.spec[0] == SITE_AXIS
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(x))


def test_graft_dryrun():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    g.dryrun_multichip(8)


def test_graft_dryrun_explicit_devices():
    """The site-mesh parts take the device list they run on (the four-card
    smoke passes four GPUs): here four virtual CPU devices, passed in."""
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    g.dryrun_multichip(4, devices=jax.devices()[:4])


def test_graft_entry_compiles():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[0].shape
    assert bool(jnp.isfinite(out).any())


@pytest.mark.slow
@pytest.mark.parametrize("n", [2, 4])
def test_graft_dryrun_other_sizes(n):
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    if len(jax.devices()) < n:
        pytest.skip("not enough devices")
    g.dryrun_multichip(n)


def test_sharded_pairwise_corr_matches_corrcoef():
    """The all_gather spatial-diagnostics pattern: sharded pairwise Pearson
    correlation equals np.corrcoef on the 8-device CPU mesh."""
    import jax
    import jax.numpy as jnp

    from xsdba_tpu.parallel.mesh import sharded_pairwise_corr, shard_sites, site_mesh

    rng = np.random.default_rng(9)
    S, T = 16, 300
    x = rng.normal(0, 1, (S, T))
    mesh = site_mesh(jax.devices()[:8])
    xs = shard_sites(jnp.asarray(x), mesh)
    with mesh:
        c = sharded_pairwise_corr(xs, mesh)
        c.block_until_ready()
    np.testing.assert_allclose(np.asarray(c), np.corrcoef(x), rtol=1e-10, atol=1e-12)


def test_sharded_first_eof_matches_serial():
    """The psum-Gram spatial-diagnostics pattern: site-sharded leading EOF
    equals the serial first_eof_pattern (incl. an all-NaN site and a
    scattered missing entry)."""
    import jax
    import jax.numpy as jnp

    from xsdba_tpu.ops.pca import first_eof_pattern
    from xsdba_tpu.parallel.mesh import sharded_first_eof, shard_sites, site_mesh

    rng = np.random.default_rng(13)
    S, T = 64, 40
    x = rng.normal(10, 2, (S, T))
    x[5] = np.nan          # ocean site
    x[17, 3] = np.nan      # missing sample
    mesh = site_mesh(jax.devices()[:8])
    xs = shard_sites(jnp.asarray(x), mesh)
    with mesh:
        v, frac = sharded_first_eof(xs, mesh)
        v.block_until_ready()

    finite = np.isfinite(x)
    nn = np.maximum(finite.sum(axis=1, keepdims=True), 1)
    mean = np.where(finite, x, 0.0).sum(axis=1, keepdims=True) / nn
    anom = np.where(finite, x - mean, np.nan).T  # [T, S]
    want_v, want_frac = first_eof_pattern(jnp.asarray(anom))
    np.testing.assert_allclose(np.asarray(v), np.asarray(want_v), rtol=1e-9, atol=1e-12)
    assert float(frac) == pytest.approx(float(want_frac), rel=1e-10)
