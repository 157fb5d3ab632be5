"""Counting-selection windowed quantile backend (ops/selquant.py).

The selection path must be bit-identical to the jitted re-sort oracle
(gather + full sort + type-7 lerp, ``grouped_nan_quantile``) — the same
multiset, the same selected order statistics, the same virtual-index/lerp
arithmetic.  Reference semantics: rolling-construct + type-7 quantile,
``base.py:261-265`` + ``nbutils.py:113-148``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xsdba_tpu.ops.correction import equally_spaced_nodes
from xsdba_tpu.ops.quantile import grouped_nan_quantile
from xsdba_tpu.ops.selquant import (
    interval_membership,
    selection_windowed_quantile,
)
from xsdba_tpu.utils.calendar import date_range
from xsdba_tpu.utils.grouper import Grouper


def _oracle(gi):
    return jax.jit(lambda xx, qq: grouped_nan_quantile(xx, gi.gather_idx, qq))


def _mk(periods, window, calendar="noleap"):
    t = date_range("1980-01-01", periods=periods, freq="D", calendar=calendar)
    return Grouper("time.dayofyear", window=window).indexes(t)


@pytest.mark.parametrize("window", [5, 31])
@pytest.mark.parametrize("periods", [365 * 6, 365 * 6 + 40])
def test_bit_parity_vs_resort_oracle(window, periods):
    gi = _mk(periods, window)
    plan = gi.merge_plan
    assert plan is not None and plan.sel_labels is not None
    q = equally_spaced_nodes(20).astype(np.float32)
    rng = np.random.default_rng(7)
    oracle = _oracle(gi)
    cases = {
        "finite": rng.normal(10, 3, (4, periods)).astype(np.float32),
        "nan": np.where(
            rng.random((4, periods)) < 0.1, np.nan, rng.normal(10, 3, (4, periods))
        ).astype(np.float32),
        "allnan_row": np.concatenate(
            [np.full((1, periods), np.nan, np.float32),
             rng.normal(0, 1, (3, periods)).astype(np.float32)]
        ),
    }
    for tag, x in cases.items():
        xj = jnp.asarray(x)
        got = np.asarray(selection_windowed_quantile(xj, plan, q))
        want = np.asarray(oracle(xj, jnp.asarray(q)))
        np.testing.assert_array_equal(got, want, err_msg=tag)


def test_bit_parity_f64_and_alpha_beta():
    gi = _mk(365 * 4, 15)
    plan = gi.merge_plan
    q = equally_spaced_nodes(12)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (3, 365 * 4))
    if jax.config.read("jax_enable_x64"):
        x = x.astype(np.float64)
    else:
        x = x.astype(np.float32)
    for a, b in [(1.0, 1.0), (0.4, 0.4), (0.0, 1.0)]:
        oracle = jax.jit(
            lambda xx, qq: grouped_nan_quantile(xx, gi.gather_idx, qq, alpha=a, beta=b)
        )
        got = np.asarray(selection_windowed_quantile(jnp.asarray(x), plan, q, alpha=a, beta=b))
        want = np.asarray(oracle(jnp.asarray(x), jnp.asarray(q, x.dtype)))
        np.testing.assert_array_equal(got, want, err_msg=f"alpha={a} beta={b}")


def test_wb_slots_invariance():
    """Block width, chunking and the emission slot window are tuning knobs,
    never semantics knobs — including slot windows small enough that the
    in-program overflow reroute (lax.cond full-width window) must fire."""
    gi = _mk(365 * 3, 31)
    plan = gi.merge_plan
    q = equally_spaced_nodes(10).astype(np.float32)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(0, 1, (2, 365 * 3)).astype(np.float32))
    want = np.asarray(selection_windowed_quantile(x, plan, q))
    for kw in ({"Wb": 8}, {"Wb": 128}, {"nb_chunk": 16}, {"slots": 1}, {"slots": 64}):
        got = np.asarray(selection_windowed_quantile(x, plan, q, **kw))
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_emit_mode_parity():
    """The dense-emission engine must match the gather engine and
    the re-sort oracle bit for bit, including NaN data and tiny slot windows
    that force the overflow reroute."""
    gi = _mk(365 * 4, 31)
    plan = gi.merge_plan
    q = equally_spaced_nodes(15).astype(np.float32)
    rng = np.random.default_rng(21)
    x = rng.normal(5, 2, (3, 365 * 4)).astype(np.float32)
    x[rng.random(x.shape) < 0.15] = np.nan
    xj = jnp.asarray(x)
    want = np.asarray(_oracle(gi)(xj, jnp.asarray(q)))
    for kw in ({"mode": "emit"}, {"mode": "emit", "slots": 2}, {"mode": "gather"}):
        got = np.asarray(selection_windowed_quantile(xj, plan, q, **kw))
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_unsorted_quantiles_both_modes():
    """q need not be ascending: the emit engine's chunk windows assume sorted
    rank lists, so the core sorts q internally and un-permutes the output.
    Regression for the round-4 review finding (emit mode returned wrong
    values, up to ~17 abs error, for shuffled q)."""
    gi = _mk(365 * 4, 5)
    plan = gi.merge_plan
    rng = np.random.default_rng(33)
    q = equally_spaced_nodes(15).astype(np.float32)
    qs = q.copy()
    rng.shuffle(qs)
    x = rng.normal(5, 2, (3, 365 * 4)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    xj = jnp.asarray(x)
    want = np.asarray(_oracle(gi)(xj, jnp.asarray(qs)))
    for kw in ({"mode": "emit"}, {"mode": "emit", "Wb": 8, "nb_chunk": 4},
               {"mode": "emit", "slots": 2}, {"mode": "gather"}):
        got = np.asarray(selection_windowed_quantile(xj, plan, qs, **kw))
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


def test_concentrated_ties_precip_like():
    """Dry-season-style value concentration (60% exact zeros) stresses the
    emission windows: many members of one group share one sorted run."""
    gi = _mk(365 * 5, 31)
    plan = gi.merge_plan
    q = equally_spaced_nodes(20).astype(np.float32)
    rng = np.random.default_rng(13)
    x = rng.gamma(2.0, 3.0, (3, 365 * 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.6] = 0.0
    got = np.asarray(selection_windowed_quantile(jnp.asarray(x), plan, q))
    want = np.asarray(_oracle(gi)(jnp.asarray(x), jnp.asarray(q)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_randomized_parity_sweep(seed):
    """Seeded fuzz: random window/years/NaN-fraction/quantile-count/engine —
    every draw must stay bit-identical to the re-sort oracle."""
    rng = np.random.default_rng(1000 + seed)
    window = int(rng.choice([3, 5, 9, 15, 31]))
    years = int(rng.integers(2, 7))
    periods = 365 * years + int(rng.integers(0, 200))
    gi = _mk(periods, window)
    plan = gi.merge_plan
    if plan is None or plan.sel_labels is None:
        pytest.skip("no interval membership for this draw")
    nq = int(rng.integers(2, 25))
    q = np.sort(rng.random(nq)).astype(np.float32)
    nan_frac = float(rng.choice([0.0, 0.05, 0.3]))
    x = rng.normal(0, 5, (2, periods)).astype(np.float32)
    if nan_frac:
        x[rng.random(x.shape) < nan_frac] = np.nan
    mode = str(rng.choice(["emit", "gather"]))
    kw = {"mode": mode}
    if rng.random() < 0.5:
        kw["Wb"] = int(rng.choice([16, 32, 64]))
    if rng.random() < 0.5:
        kw["slots"] = int(rng.choice([2, 8, 32]))
    got = np.asarray(selection_windowed_quantile(jnp.asarray(x), plan, q, **kw))
    want = np.asarray(_oracle(gi)(jnp.asarray(x), jnp.asarray(q)))
    np.testing.assert_array_equal(got, want, err_msg=f"{window=} {years=} {nan_frac=} {kw=}")


def test_standard_calendar_declines():
    """Leap calendars skip a doy most years: membership is not an interval."""
    t = date_range("1980-01-01", periods=366 * 4, freq="D", calendar="standard")
    gi = Grouper("time.dayofyear", window=31).indexes(t)
    assert gi.merge_plan is None or gi.merge_plan.sel_labels is None


def test_interval_membership_rejects_duplicates_and_gaps():
    # duplicate entry
    gidx = np.array([[0, 1, 1], [2, 3, -1]], np.int32)
    assert interval_membership(gidx, 2, 4) is None
    # non-interval membership: element 0 in groups {0, 2} of 4
    gidx = np.array([[0, -1], [1, -1], [0, 2], [3, -1]], np.int32)
    assert interval_membership(gidx, 4, 4) is None
    # full-circle membership is an interval
    gidx = np.array([[0, 1], [0, 1], [1, -1]], np.int32)
    iv = interval_membership(gidx, 3, 2)
    assert iv is not None
    start, length = iv
    assert length[0] == 2 and length[1] == 3  # element 1 in all groups


def test_pooled_expand_keeps_labels():
    gi = _mk(365 * 3, 31)
    gx = gi.expand(3)
    assert gx.merge_plan is not None and gx.merge_plan.sel_labels is not None
    q = equally_spaced_nodes(8).astype(np.float32)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(0, 1, (2, 3 * 365 * 3)).astype(np.float32))
    got = np.asarray(selection_windowed_quantile(x, gx.merge_plan, q))
    want = np.asarray(_oracle(gx)(x, jnp.asarray(q)))
    np.testing.assert_array_equal(got, want)
