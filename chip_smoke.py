"""Smoke test of the train/adjust main path on one GPU (or the site mesh on
four, with ``--four-cards``).

Every phase drives the public API at a realistic size on synthetic data made
from ``--seed``, syncs with ``block_until_ready``, prints the compiled step
core's ``memory_analysis()``, the device's ``peak_bytes_in_use`` and one warm
wall time labelled with the card and its power limit, and then compares the
result with an oracle; a failed comparison raises, so the script exits
non-zero.  The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The script refuses to run (non-zero exit, no result line) when JAX's first
device is not a GPU.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the site mesh on four cards, only
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: sites of each phase compared with the float64 CPU oracle (sites are
#: independent, so a leading subset of the batch is an exact comparison)
ORACLE_SITES = 32
#: tolerances (PERF.md states each with its reason)
TOL_ENGINE_RTOL = 1e-6   # windowed quantiles vs the jitted re-sort oracle, f32
TOL_MERGE_RTOL = 1e-5    # the merge engine's static-gamma deviation, f32
TOL_QM_ATOL = 1e-4       # QDM / EQM scen vs float64 CPU oracle
TOL_NEAREST_FLIPS = 1e-5  # share of nearest-lookup values that may flip node
TOL_MBCN_ATOL = 1e-3     # MBCn scen vs float64 CPU oracle, per-series sorted values
TOL_MBCN_SPEARMAN = 0.999  # MBCn scen vs float64 CPU oracle, time-order rank agreement
TOL_MESH_ATOL = 1e-5     # four-card site mesh vs one card


def log(*parts):
    print(*parts, flush=True)


def require_gpu():
    """JAX's first device, which must be a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX's first device is {dev.platform!r}")
    return dev


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# data and public-API steps
# --------------------------------------------------------------------------


def _times(n_years: int, start: str = "1950-01-01"):
    from xsdba_tpu import date_range

    return date_range(start, periods=365 * n_years, freq="D", calendar="noleap")


def _series(seed: int, shape, mu: float, sd: float) -> np.ndarray:
    """f32 normal draws; the leading rows do not depend on ``shape[0]``, so
    an oracle can regenerate a site subset."""
    return np.random.default_rng(seed).normal(mu, sd, shape).astype(np.float32)


def _da(values, t, dims=("site", "time"), coords=None, units="K"):
    from xsdba_tpu import DataArray

    return DataArray(values, dims, {"time": t, **(coords or {})}, {"units": units}, "tas")


def qdm_monthly(ref, hist, sim, t):
    """QDM monthly, additive, linear interp, through the public API."""
    from xsdba_tpu import QuantileDeltaMapping

    qdm = QuantileDeltaMapping.train(_da(ref, t), _da(hist, t), group="time.month", nquantiles=50)
    return qdm.adjust(_da(sim, t), interp="linear").data


def eqm_doy31(ref, hist, sim, t):
    """EQM doy+31w (``BASELINE.json`` config 1, default nearest lookup)
    through the public API; returns (scen, trained adjustment factors)."""
    from xsdba_tpu import EmpiricalQuantileMapping, Grouper

    eqm = EmpiricalQuantileMapping.train(
        _da(ref, t), _da(hist, t), group=Grouper("time.dayofyear", window=31), nquantiles=50
    )
    return eqm.adjust(_da(sim, t)).data, eqm.ds["af"].data


def eqm_fused(ref, hist, sim, t):
    """The fused EQM doy+31w train+adjust core with linear interp (the
    bench's heavy cell), on finite data."""
    import jax.numpy as jnp

    from xsdba_tpu import Grouper
    from xsdba_tpu.models._algos import eqm_train_adjust_windowed
    from xsdba_tpu.models._wrap import device_brackets
    from xsdba_tpu.ops.correction import equally_spaced_nodes

    gi = Grouper("time.dayofyear", window=31).indexes(t)
    q = jnp.asarray(equally_spaced_nodes(50).astype(np.dtype(ref.dtype)))
    return eqm_train_adjust_windowed(
        ref, hist, sim, gi.merge_plan, q, device_brackets(gi, "linear"),
        kind="+", interp="linear", assume_finite=True,
    )[0]


def mbcn(ref, hist, sim, t, rot):
    """MBCn (``BASELINE.json`` config 4): train with the given rotations,
    then adjust with the default QDM base, through the public API."""
    from xsdba_tpu import MBCn

    mv = {"multivar": np.array(["tasmax", "pr", "huss"])}
    dims = ("site", "multivar", "time")
    obj = MBCn.train(
        _da(ref, t, dims, mv, ""), _da(hist, t, dims, mv, ""),
        base_kws={"nquantiles": 50, "group": "time"}, n_iter=rot.shape[0], rot_matrices=rot,
    )
    return obj.adjust(_da(sim, t, dims, mv, ""), _da(ref, t, dims, mv, ""), _da(hist, t, dims, mv, "")).data


def mbcn_base_step(ref, hist, t):
    """Largest step between neighbouring adjustment factors of MBCn's
    univariate base (QDM, 50 nodes, ``group="time"``) over the variables:
    the bound on one nearest-node flip."""
    from xsdba_tpu import QuantileDeltaMapping

    steps = []
    for iv in range(ref.shape[1]):
        af = QuantileDeltaMapping.train(
            _da(ref[:, iv], t, units=""), _da(hist[:, iv], t, units=""), group="time", nquantiles=50
        ).ds["af"].data
        steps.append(np.nanmax(np.abs(np.diff(np.asarray(af), axis=-1))))
    return max(steps)


def rotations(seed: int, n: int, v: int) -> np.ndarray:
    """``n`` Haar-random v x v rotations (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.normal(size=(v, v)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        out.append(q)
    return np.stack(out).astype(np.float32)


def on_cpu_f64(fn, *arrays, **kw):
    """``fn`` on the CPU backend in float64 (the oracle of every phase).
    Pass a time index of its own: group plans cache device arrays per time
    index, and the card's copies cannot enter a CPU program."""
    import jax

    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        return jax.tree.map(np.asarray, fn(*(np.asarray(a, np.float64) for a in arrays), **kw))


def compare(
    name: str, got, want, atol: float, rtol: float = 0.0, flips: float = 0.0, step: float = 0.0
) -> float:
    """Max abs difference of ``got`` vs ``want``; raises past the tolerance
    or on a NaN pattern mismatch.

    A nearest-node lookup is discontinuous at the midpoints between nodes:
    rounding of the trained nodes can move a value across a midpoint, which
    changes its factor by one step between neighbouring factors.  ``flips``
    is the largest share of values allowed to differ that way, each by at
    most ``step`` (plus the tolerance)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != oracle {want.shape}")
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{name}: NaN pattern differs from the oracle")
    diff = np.abs(np.nan_to_num(got - want))
    tol = atol + rtol * np.abs(np.nan_to_num(want))
    over = diff > tol
    bad = over if not flips else (diff > tol + step)
    n_over = int(over.sum())
    if flips and n_over > flips * diff.size:
        bad = over
    worst = float(diff.max()) if diff.size else 0.0
    extra = f", {n_over} nearest-node flips (<= {flips:g} of values, <= step {step:.3g})" if flips else ""
    log(f"  oracle {name}: max|diff| {worst:.3g} (atol {atol:g}, rtol {rtol:g}{extra}) {'FAIL' if bad.any() else 'ok'}")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values beyond tolerance, max|diff| {worst:.3g}")
    return worst


def compare_reordered(
    name: str, got, want, atol: float, min_spearman: float, flips: float = 0.0, step: float = 0.0
):
    """MBCn's output is the base-adjusted series REORDERED along time by the
    npdft ranks.  The values (per-series multiset) follow the inputs up to
    nearest-node flips (see :func:`compare`; sorting moves no value further
    than the largest single change): compare them sorted.  The order is a
    rank pattern that rounding flips at near-ties: require the per-series
    Spearman correlation of the time orders to reach ``min_spearman``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    compare(
        f"{name} (sorted values)", np.sort(got, axis=-1), np.sort(want, axis=-1), atol,
        flips=flips, step=step,
    )
    rg = np.argsort(np.argsort(got, axis=-1), axis=-1).astype(np.float64)
    rw = np.argsort(np.argsort(want, axis=-1), axis=-1).astype(np.float64)
    n = got.shape[-1]
    rho = 1.0 - 6.0 * ((rg - rw) ** 2).sum(axis=-1) / (n * (n * n - 1.0))
    ok = bool(rho.min() >= min_spearman)
    log(f"  oracle {name} (time order): min Spearman {rho.min():.6f} (>= {min_spearman}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: time-order Spearman {rho.min():.6f} < {min_spearman}")
    return float(rho.min())


# --------------------------------------------------------------------------
# reporting
# --------------------------------------------------------------------------


class Report:
    def __init__(self, card: str):
        self.card = card

    def memory(self, name: str, lowered):
        """``memory_analysis()`` of a step core, compiled for the card."""
        m = lowered.compile().memory_analysis()
        log(
            f"  memory {name}: args {m.argument_size_in_bytes} B, out {m.output_size_in_bytes} B, "
            f"temp {m.temp_size_in_bytes} B, code {m.generated_code_size_in_bytes} B"
        )

    def peak(self):
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        log(f"  peak_bytes_in_use (process so far): {stats.get('peak_bytes_in_use', 'not reported')}")

    def wall(self, name: str, fn, *args, n: int = 1):
        """Median of ``n`` warm calls (the first call, which compiles, is
        not timed); returns the last output."""
        import jax

        out = jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        log(f"  warm wall {name}: {np.median(ts) * 1e3:.3f} ms [{self.card}]")
        return out

    def abba(self, name: str, fns: dict, args, n: int = 5) -> dict:
        """Median ms of each function over ``2n`` warm calls taken in the
        order a b c ... c b a (``n`` calls per visit)."""
        import jax

        for f in fns.values():
            jax.block_until_ready(f(*args))
        names = list(fns)
        times = {k: [] for k in names}
        for k in names + names[::-1]:
            for _ in range(n):
                t0 = time.perf_counter()
                jax.block_until_ready(fns[k](*args))
                times[k].append(time.perf_counter() - t0)
        med = {k: float(np.median(v) * 1e3) for k, v in times.items()}
        log(f"  timing {name} (median ms of {2 * n}, order {' '.join(names + names[::-1])}) [{self.card}]: "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
        return med


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_qdm(rep: Report, n_sites: int, n_years: int, seed: int) -> float:
    """Phase 1: QDM monthly; returns the oracle max|diff|."""
    import jax.numpy as jnp

    from __graft_entry__ import _example_problem
    from xsdba_tpu.models._algos import qdm_train_adjust_core

    log(f"phase 1: QDM monthly, {n_sites} sites x {n_years} yr")
    t = _times(n_years)
    shape = (n_sites, len(t))
    ref, hist, sim = (_series(seed + i, shape, mu, sd) for i, (mu, sd) in enumerate(((10, 2), (12, 3), (13, 3))))
    rj, hj, sj = (jnp.asarray(a) for a in (ref, hist, sim))
    scen = rep.wall(f"QDM train+adjust public API {n_sites}x{n_years}", lambda: qdm_monthly(rj, hj, sj, t))
    assert scen.shape == shape and np.isfinite(np.asarray(scen)).all()
    args = _example_problem(n_sites=n_sites, n_years=n_years)[3:]
    rep.memory(
        "qdm_train_adjust_core",
        qdm_train_adjust_core.lower(rj, hj, sj, *args, kind="+", interp="linear", extrapolation="constant"),
    )
    rep.peak()
    k = min(ORACLE_SITES, n_sites)
    want = on_cpu_f64(qdm_monthly, ref[:k], hist[:k], sim[:k], t=_times(n_years))
    return compare("QDM vs CPU float64", np.asarray(scen)[:k], want, TOL_QM_ATOL)


def phase_eqm(rep: Report, n_sites: int, n_years: int, seed: int, n: int = 5) -> dict:
    """Phase 2: EQM doy+31w through the public API and the fused core, and
    the windowed-quantile engine comparison; returns the engine timings."""
    import jax
    import jax.numpy as jnp

    from xsdba_tpu.ops.correction import equally_spaced_nodes
    from xsdba_tpu.ops.quantile import _windowed_group_quantile_core, grouped_nan_quantile, windowed_engine
    from xsdba_tpu.ops.selquant import _selection_core_jit
    from xsdba_tpu.utils.grouper import Grouper

    log(f"phase 2: EQM doy+31w, {n_sites} sites x {n_years} yr")
    t = _times(n_years)
    shape = (n_sites, len(t))
    ref, hist, sim = (_series(seed + 10 + i, shape, mu, sd) for i, (mu, sd) in enumerate(((10, 2), (12, 3), (13, 3))))
    rj, hj, sj = (jnp.asarray(a) for a in (ref, hist, sim))
    scen, _ = rep.wall(f"EQM train+adjust public API {n_sites}x{n_years}", lambda: eqm_doy31(rj, hj, sj, t))
    assert scen.shape == shape and np.isfinite(np.asarray(scen)).all()

    k = min(ORACLE_SITES, n_sites)
    want, af = on_cpu_f64(eqm_doy31, ref[:k], hist[:k], sim[:k], t=_times(n_years))
    step = float(np.nanmax(np.abs(np.diff(af, axis=-1))))
    compare("EQM vs CPU float64", np.asarray(scen)[:k], want, TOL_QM_ATOL, flips=TOL_NEAREST_FLIPS, step=step)

    fused = jax.jit(lambda r, h, s: eqm_fused(r, h, s, t))
    rep.memory("eqm_train_adjust_windowed (fused core, linear)", fused.lower(rj, hj, sj))
    scen_f = rep.wall("eqm_train_adjust_windowed fused core, linear", fused, rj, hj, sj, n=n)
    want = on_cpu_f64(eqm_fused, ref[:k], hist[:k], sim[:k], t=_times(n_years))
    compare("EQM fused core vs CPU float64", np.asarray(scen_f)[:k], want, TOL_QM_ATOL)

    gi = Grouper("time.dayofyear", window=31).indexes(t)
    plan = gi.merge_plan
    q = jnp.asarray(equally_spaced_nodes(50).astype(np.float32))

    # engine comparison on the stacked (ref, hist) batch, as train runs it
    both = jnp.stack([rj, hj])
    lab = jnp.asarray(plan.sel_labels)
    G = int(plan.fast_mask.shape[0])
    sel = dict(G=G, Wb=64, nb_chunk=128, slots=32, g_chunk=64, alpha=1.0, beta=1.0)
    w1, eid, eg = (jnp.asarray(a) for a in (plan.w1_gather, plan.edge_ids, plan.edge_gather))
    merge = dict(
        half=plan.half, window=plan.window, ypad=plan.ypad, wpad=plan.wpad, dp=plan.dp,
        alpha=1.0, beta=1.0, counts=tuple(int(c) for c in plan.nv_host),
        q_static=tuple(float(v) for v in np.asarray(q, np.float64)),
        edge_tuple=tuple(int(e) for e in plan.edge_ids), regular=plan.regular_period, extract_mode="flat",
    )
    engines = {
        "gather": lambda x: _selection_core_jit(x, lab, q, mode="gather", **sel),
        "emit": lambda x: _selection_core_jit(x, lab, q, mode="emit", **sel),
        "merge": lambda x: _windowed_group_quantile_core(x, w1, eid, eg, q, **merge),
    }
    oracle = jax.jit(lambda x: grouped_nan_quantile(x, gi.gather_idx, q))
    want = np.asarray(oracle(both))
    default = windowed_engine(plan, q)
    log(f"  platform engine: {default}")
    for name, f in engines.items():
        rtol = TOL_MERGE_RTOL if name == "merge" else TOL_ENGINE_RTOL
        compare(f"engine {name} vs jitted re-sort (f32, on card)", f(both), want, 0.0, rtol)
    timing = rep.abba("windowed-quantile engines [2, 256, T] f32", engines, (both,), n=n)
    timing["resort_oracle"] = rep.abba("jitted re-sort oracle", {"resort": oracle}, (both,), n=n)["resort"]
    rep.peak()
    return timing


def phase_mbcn(rep: Report, n_sites: int, n_years: int, n_iter: int, seed: int) -> float:
    """Phase 3: MBCn train + adjust (3 variables); returns the oracle's
    minimum time-order Spearman correlation."""
    import jax.numpy as jnp

    from xsdba_tpu.models.mbcn import _mbcn_train_block
    from xsdba_tpu.ops.correction import equally_spaced_nodes
    from xsdba_tpu.utils.grouper import Grouper

    log(f"phase 3: MBCn, {n_sites} sites x 3 vars x {n_years} yr, {n_iter} rotations")
    t = _times(n_years, "1981-01-01")
    shape = (n_sites, 3, len(t))
    ref, hist, sim = (_series(seed + 20 + i, shape, mu, sd) for i, (mu, sd) in enumerate(((10, 3), (11, 3), (12, 4))))
    rot = rotations(seed + 30, n_iter, 3)
    rj, hj, sj = (jnp.asarray(a) for a in (ref, hist, sim))
    scen = rep.wall(f"MBCn train+adjust public API {n_sites}x3x{n_years}", lambda: mbcn(rj, hj, sj, t, rot))
    assert scen.shape == shape and np.isfinite(np.asarray(scen)).all()
    va, ha = (jnp.moveaxis(a, 1, 0) for a in (rj, hj))
    rep.memory(
        "_mbcn_train_block",
        _mbcn_train_block.lower(
            va, ha, jnp.asarray(Grouper("time").indexes(t).gather_idx), jnp.asarray(rot),
            jnp.asarray(equally_spaced_nodes(50).astype(np.float32)),
            interp="nearest", extrap="constant", n_escore=-1,
        ),
    )
    rep.peak()
    k = min(ORACLE_SITES, n_sites)
    want = on_cpu_f64(mbcn, ref[:k], hist[:k], sim[:k], t=_times(n_years, "1981-01-01"), rot=rot)
    step = float(on_cpu_f64(mbcn_base_step, ref[:k], hist[:k], t=_times(n_years, "1981-01-01")))
    return compare_reordered(
        "MBCn vs CPU float64", np.asarray(scen)[:k], want, TOL_MBCN_ATOL, TOL_MBCN_SPEARMAN,
        flips=TOL_NEAREST_FLIPS, step=step,
    )


def phase_interp(
    rep: Report, seed: int, heavy=(256, 365, 150), headline=(512, 14, 4650), n: int = 5,
    n_years: int = 150, interpret: bool = False,
) -> dict:
    """Phase 4: the Triton table-lookup kernel against ``_interp_unrolled``,
    alone at the real widths and inside the fused QDM step.  ``interpret``
    runs the kernel in Pallas's interpreter (for a CPU rehearsal only)."""
    from unittest import mock

    import jax
    import jax.numpy as jnp

    import xsdba_tpu.ops.interp as interp_mod
    from __graft_entry__ import _example_problem
    from xsdba_tpu.models._algos import qdm_train_adjust_core
    from xsdba_tpu.ops.interp import _interp_unrolled
    from xsdba_tpu.ops.pallas import interp_rows

    log("phase 4: table lookup, Triton kernel vs XLA")
    rng = np.random.default_rng(seed + 40)
    out = {}
    xla = jax.jit(lambda v, x, y, c: _interp_unrolled(v, x, y, c, "linear", "constant"))
    kern = jax.jit(lambda v, x, y, c: interp_rows(v, x, y, c, interpret=interpret))
    for tag, (B, Gp, L) in (("heavy regular layout", heavy), ("headline partition layout", headline)):
        v = jnp.asarray(rng.normal(12, 3, (B, Gp, L)).astype(np.float32))
        xs = jnp.sort(jnp.asarray(rng.normal(12, 3, (B, Gp, 50)).astype(np.float32)), axis=-1)
        ys = jnp.asarray(rng.normal(0, 1, (B, Gp, 50)).astype(np.float32))
        nv = jnp.full((B, Gp), 50, jnp.int32)
        compare(f"interp kernel {tag}", kern(v, xs, ys, nv), xla(v, xs, ys, nv), 2e-6, 2e-6)
        out[tag] = rep.abba(f"interp {tag} {B}x{Gp}x{L}", {"xla": xla, "triton": kern}, (v, xs, ys, nv), n=2 * n)

    n_sites = headline[0]
    args = _example_problem(n_sites=n_sites, n_years=n_years)

    def step():
        return jax.jit(
            lambda *a: qdm_train_adjust_core.__wrapped__(*a, kind="+", interp="linear", extrapolation="constant")
        )

    with_kernel = step()
    with_kernel(*args)
    with mock.patch.object(interp_mod, "use_triton_kernel", lambda *a: False):
        without = step()
        without(*args)  # traced (and compiled) with the XLA lookup
    compare("fused QDM step, kernel vs XLA lookup", with_kernel(*args), without(*args), 1e-5)
    out["qdm_step"] = rep.abba(
        f"fused QDM step {n_sites}x{n_years}", {"xla": without, "triton": with_kernel}, args, n=n
    )
    return out


def four_cards(
    rep: Report, devs=None, n_per_card: int = 512, n_years: int = 150, nq: int = 50,
    corr_sites: int = 4096, corr_time: int = 365,
) -> dict:
    """The site mesh on four cards (default: the first four GPUs), each part
    against one card or numpy."""
    import jax

    import __graft_entry__ as g

    if devs is None:
        devs = jax.devices("gpu")[:4]
    if len(devs) < 4:
        sys.exit(f"--four-cards needs four GPUs; JAX found {len(devs)}")
    n = 4 * n_per_card
    parts = (
        (f"QDM monthly, site mesh, {n} sites x {n_years} yr: max|diff| vs one card",
         lambda: g.multichip_qdm(devs, n_sites=n, n_years=n_years, rtol=TOL_MESH_ATOL)),
        (f"EQM doy+31w, per-card blocks, {n} sites x {n_years} yr: max|diff| vs one card",
         lambda: g.multichip_eqm_windowed(devs, n_sites=n, n_years=n_years, nq=nq, rtol=TOL_MESH_ATOL)),
        ("all_gather correlation, psum EOF, 2x2 rotation: max|err| vs numpy",
         lambda: g.multichip_collectives(devs, n_sites=corr_sites, n_time=corr_time)),
    )
    out, failed = {}, []
    for name, run in parts:
        # every part runs even when one fails, so one call reports them all
        t0 = time.perf_counter()
        try:
            out[name] = run()
            log(f"four cards: {name}: {out[name]} ({time.perf_counter() - t0:.1f} s) [{rep.card}]")
        except Exception as err:  # noqa: BLE001 — reported, then re-raised below
            failed.append(name)
            log(f"four cards: {name}: FAILED {type(err).__name__}: {str(err)[:2000]}")
    rep.peak()
    if failed:
        raise AssertionError(f"four-card parts failed: {failed}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true", help="run only the four-card site-mesh phase")
    opts = ap.parse_args(argv)

    import jax

    dev = require_gpu()
    import compile_cache

    log(f"cache: {compile_cache.enable(jax)}")
    card = nvidia_smi()
    log(f"device_kind: {dev.device_kind}; count: {len(jax.devices())}; jax {jax.__version__}")
    log(card)
    rep = Report(card)
    t0 = time.perf_counter()
    if opts.four_cards:
        four_cards(rep)
        count = 4
    else:
        phase_qdm(rep, 512, 150, opts.seed)
        phase_qdm(rep, 2048, 150, opts.seed)
        phase_eqm(rep, 256, 150, opts.seed)
        phase_mbcn(rep, 64, 30, 20, opts.seed)
        phase_interp(rep, opts.seed)
        count = len(jax.devices())
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
