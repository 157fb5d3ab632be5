"""Benchmark: train+adjust throughput on one GPU.

Three measurements, each the median of ``REPS`` warm calls of one jitted
step, synchronized with ``block_until_ready``:

- headline: fused QDM monthly train+adjust, 512 sites x 150 yr noleap
  (gridpoint-years/s);
- heavy: fused EQM doy+31w train+adjust (``BASELINE.json`` config 1),
  256 sites x 150 yr (gridpoint-years/s);
- MBCn: one 20-rotation npdft training pass, 64 sites x 3 vars x 30 yr
  (iterations/s).

Prints one JSON line per measurement, each naming the card and its power
limit.  Exits non-zero when JAX finds no GPU.  Run: ``python bench.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

REPS = 5


def card() -> dict:
    """The device as JAX reports it, plus nvidia-smi's name and power limit."""
    import jax

    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices()), "nvidia_smi": smi}


def _rate(f, args, work):
    """Median rate (work units/s) of ``REPS`` warm calls, and the relative
    spread (max - min) / median of those rates."""
    import jax

    jax.block_until_ready(f(*args))  # compile + first run
    rates = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        rates.append(work / (time.perf_counter() - t0))
    med = float(np.median(rates))
    return med, float((max(rates) - min(rates)) / med)


def bench_headline():
    import jax

    from __graft_entry__ import _example_problem
    from xsdba_tpu.models._algos import qdm_train_adjust_core

    n_sites, n_years = 512, 150
    args = _example_problem(n_sites=n_sites, n_years=n_years)
    f = jax.jit(
        lambda *a: qdm_train_adjust_core.__wrapped__(*a, kind="+", interp="linear", extrapolation="constant")
    )
    return "QDM monthly train+adjust", "gridpoint-years/s", *_rate(f, args, n_sites * n_years)


def bench_heavy():
    import jax.numpy as jnp

    from xsdba_tpu.models._algos import eqm_train_adjust_windowed
    from xsdba_tpu.models._wrap import device_brackets
    from xsdba_tpu.ops.correction import equally_spaced_nodes
    from xsdba_tpu.utils.calendar import date_range
    from xsdba_tpu.utils.grouper import Grouper

    n_sites, n_years, nq = 256, 150, 50
    t = date_range("1950-01-01", periods=365 * n_years, freq="D", calendar="noleap")
    gi = Grouper("time.dayofyear", window=31).indexes(t)
    rng = np.random.default_rng(1)
    ref, hist, sim = (
        jnp.asarray(rng.normal(mu, sd, (n_sites, len(t))).astype(np.float32))
        for mu, sd in ((10, 2), (12, 3), (13, 3))
    )
    q = jnp.asarray(equally_spaced_nodes(nq).astype(np.float32))
    brackets = device_brackets(gi, "linear")

    def step(r, h, s):
        return eqm_train_adjust_windowed(
            r, h, s, gi.merge_plan, q, brackets, kind="+", assume_finite=True  # finite data
        )[0]

    return "EQM doy+31w train+adjust", "gridpoint-years/s", *_rate(step, (ref, hist, sim), n_sites * n_years)


def bench_mbcn():
    import jax.numpy as jnp

    from xsdba_tpu.models.mbcn import _mbcn_train_block
    from xsdba_tpu.ops.correction import equally_spaced_nodes
    from xsdba_tpu.ops.rotation import rand_rot_matrix
    from xsdba_tpu.utils.calendar import date_range
    from xsdba_tpu.utils.grouper import Grouper

    S, V, T, n_iter = 64, 3, 365 * 30, 20
    t = date_range("1981-01-01", periods=T, freq="D", calendar="noleap")
    rng = np.random.default_rng(3)
    # [V, S, T] layout, identity group gather for group="time" (as MBCn._train)
    refa = jnp.asarray(rng.normal(10, 3, (V, S, T)).astype(np.float32))
    hista = jnp.asarray(rng.normal(10, 3, (V, S, T)).astype(np.float32))
    gidx = jnp.asarray(Grouper("time").indexes(t).gather_idx)
    rotj = jnp.asarray(rand_rot_matrix(V, num=n_iter), dtype=refa.dtype)
    qj = jnp.asarray(equally_spaced_nodes(50).astype(np.float32))

    def step(r, h):
        return _mbcn_train_block(r, h, gidx, rotj, qj, interp="nearest", extrap="constant", n_escore=-1)

    return "MBCn train (20 rotations)", "iterations/s", *_rate(step, (refa, hista), n_iter)


def main():
    import jax

    import compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {jax.devices()[0].platform}")
    compile_cache.enable(jax)
    device = card()
    for bench in (bench_headline, bench_heavy, bench_mbcn):
        metric, unit, value, spread = bench()
        print(json.dumps({"metric": metric, "value": value, "unit": unit, "spread": spread, "device": device}), flush=True)


if __name__ == "__main__":
    main()
