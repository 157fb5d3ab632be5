"""Command line interface.

The reference ships a typer stub (``cli.py:1-23``); this one adds a couple of
genuinely useful entry points: a quick self-test of the installed package and
the standard throughput benchmark.
"""

from __future__ import annotations

import argparse
import sys


def _selftest() -> int:
    import numpy as np

    import xsdba_tpu as xt

    t = xt.date_range("2000-01-01", periods=365 * 3, freq="D", calendar="noleap")
    rng = np.random.default_rng(0)
    u = rng.random(len(t))
    from scipy import stats

    ref = xt.DataArray(stats.norm.ppf(u, 10, 1), ("time",), {"time": t}, {"units": "K"}, "tas")
    hist = xt.DataArray(stats.norm.ppf(u, 12, 2), ("time",), {"time": t}, {"units": "K"}, "tas")
    eqm = xt.EmpiricalQuantileMapping.train(ref, hist, group="time.month", nquantiles=20)
    scen = eqm.adjust(hist, interp="linear")
    bias = float(np.abs(np.asarray(scen.data) - np.asarray(ref.data)).mean())
    ok = bias < 0.5
    print(f"selftest: residual |bias| = {bias:.4f} -> {'OK' if ok else 'FAIL'}")
    from .native import have_native

    print(f"native EMD solver: {'available' if have_native() else 'unavailable (g++ missing?)'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xsdba-tpu", description="Statistical downscaling and bias adjustment in JAX."
    )
    parser.add_argument("--version", action="store_true", help="Print the version and exit.")
    sub = parser.add_subparsers(dest="cmd")
    sub.add_parser("selftest", help="Train+adjust a small EQM and check the bias is removed.")
    sub.add_parser("bench", help="Run the standard single-chip throughput benchmark.")
    args = parser.parse_args(argv)
    if args.version:
        from . import __version__

        print(__version__)
        return 0
    if args.cmd == "selftest":
        return _selftest()
    if args.cmd == "bench":
        import runpy
        import os

        bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")
        if not os.path.exists(bench):  # installed wheel: bench.py ships with the source checkout only
            print("bench.py not found: the bench harness runs from a source checkout of the repository.", file=sys.stderr)
            return 1
        runpy.run_path(bench, run_name="__main__")
        return 0
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
