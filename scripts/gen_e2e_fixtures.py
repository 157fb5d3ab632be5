"""Freeze end-to-end scen outputs for all 11 adjustment classes.

Runs every case in tests/e2e_cases.py on the CPU backend with f64 and writes
tests/golden/e2e_scen.npz.  Re-run (and commit the new file) only when an
intentional numerical change lands; tests/test_e2e_frozen.py holds every
pipeline to the frozen values at 1e-12 until then.
"""

from __future__ import annotations

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from e2e_cases import CASES, build_inputs, run_case  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "e2e_scen.npz")


def main():
    inputs = build_inputs()
    pack = {}
    for name in CASES:
        scen = run_case(name, inputs)
        pack[name] = scen
        print(f"{name:28s} shape={scen.shape} mean={np.nanmean(scen):.6f}")
    np.savez_compressed(OUT, **pack)
    print(f"wrote {OUT} ({os.path.getsize(OUT)/1024:.0f} KiB)")


if __name__ == "__main__":
    main()
