"""Measure the two documented numeric deviations against reference-exact oracles.

1. Grouped interp_on_quantiles: our separable cyclic blend vs the reference's
   scipy.griddata triangulation over (value, fractional-group-index)
   (``/root/reference/src/xsdba/utils.py:380-400``), including group
   boundaries and the cyclic wrap region.
2. LOESS with NaNs: our zero-weight treatment vs the reference's
   compress-and-reexpand (``/root/reference/src/xsdba/loess.py:94-178``) —
   note the reference runs its *equal-spacing* fast path on the compressed
   (hence no longer equally spaced) coordinates; the oracle reproduces that
   hybrid exactly.

Prints max / p99 / median absolute divergence per scenario; the measured
bounds are recorded in docs/PARITY.md and pinned by
tests/test_deviation_bounds.py.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax
import numpy as np
from scipy.interpolate import griddata

# ---------------------------------------------------------------------------
# Part 1: grouped interp vs griddata
# ---------------------------------------------------------------------------


def griddata_oracle(v, frac, xq, yq, positions):
    """Reference `_interp_on_quantiles_2d` semantics: cyclic-pad the group
    axis, then linear griddata over the scattered (x, group) nodes."""
    G, nq = xq.shape
    step0 = positions[1] - positions[0]
    step1 = positions[-1] - positions[-2]
    pos_p = np.concatenate([[positions[0] - step0], positions, [positions[-1] + step1]])
    xq_p = np.concatenate([xq[-1:], xq, xq[:1]], axis=0)
    yq_p = np.concatenate([yq[-1:], yq, yq[:1]], axis=0)
    pts_x = xq_p.ravel()
    pts_g = np.repeat(pos_p, nq)
    return griddata((pts_x, pts_g), yq_p.ravel(), (v, frac), method="linear")


def measure_grouped_interp(n_groups: int, nq: int, seeds=range(5), n_pts: int = 20000, roughness: float = 1.0):
    """``roughness`` scales the non-seasonal inter-group table disagreement:
    1.0 = adversarial (adjacent tables differ by O(sigma) wiggles), 0.0 =
    smooth seasonal-cycle-only tables (the realistic adjustment-factor case).
    """
    from xsdba_tpu.ops.interp import interp_on_quantiles_grouped

    positions = np.arange(1.0, n_groups + 1.0)
    diffs_all, diffs_boundary = [], []
    for s in seeds:
        rng = np.random.default_rng(1000 + s)
        # per-group quantile tables with a seasonal cycle, af-style values
        base = np.sort(rng.gamma(4.0, 2.0, (1, nq)), axis=-1)
        cycle = 1.0 + 0.35 * np.sin(2 * np.pi * positions / n_groups)[:, None]
        xq = base * cycle + roughness * 0.2 * rng.normal(0, 1, (n_groups, nq)).cumsum(-1).clip(-2, 2)
        xq = np.sort(xq, axis=-1)
        yq = 0.8 + 0.4 * np.cos(2 * np.pi * positions / n_groups)[:, None] + 0.02 * np.arange(nq)
        yq = yq + roughness * 0.05 * rng.normal(0, 1, (n_groups, nq))

        frac = rng.uniform(positions[0] - 0.999, positions[-1] + 0.999, n_pts)
        # in-range values per point (inside both bracketing tables' spans)
        lo, hi = xq.min() * 1.05, xq.max() * 0.95
        v = rng.uniform(lo, hi, n_pts)

        want = griddata_oracle(v, frac, xq, yq, positions)
        got = np.asarray(
            interp_on_quantiles_grouped(v[None], frac, xq[None], yq[None], positions)
        )[0]
        m = np.isfinite(want) & np.isfinite(got)
        d = np.abs(got[m] - want[m])
        # classify: "covered interior" = v within BOTH bracketing tables'
        # spans (the blend and the triangulation share their support);
        # elsewhere we constant-extrapolate per group while griddata
        # triangulates across quantile extremes — the structural divergence.
        g1 = np.clip(np.searchsorted(positions, frac, side="right"), 1, n_groups)
        g1 = np.where(frac > positions[-1], 0, g1 % n_groups)  # wrap pads
        g0 = (g1 - 1) % n_groups
        lo_b = np.maximum(xq[g0, 0], xq[g1, 0])
        hi_b = np.minimum(xq[g0, -1], xq[g1, -1])
        covered = ((v >= lo_b) & (v <= hi_b))[m]
        diffs_all.append(d[covered])
        diffs_boundary.append(d[~covered])
    d = np.concatenate(diffs_all)
    db = np.concatenate(diffs_boundary)
    scale = float(np.ptp(yq))
    return {
        "n": d.size,
        "max": float(d.max()),
        "p99": float(np.percentile(d, 99)),
        "median": float(np.median(d)),
        "max_rel": float(d.max() / scale),
        "edge_max": float(db.max()),
        "edge_p99": float(np.percentile(db, 99)),
        "y_range": scale,
    }


# ---------------------------------------------------------------------------
# Part 2: LOESS NaN handling vs compress-and-reexpand
# ---------------------------------------------------------------------------


def ref_loess_oracle(x, y, f=0.5, niter=2, dx=None, d=1, skipna=True):
    """Reference `_loess_nb` numerics (loess.py:60-178), including the hybrid
    where dx>0 (equal-spacing path) is applied to NaN-compressed coordinates."""
    weight = lambda u: np.where(u >= 1, 0.0, (1 - u**3) ** 3)  # noqa: E731
    if skipna:
        nan = np.isnan(y)
        out = np.full(x.size, np.nan)
        x, y = x[~nan], y[~nan]
        if x.size == 0:
            return out
    n = x.size
    if dx is None:
        dx = 0.0
    if dx == 0:
        r = int(np.round(f * n))
        HW = min(r + 2, n)
        R = min(2 * HW, n)
        hw = None
    else:
        r = int(2 * (f * n // 2) + 1)
        hw = int((r - 1) / 2)
        R = min(r + 4, n)
        HW = hw + 2
    yest = np.zeros(n)
    delta = np.ones(n)
    wi = None
    for it in range(niter):
        for i in range(n):
            if i < HW:
                sl = slice(0, R)
            elif i >= n - HW - 1:
                sl = slice(n - R, n)
            else:
                sl = slice(i - HW, i + HW + 1)
            xi, yi, di = x[sl], y[sl], delta[sl]
            if dx > 0:
                if i <= HW or i >= n - HW:
                    diffs = np.abs(xi - x[i])
                    if i < hw:
                        h = (r - i) * dx
                    elif i >= n - hw:
                        h = (i - (n - r) + 1) * dx
                    else:
                        h = (hw + 1) * dx
                    wi = weight(diffs / h)
                w = di * wi
            else:
                diffs = np.abs(xi - x[i])
                h = np.sort(diffs)[r] if r < diffs.size else np.sort(diffs)[-1]
                w = di * weight(diffs / max(h, 1e-300))
            if d == 0:
                yest[i] = (w * yi).sum() / w.sum()
            else:
                b = np.array([np.sum(w * yi), np.sum(w * yi * xi)])
                A = np.array([[np.sum(w), np.sum(w * xi)], [np.sum(w * xi), np.sum(w * xi * xi)]])
                beta = np.linalg.solve(A, b)
                yest[i] = beta[0] + beta[1] * x[i]
        if it < niter - 1:
            res = y - yest
            s = np.median(np.abs(res))
            xres = (res != 0) * 1.0 if s == 0 else res / (6.0 * s)
            delta = (1 - xres**2) ** 2
            delta[np.abs(xres) >= 1] = 0
    if skipna:
        out[~nan] = yest
        return out
    return yest


def measure_loess(n: int = 600, f: float = 0.3, niter: int = 2, scenarios=None):
    from xsdba_tpu.ops.loess import loess_smoothing

    rng = np.random.default_rng(7)
    x = np.linspace(0.0, 1.0, n)
    signal = 10 + 3 * np.sin(4 * np.pi * x) + 0.02 * np.arange(n)
    results = {}
    for name, make_nan in (scenarios or {
        "nan_free": lambda y: y,
        "scattered_10pct": lambda y: _poke(y, rng.random(n) < 0.10),
        "gap_5pct_contiguous": lambda y: _poke(y, slice(n // 2, n // 2 + n // 20)),
        "scattered_30pct": lambda y: _poke(y, rng.random(n) < 0.30),
    }).items():
        y = signal + rng.normal(0, 0.5, n)
        y = make_nan(y.copy())
        want = ref_loess_oracle(x, y, f=f, niter=niter, dx=float(x[1] - x[0]))
        got = np.asarray(loess_smoothing(y, x, f=f, niter=niter))
        got = np.where(np.isnan(y), np.nan, got)
        m = np.isfinite(want) & np.isfinite(got)
        dloc = np.abs(got[m] - want[m])
        sig = float(np.nanstd(y))
        results[name] = {
            "max": float(dloc.max()) if dloc.size else 0.0,
            "median": float(np.median(dloc)) if dloc.size else 0.0,
            "max_over_sigma": float(dloc.max() / sig) if dloc.size else 0.0,
        }
    return results


def _poke(y, where):
    y[where] = np.nan
    return y


if __name__ == "__main__":
    # as a script: float64 on the CPU (the tests import the functions and
    # keep their own platform)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print("== grouped interp (separable blend) vs scipy.griddata ==")
    for G, nq, rough in [(12, 20, 1.0), (12, 50, 1.0), (4, 20, 1.0), (12, 20, 0.0), (12, 50, 0.0), (4, 20, 0.0)]:
        r = measure_grouped_interp(G, nq, roughness=rough)
        kind = "rough " if rough else "smooth"
        print(
            f"G={G:3d} nq={nq:3d} {kind}: interior max={r['max']:.4e} p99={r['p99']:.4e} "
            f"median={r['median']:.4e} max/range={r['max_rel']:.4e} | "
            f"span-edge max={r['edge_max']:.4e} p99={r['edge_p99']:.4e} "
            f"(y-range {r['y_range']:.2f}, n={r['n']})"
        )
    print("== LOESS NaN zero-weight vs reference compress-and-reexpand ==")
    for n, f in [(600, 0.3), (1200, 0.5)]:
        rs = measure_loess(n=n, f=f)
        for k, v in rs.items():
            print(f"n={n} f={f} {k:22s}: max={v['max']:.4e} median={v['median']:.4e} max/sigma={v['max_over_sigma']:.4e}")
