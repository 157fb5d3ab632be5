"""``chip_smoke.py`` and ``compile_cache.py`` off the card: the device check,
the phases and their oracles at tiny sizes on the CPU, and where the compile
cache goes.  (The script itself runs the phases at full size on a GPU.)"""

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
import compile_cache  # noqa: E402


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update({"JAX_PLATFORMS": "cpu", **(env_extra or {})})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_smoke_refuses_cpu():
    """No GPU: non-zero exit and no result line (no CPU fallback)."""
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_smoke_alone_fails_past_device_check(tmp_path):
    """Copied alone into an empty directory, the script fails (the package
    is missing) even when the device check passes, and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    code = (
        "import sys, types, chip_smoke as cs\n"
        "cs.require_gpu = lambda: types.SimpleNamespace(platform='gpu', device_kind='fake')\n"
        "sys.exit(cs.main([]))\n"
    )
    r = _run(["-c", code], str(tmp_path))
    assert r.returncode != 0
    assert "ModuleNotFoundError" in r.stderr
    assert '"ok"' not in r.stdout


@pytest.fixture
def rep():
    return cs.Report("cpu rehearsal")


def test_smoke_phase_qdm(rep):
    assert cs.phase_qdm(rep, n_sites=6, n_years=2, seed=1) < cs.TOL_QM_ATOL


def test_smoke_phase_eqm(rep):
    timing = cs.phase_eqm(rep, n_sites=3, n_years=3, seed=1, n=1)
    assert set(timing) == {"gather", "emit", "merge", "resort_oracle"}


def test_smoke_phase_mbcn(rep):
    assert cs.phase_mbcn(rep, n_sites=6, n_years=3, n_iter=4, seed=1) >= cs.TOL_MBCN_SPEARMAN


def test_smoke_phase_interp(rep):
    out = cs.phase_interp(
        rep, seed=1, heavy=(2, 365, 5), headline=(2, 14, 40), n=1, n_years=2, interpret=True
    )
    assert set(out) == {"heavy regular layout", "headline partition layout", "qdm_step"}


def test_smoke_four_card_phase_on_virtual_devices(rep):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    out = cs.four_cards(
        rep, devs=jax.devices()[:4], n_per_card=2, n_years=2, nq=10, corr_sites=16, corr_time=48
    )
    assert len(out) == 3
    assert {"pairwise_corr", "first_eof", "rotation_apply"} in [set(v) for v in out.values() if isinstance(v, dict)]


def test_smoke_oracle_comparisons_reject():
    a = np.linspace(0.0, 1.0, 50)[None, :]
    assert cs.compare("same", a, a, 0.0) == 0.0
    with pytest.raises(AssertionError, match="beyond tolerance"):
        cs.compare("shifted", a + 1e-3, a, 1e-4)
    with pytest.raises(AssertionError, match="NaN pattern"):
        cs.compare("nan", np.where(a > 0.5, np.nan, a), a, 1.0)
    # a reordering keeps the sorted values but breaks the time order
    with pytest.raises(AssertionError, match="Spearman"):
        cs.compare_reordered("reversed", a[:, ::-1], a, 1e-6, 0.999)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; otherwise the
    cache goes to the fixed <repo>/.jax_cache."""
    updates = {}
    fake = types.SimpleNamespace(config=types.SimpleNamespace(update=updates.__setitem__))
    if env_set:
        monkeypatch.setenv(compile_cache.ENV, "/some/cache")
        assert compile_cache.enable(fake) == "/some/cache"
        assert "jax_compilation_cache_dir" not in updates
    else:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.enable(fake) == want
        assert updates["jax_compilation_cache_dir"] == want
    assert "jax_persistent_cache_min_compile_time_secs" in updates
