"""chip_smoke.py: refuses to run without a GPU, and its phases run end to end
at tiny sizes on the CPU (the full sizes run only on the card)."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from singlespmv_tpu.data.generators import powerlaw  # noqa: E402


def tiny(name):
    return powerlaw(300, 3000, seed=len(name))


@pytest.fixture
def smoke(monkeypatch):
    # one short trial per run: the phases' control flow, not their timings
    monkeypatch.setattr(chip_smoke, "TIMING",
                        dict(calibrate_seconds=0.01, n_trials=1))
    return chip_smoke.Smoke()


@pytest.mark.parametrize("argv", [[], ["--multi"]], ids=["default", "multi"])
def test_main_refuses_cpu(argv, capsys):
    rc = chip_smoke.main(argv)
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails and
    prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_device_and_calibration(smoke):
    chip_smoke.phase_device(smoke)
    rates = chip_smoke.phase_calibration(smoke, gather_n=1 << 10,
                                         stream_n=1 << 10)
    assert smoke.ok, smoke.failures
    assert len(rates) == 3 and all(v > 0 for v in rates.values())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_phase_main_path(smoke, dtype):
    chip_smoke.phase_main_path(smoke, cases=[("tiny", dtype)], make=tiny)
    assert smoke.ok, smoke.failures


def test_phase_main_path_fails_on_exclusion(smoke, monkeypatch):
    """A candidate that died at its first run fails the main-path phase."""
    from singlespmv_tpu.formats import auto as auto_mod

    def boom(state, x):
        raise TypeError("synthetic first-run failure")

    # a shape no other test traces, so no cached trace skips the patched spmv
    def odd(name):
        return powerlaw(307, 2900, seed=9)

    first = auto_mod.convert(odd("odd"), chip_smoke_cfg())
    monkeypatch.setattr(auto_mod._MODULES[first.chosen], "spmv", boom)
    chip_smoke.phase_main_path(smoke, cases=[("odd", "float32")], make=odd)
    assert not smoke.ok
    assert "auto excluded" in smoke.failures[0]


def chip_smoke_cfg():
    from singlespmv_tpu.config import Config

    return Config(format="auto", dtype="float32")


def test_phase_formats(smoke):
    chip_smoke.phase_formats(smoke, fmt_matrix="tiny", standins=("tiny",),
                             make=tiny)
    assert smoke.ok, smoke.failures


def test_phase_formats_reports_verify_failure(smoke, monkeypatch):
    from singlespmv_tpu.formats import coo as coo_fmt

    orig = coo_fmt.spmv
    monkeypatch.setattr(coo_fmt, "spmv", lambda s, x: orig(s, x) + 1.0)
    chip_smoke.phase_formats(smoke, fmt_matrix="tiny", standins=(),
                             formats_=("coo",), make=tiny)
    assert not smoke.ok
    assert all("verify FAIL" in f for f in smoke.failures)


def test_phase_solver(smoke):
    chip_smoke.phase_solver(smoke, grid=6, iters=10)
    assert smoke.ok, smoke.failures


def test_phase_multi_on_virtual_devices(smoke):
    chip_smoke.phase_multi(smoke, name="tiny", make=tiny, n_dev=4)
    assert smoke.ok, smoke.failures


@pytest.mark.parametrize("n", [2, 5])
def test_laplacian_7pt(n):
    coo = chip_smoke.laplacian_7pt(n)
    dense = coo.to_dense()
    assert coo.n_row == n ** 3
    assert coo.nnz == n ** 3 + 6 * n * n * (n - 1)
    np.testing.assert_array_equal(dense, dense.T)
    assert np.linalg.eigvalsh(dense).min() > 0          # SPD


def test_cg_reference_matches_dense_cg():
    coo = chip_smoke.laplacian_7pt(4)
    b = np.random.default_rng(1).uniform(size=coo.n_row)
    x, res = chip_smoke.cg_reference(coo, b, 64)
    a = coo.to_dense()
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-8)
    assert res == pytest.approx(np.linalg.norm(b - a @ x), abs=1e-8)
