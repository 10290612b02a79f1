"""Planner rates: per-device storage, calibration on first use, injection."""
import json

import numpy as np
import pytest

from singlespmv_tpu.core import chipconst

RATES = {"hbm_bps": 1e12, "gather_rate": 2e10, "scatter_rate": 3e10,
         "matmul_flops": 4e13}


@pytest.fixture
def stored(tmp_path, monkeypatch):
    """File-backed lookup (no injection) in a private constants file."""
    p = tmp_path / "cc.json"
    monkeypatch.setenv("SPMV_CHIP_CONSTANTS", str(p))
    monkeypatch.setattr(chipconst, "_injected", None)
    return p


def test_defaults_complete():
    """The injected test constants carry every key, all positive; there are
    no built-in defaults to fall back to."""
    vals = chipconst.load()
    assert set(vals) == set(chipconst.KEYS)
    assert all(v > 0 for v in vals.values())
    assert not hasattr(chipconst, "DEFAULTS")


def test_save_load_roundtrip(stored):
    kind = chipconst.device_kind()
    assert chipconst.load() is None                      # nothing stored yet
    chipconst.save(RATES, kind)
    chipconst.save(dict(RATES, hbm_bps=9e12), "Some Other Device")
    assert chipconst.load() == RATES                     # own kind only
    assert chipconst.load("Some Other Device")["hbm_bps"] == 9e12
    data = json.loads(stored.read_text())
    assert set(data) == {kind, "Some Other Device"}
    with pytest.raises(ValueError):
        chipconst.save({"hbm_bps": -5}, kind)            # bad values refused
    stored.write_text(json.dumps({kind: {"hbm_bps": -5}}))
    assert chipconst.load() is None                      # invalid entry ignored


def test_planner_formula_uses_constants():
    """estimate_costs prices from the rates it is given (read lazily, at
    call time): a faster gather makes every gather-bound format cheaper,
    and leaves the streamed dia cost alone."""
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.data.generators import generate
    from singlespmv_tpu.formats.auto import estimate_costs

    coo = generate("band", 512, 4, seed=1)
    cfg = Config(dtype="float32")
    slow = estimate_costs(coo, cfg, consts=RATES)
    fast = estimate_costs(coo, cfg, consts=dict(RATES, gather_rate=2e12))
    assert fast["csr"] < slow["csr"] and fast["ell"] < slow["ell"]
    assert fast["dia"] == slow["dia"]
    assert estimate_costs(coo, cfg) == estimate_costs(
        coo, cfg, consts=chipconst.constants())


def test_constants_calibrate_missing_device(stored, monkeypatch):
    """A device with no entry is calibrated once, stored under its own kind,
    and read back afterwards — never borrowed from another device."""
    from singlespmv_tpu.harness import calibrate

    chipconst.save(RATES, "Some Other Device")
    calls = []

    def fake_measure(log=None):
        calls.append(1)
        return dict(RATES, hbm_bps=5e11)

    monkeypatch.setattr(calibrate, "measure", fake_measure)
    logs = []
    vals = chipconst.constants(log=logs.append)
    assert vals["hbm_bps"] == 5e11 and calls == [1]
    assert any("no calibration" in m for m in logs)
    assert chipconst.constants() == vals and calls == [1]
    assert chipconst.load("Some Other Device") == RATES


def test_calibrate_measures_tiny_on_cpu():
    """The XLA-level probes run at a tiny size and give four positive rates."""
    from singlespmv_tpu.harness import calibrate

    vals = calibrate.measure(n=1 << 12, k=32, log=lambda m: None)
    assert set(vals) == set(chipconst.KEYS)
    assert all(np.isfinite(v) and v > 0 for v in vals.values())


@pytest.mark.parametrize("probe", ["hbm_read_f32", "copy_f32", "gather_f32",
                                   "scatter_sorted_f32", "matmul_f32_highest"])
def test_microbench_probe(probe):
    from singlespmv_tpu.harness import microbench as mb

    arg = 32 if probe == "matmul_f32_highest" else 1 << 10
    work, sec = mb.PROBES[probe](arg)
    assert work > 0 and sec > 0
