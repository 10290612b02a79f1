"""Roofline peaks keyed by exact device_kind; unknown accelerators raise."""
import pytest

from singlespmv_tpu.harness import roofline as rl


@pytest.mark.parametrize("kind,name,gbps", [
    ("NVIDIA H100 80GB HBM3", "H100 SXM", 3350.0),
    ("NVIDIA H100 PCIe", "H100 PCIe", 2000.0),
])
def test_h100_kinds(kind, name, gbps):
    chip = rl.chip_for(kind, "gpu")
    assert chip.name == name and chip.hbm_gbps == gbps
    assert chip.l2_mib == 50.0


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100",
                                  "NVIDIA GH200 480GB"])
def test_unknown_accelerator_raises(kind):
    with pytest.raises(KeyError, match="no roofline peaks"):
        rl.chip_for(kind, "gpu")


def test_cpu_has_no_roofline():
    assert rl.chip_for("cpu", "cpu") is None
    out = rl.roofline(8_000_000, 1_000_000, 1e-3, None)
    assert out == {"Bandwidth(GB/s)": pytest.approx(8.0)}


def test_roofline_share_on_h100():
    chip = rl.CHIPS["NVIDIA H100 80GB HBM3"]
    out = rl.roofline(3_350_000_000, 100_000_000, 2e-3, chip)
    assert out["RooflinePct"] == pytest.approx(50.0)
    assert out["SolTime(s)"] == pytest.approx(1e-3)
    assert out["Chip"] == "H100 SXM"


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert rl.card_line().startswith("nvidia-smi unavailable")
