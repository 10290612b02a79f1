"""Roofline (speed-of-light) model.

The reference's CSR5 harness reports GB/s from the traffic model
``(m+1+nnz)·sizeof(idx) + (2·nnz+m)·sizeof(val)``
(/root/reference/opt/Benchmark_SpMV_using_CSR5/CSR5_avx2/detail/utils.h:10-14);
BASELINE.md uses it as the roofline basis.  SpMV is bandwidth-bound, so the roofline
for a device is ``peak_HBM_bytes_per_s / bytes_per_flop``.

Peaks are keyed by the exact ``jax.Device.device_kind`` string.  An accelerator
that is not in the table is an error; the host CPU has no roofline (its
reports carry the achieved bandwidth only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float        # device-memory bandwidth, GB/s
    f32_tflops: float      # peak dense float32 outside the tensor cores
    bf16_tflops: float     # peak dense bf16 on the tensor cores
    l2_mib: float          # last-level on-chip cache


# NVIDIA H100 data sheet (dense rates, no sparsity; SXM at 700 W, PCIe at 350 W).
CHIPS = {
    "NVIDIA H100 80GB HBM3": ChipSpec("H100 SXM", 3350.0, 67.0, 989.0, 50.0),
    "NVIDIA H100 PCIe": ChipSpec("H100 PCIe", 2000.0, 51.0, 756.0, 50.0),
}


def chip_for(kind: str, platform: str) -> Optional[ChipSpec]:
    """Peak table entry for a device, None for the host CPU."""
    if platform == "cpu":
        return None
    if kind not in CHIPS:
        raise KeyError(f"no roofline peaks for device kind {kind!r}; "
                       f"known: {sorted(CHIPS)}")
    return CHIPS[kind]


def detect_chip() -> Optional[ChipSpec]:
    import jax

    dev = jax.devices()[0]
    return chip_for(dev.device_kind, dev.platform)


def roofline(traffic_bytes: int, nnz: int, seconds: float,
             chip: Optional[ChipSpec]) -> dict:
    """Achieved GB/s, plus the share of the bandwidth roofline on a device."""
    gbps = traffic_bytes / seconds / 1e9 if seconds > 0 else 0.0
    out = {"Bandwidth(GB/s)": gbps}
    if chip is None:
        return out
    sol_seconds = traffic_bytes / (chip.hbm_gbps * 1e9)
    out.update({
        "RooflinePct": 100.0 * gbps / chip.hbm_gbps,
        "SolTime(s)": sol_seconds,
        "SolGFLOPS": 2.0 * nnz / sol_seconds / 1e9 if sol_seconds > 0 else 0.0,
        "Chip": chip.name,
        "L2(MiB)": chip.l2_mib,
    })
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (a card
    set below its maximum power runs slower under load)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi failed (rc {out.returncode})"
