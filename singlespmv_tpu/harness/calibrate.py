"""Calibration of the planner's device rates (core/chipconst keys).

Measures the four rates the planner prices with, using the XLA-level probes of
``harness.microbench`` on the attached device, and stores them under its
``device_kind``:

  hbm_bps       bytes/s of a large float32 copy (read + write)
  gather_rate   elements/s of x[col] with random int32 indices
  scatter_rate  elements/s of a sorted segment_sum
  matmul_flops  flop/s of a float32 matrix product at Precision.HIGHEST

Run: ``python -m singlespmv_tpu calibrate`` (or harness.calibrate.main()).
"""
from __future__ import annotations

import sys
from typing import Dict

from ..core import chipconst
from . import microbench as mb


def measure(n: int = 1 << 25, k: int = 4096,
            log=lambda m: print(m, file=sys.stderr)) -> Dict[str, float]:
    """Rates of the attached device; ``n`` elements per stream probe and a
    (k, k) matrix product (defaults reach past a 50 MB L2)."""
    out: Dict[str, float] = {}
    # a copy, not a reduction: XLA's full reduction of one long vector does
    # not reach the streaming rate on the GPU
    elems, sec = mb.probe_copy(n)
    out["hbm_bps"] = 8.0 * elems / sec
    elems, sec = mb.probe_gather(n)
    out["gather_rate"] = elems / sec
    elems, sec = mb.probe_scatter(n)
    out["scatter_rate"] = elems / sec
    flops, sec = mb.probe_matmul(k)
    out["matmul_flops"] = flops / sec
    log(f"calibrate[{chipconst.device_kind()}]: "
        f"hbm {out['hbm_bps'] / 1e9:.1f} GB/s, "
        f"gather {out['gather_rate'] / 1e9:.2f} G elem/s, "
        f"scatter {out['scatter_rate'] / 1e9:.2f} G elem/s, "
        f"matmul {out['matmul_flops'] / 1e12:.2f} TFLOP/s")
    return out


def main():
    vals = measure()
    p = chipconst.save(vals)
    print(f"wrote {p} [{chipconst.device_kind()}]")
    print(vals)


if __name__ == "__main__":
    main()
