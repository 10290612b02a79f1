"""Measured device rates for the format planner, keyed by ``device_kind``.

``harness.calibrate`` measures four rates with XLA-level probes on the attached
device and stores them under that device's ``device_kind`` in
``results/chip_constants.json``.  The planner (``formats.auto``, ``formats.hyb``)
reads them through :func:`constants`, which calibrates first on a device that has
no entry yet.  No device ever borrows another device's constants, and there are
no built-in defaults.

Keys:
    hbm_bps       streamed bytes/s (large copy)
    gather_rate   elements/s of ``x[col]`` with random int32 indices
    scatter_rate  elements/s of a sorted ``segment_sum``
    matmul_flops  float32 matrix-product flop/s at ``Precision.HIGHEST``

Override the file location with SPMV_CHIP_CONSTANTS=<path>.  Tests call
:func:`inject` to pin constants without measuring.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

KEYS = ("hbm_bps", "gather_rate", "scatter_rate", "matmul_flops")

_injected: Optional[Dict[str, float]] = None


def _path() -> str:
    env = os.environ.get("SPMV_CHIP_CONSTANTS")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "results", "chip_constants.json")


def device_kind() -> str:
    import jax

    return jax.devices()[0].device_kind


def _valid(vals) -> bool:
    return (isinstance(vals, dict) and all(
        isinstance(vals.get(k), (int, float)) and vals[k] > 0 for k in KEYS))


def _read_all(path: str) -> Dict[str, Dict[str, float]]:
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def load(kind: Optional[str] = None) -> Optional[Dict[str, float]]:
    """Stored constants of ``kind`` (default: the attached device), or None."""
    if _injected is not None:
        return dict(_injected)
    vals = _read_all(_path()).get(kind or device_kind())
    return {k: float(vals[k]) for k in KEYS} if _valid(vals) else None


def save(values: Dict[str, float], kind: Optional[str] = None,
         path: Optional[str] = None) -> str:
    """Store ``values`` under ``kind`` (default: the attached device)."""
    if not _valid(values):
        raise ValueError(f"chip constants need positive {KEYS}: {values}")
    p = path or _path()
    data = _read_all(p)
    data[kind or device_kind()] = {k: float(values[k]) for k in KEYS}
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    return p


def inject(values: Optional[Dict[str, float]]) -> None:
    """Pin the constants every lookup returns (None restores file lookup)."""
    global _injected
    if values is not None and not _valid(values):
        raise ValueError(f"chip constants need positive {KEYS}: {values}")
    _injected = None if values is None else {k: float(values[k]) for k in KEYS}


def constants(log: Optional[Callable[[str], None]] = None) -> Dict[str, float]:
    """Constants of the attached device, calibrating it first if it has none."""
    vals = load()
    if vals is not None:
        return vals
    from ..harness.calibrate import measure

    kind = device_kind()
    if log:
        log(f"chipconst: no calibration for {kind!r}; measuring")
    vals = measure(log=log or (lambda m: None))
    save(vals, kind)
    return vals
