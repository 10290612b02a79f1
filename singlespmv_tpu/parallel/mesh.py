"""Mesh construction helpers."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def device_count() -> int:
    import jax

    return len(jax.devices())


def make_mesh(shape: Optional[Sequence[Tuple[str, int]]] = None):
    """Build a Mesh from (axis, size) pairs; default = 1-D "row" mesh of all devices.

    A plain reshape of the first n devices: NVLink joins the cards of a host all
    to all, so the device order carries no topology (and the CPU backend's
    virtual devices have none either).
    """
    import jax
    from jax.sharding import Mesh

    if shape is None:
        shape = (("row", len(jax.devices())),)
    names = tuple(n for n, _ in shape)
    sizes = tuple(int(s) for _, s in shape)
    n = int(np.prod(sizes))
    devs = jax.devices()[:n]
    if n > len(devs):
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    return Mesh(np.array(devs).reshape(sizes), names)
