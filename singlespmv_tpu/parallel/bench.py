"""Weak/strong-scaling harness for the distributed SpMV.

North-star metric (BASELINE.json): "N-host scaling efficiency — ≥75% nnz/s
weak-scaling efficiency at 1 chip, 1 host and N hosts".  This measures nnz/s at
mesh sizes 1, 2, 4, ... over the available devices:

- **weak scaling**: per-shard problem size fixed — the matrix grows with the
  mesh (generator-backed); efficiency = nnz_rate(N) / (N · nnz_rate(1)).
- **strong scaling**: one fixed matrix; efficiency = rate(N) / (N · rate(1)).

On the CPU backend (virtual devices) the numbers exercise the sharding/collective
machinery rather than a real interconnect; on several GPUs the same code measures
the real thing (the mesh comes from parallel.mesh.make_mesh either way).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from ..config import Config
from ..core.rng import create_random_vector
from ..core.timing import now
from .halo import HaloSpMV
from .mesh import device_count, make_mesh
from .spmv import DistSpMV


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    nnz: int
    seconds: float
    nnz_per_s: float
    efficiency: float


def _time_op(op: DistSpMV, x, *, loop: int = 8, trials: int = 3) -> float:
    import jax

    y = jax.block_until_ready(op(x))  # compile
    best = float("inf")
    for _ in range(trials):
        t0 = now()
        for _ in range(loop):
            y = op(x)
        jax.block_until_ready(y)
        best = min(best, (now() - t0) / loop)
    return best


def mesh_sizes(limit: Optional[int] = None) -> List[int]:
    n = device_count() if limit is None else min(limit, device_count())
    sizes, s = [], 1
    while s <= n:
        sizes.append(s)
        s *= 2
    return sizes


def _convert(coo, cfg, mesh, *, halo: bool):
    if halo:
        return HaloSpMV.convert(coo, cfg, mesh)
    return DistSpMV.convert(coo, cfg, mesh, col_axis=None)


def weak_scaling(make_matrix: Callable[[int], "COOMatrix"],
                 cfg: Optional[Config] = None, *, loop: int = 8,
                 limit: Optional[int] = None,
                 halo: bool = False) -> List[ScalePoint]:
    """make_matrix(n_devices) -> COOMatrix sized ∝ n_devices.

    ``halo=True`` uses the halo-exchange/overlap operator (parallel.halo)
    instead of the all-gather DistSpMV."""
    cfg = cfg or Config(format="ss", dtype="float32", segment_width=512)
    points: List[ScalePoint] = []
    base_rate = None
    for n in mesh_sizes(limit):
        coo = make_matrix(n)
        mesh = make_mesh((("row", n),))
        op = _convert(coo, cfg, mesh, halo=halo)
        x = create_random_vector(coo.n_col).astype(cfg.np_dtype)
        sec = _time_op(op, x, loop=loop)
        rate = coo.nnz / sec
        if base_rate is None:
            base_rate = rate
        points.append(ScalePoint(n, coo.nnz, sec, rate,
                                 rate / (n * base_rate)))
    return points


def strong_scaling(coo, cfg: Optional[Config] = None, *, loop: int = 8,
                   limit: Optional[int] = None,
                   halo: bool = False) -> List[ScalePoint]:
    cfg = cfg or Config(format="ss", dtype="float32", segment_width=512)
    points: List[ScalePoint] = []
    base_rate = None
    for n in mesh_sizes(limit):
        mesh = make_mesh((("row", n),))
        op = _convert(coo, cfg, mesh, halo=halo)
        x = create_random_vector(coo.n_col).astype(cfg.np_dtype)
        sec = _time_op(op, x, loop=loop)
        rate = coo.nnz / sec
        if base_rate is None:
            base_rate = rate
        points.append(ScalePoint(n, coo.nnz, sec, rate,
                                 rate / (n * base_rate)))
    return points


def report(points: List[ScalePoint]) -> str:
    lines = [f"{'devices':>8} {'nnz':>12} {'time(s)':>10} {'Gnnz/s':>8} "
             f"{'eff%':>6}"]
    for p in points:
        lines.append(f"{p.n_devices:>8} {p.nnz:>12} {p.seconds:>10.6f} "
                     f"{p.nnz_per_s/1e9:>8.3f} {100*p.efficiency:>6.1f}")
    return "\n".join(lines)
