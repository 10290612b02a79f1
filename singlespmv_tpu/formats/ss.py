"""SS — segmented-scan format (the reference's research contribution).

Reference: /root/reference/src/opt_ss.{h,cpp} — the nnz stream is tiled into H
segments of width W=SEGMENT_WIDTH; SpMV runs as phase "Mul" (elementwise
val·x[col] over H×W, :226-239), phase "Sum1" (log-tree reduction, :242-260) and phase
"Sum2" (per-row gather of reduced partials, :263-303).

XLA-level re-design (same three phases):
- stream laid out (H, W) with W a multiple of ``cfg.lane_width``;
- Mul = XLA gather + multiply;
- Sum1 = *intra-segment* segmented inclusive scan, ``lax.associative_scan``
  (XLA emits the log₂(W) shifted-add tree);
- Sum2 = gather each row-run's inclusive total at its run-end position (end_pos,
  precomputed at convert) and a *small* sorted scatter of the (H, R_max) partials —
  R_max = max row-runs per segment, usually ≪ W, so the scatter traffic is a fraction
  of nnz.  Rows spanning many segments are combined here, replacing the reference's
  cross-segment log-tree (opt_ss.cpp:121-147) with one sorted segment-sum.

Pad elements use the ghost row id n_row (the reference's pads point at row nRow too,
opt_ss.cpp:66-84) and are dropped by the combine.
"""
from __future__ import annotations

import math

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, round_up
from ..ops.segsum import (combine_partials, extract_run_partials,
                          segmented_scan_inclusive)
from .base import device_put, pytree_dataclass


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "w", "h", "r_max", "variant",
                        "n_step", "step_counts", "sorted_combine"))
class SSState:
    n_row: int
    n_col: int
    nnz: int
    w: int              # SEGMENT_WIDTH in elements
    h: int              # number of segments
    r_max: int          # max row-runs per segment
    variant: str        # simple | optimized
    n_step: int         # log2(W) scan depth (reported as nStep)
    step_counts: tuple  # runs with length > 2^i, per step (StepCount-i analog)
    sorted_combine: bool
    col: object        # (H, W) int
    val: object        # (H, W) float
    heads: object      # (H, W) bool — first element of each row-run
    end_pos: object    # (H, R_max) int32 — lane of each run's last element
    rank_rows: object  # (H, R_max) int — global row per run (ghost = n_row)


def build_stream(coo: COOMatrix, cfg: Config, *, rows=None, cols=None, vals=None,
                 sorted_combine: bool = True, variant=None,
                 min_h: int = 0, min_r_max: int = 0):
    """Shared SS stream builder (also used by CSS with block-reordered triplets).

    ``min_h`` / ``min_r_max`` force minimum static shapes — used by the distributed
    path (parallel.spmv) so every shard's state stacks into one array.
    """
    w = max(cfg.lane_width, round_up(cfg.segment_width, cfg.lane_width))
    if rows is None:
        rows, cols, vals = coo.row, coo.col, coo.val
    nnz = int(rows.shape[0])
    nnz_pad = max(round_up(max(nnz, 1), w), min_h * w)
    h = nnz_pad // w
    idx = cfg.index_dtype

    row_s = np.full(nnz_pad, coo.n_row, dtype=np.int64)  # ghost row pads
    col_s = np.zeros(nnz_pad, dtype=idx)
    val_s = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    row_s[:nnz] = rows
    col_s[:nnz] = cols
    val_s[:nnz] = np.asarray(vals, dtype=cfg.np_dtype)

    pos = np.arange(nnz_pad)
    prev = np.empty(nnz_pad, dtype=np.int64)
    prev[0] = -1
    prev[1:] = row_s[:-1]
    heads_flat = (pos % w == 0) | (row_s != prev)
    nxt = np.empty(nnz_pad, dtype=np.int64)
    nxt[-1] = -1
    nxt[:-1] = row_s[1:]
    ends_flat = (pos % w == w - 1) | (row_s != nxt)

    heads2d = heads_flat.reshape(h, w)
    rank2d = np.cumsum(heads2d, axis=1) - 1
    n_runs = rank2d[:, -1] + 1
    r_max = max(round_up(int(n_runs.max(initial=1)), 8), min_r_max)

    end_pos = np.zeros((h, r_max), dtype=np.int32)
    rank_rows = np.full((h, r_max), coo.n_row, dtype=idx)
    hh, ww = np.nonzero(ends_flat.reshape(h, w))
    rr = rank2d[hh, ww]
    end_pos[hh, rr] = ww
    rank_rows[hh, rr] = row_s.reshape(h, w)[hh, ww]

    # StepCount-i analog: row-runs still merging at tree level i (run length > 2^i).
    run_ids = np.cumsum(heads_flat) - 1
    run_len = np.bincount(run_ids)
    n_step = int(math.ceil(math.log2(w)))
    step_counts = tuple(int((run_len > (1 << i)).sum()) for i in range(n_step))

    return SSState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=nnz, w=w, h=h, r_max=r_max,
        variant=(variant or cfg.variant), n_step=n_step, step_counts=step_counts,
        sorted_combine=sorted_combine,
        col=device_put(col_s.reshape(h, w)),
        val=device_put(val_s.reshape(h, w)),
        heads=device_put(heads2d),
        end_pos=device_put(end_pos),
        rank_rows=device_put(rank_rows),
    )


def convert(coo: COOMatrix, cfg: Config) -> SSState:
    return build_stream(coo, cfg)


def mul(state: SSState, x):
    return state.val * x[state.col]


def scan(state: SSState, products):
    return segmented_scan_inclusive(products, state.heads)


def reduce(state: SSState, scanned):
    partials = extract_run_partials(scanned, state.end_pos)
    return combine_partials(partials, state.rank_rows, state.n_row)


def spmv(state: SSState, x):
    return reduce(state, scan(state, mul(state, x)))


def phases(state: SSState):
    return {"Mul": mul, "Sum1": scan, "Sum2": reduce}


def step_init(state: SSState, x):
    """Packed (2, H, W) carry [values; head flags] for per-step timing."""
    import jax.numpy as jnp

    prod = mul(state, x)
    return jnp.stack([prod, state.heads.astype(prod.dtype)])


def step_fns(state: SSState):
    """One jittable fn per scan tree level — the MEASURE_STEP_TIME analog
    (reference per-step loop /root/reference/src/opt_ss.cpp:244-259, report
    rows src/main.cpp:163-167).  Step i applies the distance-2^i
    segmented-scan shift-add to the packed carry from step i-1."""
    import jax.numpy as jnp

    def make(d):
        def step(st, vf):
            v, f = vf[0], vf[1]
            vz = jnp.concatenate([jnp.zeros_like(v[:, :d]), v[:, :-d]], axis=1)
            fz = jnp.concatenate([jnp.ones_like(f[:, :d]), f[:, :-d]], axis=1)
            v2 = jnp.where(f > 0, v, v + vz)
            f2 = jnp.maximum(f, fz)
            return jnp.stack([v2, f2])

        return step

    steps = []
    d, i = 1, 0
    while d < state.w:
        steps.append((f"{i:02d}", make(d)))
        d *= 2
        i += 1
    return steps


def report_fields(state: SSState, cfg: Config) -> dict:
    vsz = np.dtype(cfg.dtype).itemsize
    out = {"nStep": state.n_step, "SEGMENT_WIDTH(byte)": state.w * vsz,
           "R_max": state.r_max}
    for i, c in enumerate(state.step_counts):
        out[f"StepCount-{i:02d}"] = c
    return out


def traffic_bytes(state: SSState, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = np.dtype(cfg.dtype).itemsize
    stream = state.h * state.w
    combine = state.h * state.r_max
    return (stream * (isz + vsz)       # col + val reads
            + stream * vsz             # x gather (counted once)
            + combine * (isz + vsz)    # end_pos/rank_rows + partial traffic
            + state.n_row * vsz)       # y write


def stream_rows(heads, rank_rows) -> np.ndarray:
    """Recover each stream element's row id from heads + per-run row table."""
    heads = np.asarray(heads)
    rank = np.cumsum(heads, axis=1) - 1
    return np.take_along_axis(np.asarray(rank_rows), rank, axis=1)


def to_coo(state: SSState) -> COOMatrix:
    """Inverse conversion (the analog of CSR5's asCSR; explicit zeros dropped)."""
    rows = stream_rows(state.heads, state.rank_rows)
    col = np.asarray(state.col)
    val = np.asarray(state.val)
    keep = (rows < state.n_row) & (val != 0)
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows[keep],
                                   col[keep], val[keep], sort=True)
