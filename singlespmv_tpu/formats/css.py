"""CSS — column-blocked segmented-scan format.

Reference: /root/reference/src/opt_css.cpp — columns split into N_BLOCK blocks so the
gathered x window stays cache-resident (:33-45); per-block SS structures with
per-block log-trees, y accumulated across blocks (:198-303).

Design: the nnz stream is ordered by (column block, row, col) and computed by the
SS engine (formats.ss), so each stretch of the stream gathers from one window of
x.  The reference's per-block tree + cross-block y accumulation collapse into
SS's final segment-sum, which also sums a row's per-block partials.

- "optimized" variant: ``cfg.lane_width``-wide column blocks (many small x
  windows);
- "simple" variant: ``cfg.n_block`` column blocks (the reference's sweepable
  N_BLOCK).
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, cdiv
from . import ss
from .base import pytree_dataclass


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "w", "h", "r_max", "variant",
                        "n_step", "step_counts", "sorted_combine",
                        "n_block", "block_cols"))
class CSSState(ss.SSState):
    n_block: int = 1
    block_cols: int = 0


def convert(coo: COOMatrix, cfg: Config) -> CSSState:
    if cfg.variant == "optimized":
        block_cols = cfg.lane_width
        n_block = cdiv(max(coo.n_col, 1), block_cols)
    else:
        n_block = max(1, cfg.n_block)
        block_cols = cdiv(max(coo.n_col, 1), n_block)

    blk = coo.col // block_cols
    order = np.lexsort((coo.col, coo.row, blk))
    base = ss.build_stream(coo, cfg, rows=coo.row[order], cols=coo.col[order],
                           vals=coo.val[order], sorted_combine=False)
    d = {f: getattr(base, f) for f in (
        "n_row", "n_col", "w", "h", "r_max", "variant", "n_step",
        "step_counts", "sorted_combine", "col", "val", "heads", "end_pos",
        "rank_rows")}
    return CSSState(nnz=coo.nnz, n_block=n_block, block_cols=block_cols, **d)


spmv = ss.spmv
phases = ss.phases
traffic_bytes = ss.traffic_bytes
step_init = ss.step_init      # MEASURE_STEP_TIME shares the SS tree levels
step_fns = ss.step_fns


def report_fields(state: CSSState, cfg: Config) -> dict:
    out = ss.report_fields(state, cfg)
    out["N_BLOCK"] = state.n_block
    out["BlockCols"] = state.block_cols
    return out


def to_coo(state: CSSState) -> COOMatrix:
    """Inverse conversion — same reconstruction as SS (rows re-sorted)."""
    return ss.to_coo(state)
