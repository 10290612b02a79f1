"""COO format.

Reference: /root/reference/src/opt_coo.cpp — zero-copy pass-through conversion and an
nnz-parallel kernel with ``#pragma omp atomic`` scatter (:43).  Here it is gather +
*sorted* segment-sum: XLA lowers the scatter-add over row-sorted indices itself
(atomic adds on the GPU), with functional semantics — the race class the omp atomic
guards against does not exist at this level.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, round_up
from ..ops.segsum import segment_sum_sorted
from .base import device_put, pytree_dataclass

PAD_MULTIPLE = 1024  # stream padding granularity


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "nnz_pad"))
class COOState:
    n_row: int
    n_col: int
    nnz: int
    nnz_pad: int
    row: object  # (nnz_pad,) int
    col: object  # (nnz_pad,) int
    val: object  # (nnz_pad,) float


def convert(coo: COOMatrix, cfg: Config) -> COOState:
    nnz_pad = round_up(max(coo.nnz, 1), PAD_MULTIPLE)
    idx = cfg.index_dtype
    # Pads keep the stream row-sorted: reuse the last row id with val=0.
    pad_row = int(coo.row[-1]) if coo.nnz else 0
    row = np.full(nnz_pad, pad_row, dtype=idx)
    col = np.zeros(nnz_pad, dtype=idx)
    val = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    row[: coo.nnz] = coo.row
    col[: coo.nnz] = coo.col
    val[: coo.nnz] = coo.val.astype(cfg.np_dtype)
    return COOState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, nnz_pad=nnz_pad,
        row=device_put(row), col=device_put(col), val=device_put(val),
    )


def mul(state: COOState, x):
    return state.val * x[state.col]


def reduce(state: COOState, products):
    return segment_sum_sorted(products, state.row, state.n_row)


def spmv(state: COOState, x):
    return reduce(state, mul(state, x))


def phases(state: COOState):
    return {"Mul": mul, "Sum": reduce}


def report_fields(state: COOState, cfg: Config) -> dict:
    return {"nNnzPad": state.nnz_pad}


def to_coo(state: COOState) -> COOMatrix:
    """Inverse conversion (the analog of CSR5's asCSR round-trip)."""
    return COOMatrix.from_triplets(
        state.n_row, state.n_col,
        np.asarray(state.row)[: state.nnz], np.asarray(state.col)[: state.nnz],
        np.asarray(state.val)[: state.nnz], sort=False)
