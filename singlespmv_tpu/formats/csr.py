"""CSR (CRS) format.

Reference: /root/reference/src/opt_crs.cpp — COO→CSR row-pointer build (:10-42) and a
row-parallel dot-product kernel (:57-69).  Row-parallel loops over jagged rows don't
map to XLA's static shapes, so this design keeps the CSR arrays (row_ptr/col/val)
and computes with a row-id expansion: a gather of x[col] and a sorted segment-sum
(atomic adds on the GPU).  It is the plain path: any structure, any dtype, and the
format the `auto` planner falls back to.  The expansion is built once at convert
time — conversion cost is part of OptimizeProblem in the reference too.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, round_up
from ..ops.segsum import segment_sum_sorted
from .base import device_put, pytree_dataclass

PAD_MULTIPLE = 1024


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "nnz_pad", "max_row_nnz", "variant"))
class CSRState:
    n_row: int
    n_col: int
    nnz: int
    nnz_pad: int
    max_row_nnz: int
    variant: str
    row_ptr: object  # (n_row+1,) int
    rows: object     # (nnz_pad,) int — expansion of row_ptr
    col: object      # (nnz_pad,) int
    val: object      # (nnz_pad,) float


def convert(coo: COOMatrix, cfg: Config) -> CSRState:
    nnz_pad = round_up(max(coo.nnz, 1), PAD_MULTIPLE)
    idx = cfg.index_dtype
    rp = coo.row_ptr().astype(idx)
    pad_row = int(coo.row[-1]) if coo.nnz else 0
    rows = np.full(nnz_pad, pad_row, dtype=idx)
    col = np.zeros(nnz_pad, dtype=idx)
    val = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    rows[: coo.nnz] = coo.row
    col[: coo.nnz] = coo.col
    val[: coo.nnz] = coo.val.astype(cfg.np_dtype)
    return CSRState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, nnz_pad=nnz_pad,
        max_row_nnz=int(coo.row_lengths().max(initial=0)), variant=cfg.variant,
        row_ptr=device_put(rp), rows=device_put(rows),
        col=device_put(col), val=device_put(val),
    )


def mul(state: CSRState, x):
    return state.val * x[state.col]


def reduce(state: CSRState, products):
    return segment_sum_sorted(products, state.rows, state.n_row)


def spmv(state: CSRState, x):
    return reduce(state, mul(state, x))


def phases(state: CSRState):
    return {"Mul": mul, "Sum": reduce}


def spmm(state: CSRState, X):
    """Y = A @ X, X (n_col, B): nnz-expanded products + sorted segment-sum."""
    import jax

    products = state.val[:, None] * X[state.col]
    return jax.ops.segment_sum(products, state.rows, num_segments=state.n_row,
                               indices_are_sorted=True)


def report_fields(state: CSRState, cfg: Config) -> dict:
    return {"MaxRowNnz": state.max_row_nnz}


def to_coo(state: CSRState) -> COOMatrix:
    """Inverse conversion (the analog of CSR5's asCSR round-trip)."""
    return COOMatrix.from_triplets(
        state.n_row, state.n_col,
        np.asarray(state.rows)[: state.nnz], np.asarray(state.col)[: state.nnz],
        np.asarray(state.val)[: state.nnz], sort=False)
