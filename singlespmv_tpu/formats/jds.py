"""JDS (jagged diagonal) format.

Reference: /root/reference/src/opt_jds.cpp — rows sorted by descending nnz (perm,
:41-46), jagged diagonals stored contiguously with per-diagonal ptr (:47-59), kernel
indexes ptr[i]+r (:92-103).  Under XLA, jagged per-diagonal lengths break static
shapes, so JDS here is: row permutation (descending length) + the transposed ELL
layout of the *permuted* matrix + an inverse-permutation gather on the output.  After
sorting, the short rows' padding is clustered at the tail of each diagonal (all-zero
lanes vectorize for free), which is exactly the load-balance property JDS exists for.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, round_up
from .base import device_put, pytree_dataclass
from .ell import _ell_arrays


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "k", "n_row_pad"))
class JDSState:
    n_row: int
    n_col: int
    nnz: int
    k: int
    n_row_pad: int
    col: object       # (k, n_row_pad) int, rows permuted by descending length
    val: object       # (k, n_row_pad) float
    inv_perm: object  # (n_row,) int: y[r] = y_perm[inv_perm[r]]


def convert(coo: COOMatrix, cfg: Config) -> JDSState:
    lengths = coo.row_lengths()
    # Stable descending sort = reference's sort by nnz (opt_jds.cpp:41-46).
    perm = np.argsort(-lengths, kind="stable")
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(coo.n_row)
    permuted = COOMatrix.from_triplets(
        coo.n_row, coo.n_col, inv_perm[coo.row], coo.col, coo.val,
        index_bits=cfg.index_bits,
    )
    k = max(1, int(lengths.max(initial=0)))
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    col, val = _ell_arrays(permuted, k, n_row_pad, cfg.index_dtype, cfg.np_dtype)
    return JDSState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, k=k, n_row_pad=n_row_pad,
        col=device_put(col), val=device_put(val),
        inv_perm=device_put(inv_perm.astype(cfg.index_dtype)),
    )


def mul(state: JDSState, x):
    return state.val * x[state.col]


def reduce(state: JDSState, products):
    y_perm = products.sum(axis=0)
    return y_perm[state.inv_perm]


def spmv(state: JDSState, x):
    return reduce(state, mul(state, x))


def phases(state: JDSState):
    return {"Mul": mul, "Sum": reduce}


def report_fields(state: JDSState, cfg: Config) -> dict:
    return {"MaxLength": state.k}


def to_coo(state: JDSState) -> COOMatrix:
    """Inverse conversion; un-permutes rows (explicit zeros dropped)."""
    col = np.asarray(state.col)
    val = np.asarray(state.val)
    inv = np.asarray(state.inv_perm)
    perm = np.argsort(inv, kind="stable")  # local slot -> global row
    k, r = np.nonzero(val)
    return COOMatrix.from_triplets(state.n_row, state.n_col, perm[r], col[k, r],
                                   val[k, r], sort=True)
