"""Core sparse types.

Re-design of the reference's core types (reference ``src/util.h:7-39``:
``SpMat{nRow,nCol,nNnz,row_idx,col_idx,val}``, ``Vec``, ``Element``).  Instead of C
structs of raw aligned pointers we use immutable dataclasses of numpy arrays on the
host side; format conversions produce JAX pytrees of device arrays with *static,
padded* shapes so everything is jit/pjit-compatible.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Index dtype policy — mirrors the reference's INDEX_32/INDEX_64 build flags
# (/root/reference/src/param.h:1-9) as a runtime choice.
INDEX_DTYPES = {32: np.int32, 64: np.int64}


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Host-side COO matrix, triplets sorted row-major (row, then col).

    This is the universal interchange type: the Matrix-Market reader produces it and
    every format's ``convert`` consumes it (the analog of the reference's ``SpMat``
    loaded by ``LoadSparseMatrix`` at /root/reference/src/util.cpp:30-66).
    """

    n_row: int
    n_col: int
    row: np.ndarray  # (nnz,) int
    col: np.ndarray  # (nnz,) int
    val: np.ndarray  # (nnz,) float

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    def __post_init__(self):
        assert self.row.shape == self.col.shape == self.val.shape

    @staticmethod
    def from_triplets(
        n_row: int,
        n_col: int,
        row: np.ndarray,
        col: np.ndarray,
        val: np.ndarray,
        *,
        sort: bool = True,
        sum_duplicates: bool = False,
        index_bits: int = 32,
    ) -> "COOMatrix":
        idx_t = INDEX_DTYPES[index_bits]
        row = np.asarray(row, dtype=idx_t)
        col = np.asarray(col, dtype=idx_t)
        val = np.asarray(val, dtype=np.float64)
        if sort:
            # Row-major order, like Element::operator< (util.h:28-37);
            # native parallel radix for large streams (hostmem.argsort_keys).
            from . import hostmem as hm

            order = hm.argsort_keys(
                row.astype(np.int64) * np.int64(max(n_col, 1))
                + col.astype(np.int64))
            row, col, val = row[order], col[order], val[order]
        if sum_duplicates and row.size:
            key = row.astype(np.int64) * n_col + col.astype(np.int64)
            uniq, inv = np.unique(key, return_inverse=True)
            v = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(v, inv, val)
            row = (uniq // n_col).astype(idx_t)
            col = (uniq % n_col).astype(idx_t)
            val = v
        return COOMatrix(n_row=n_row, n_col=n_col, row=row, col=col, val=val)

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.n_row, self.n_col), dtype=np.float64)
        np.add.at(d, (self.row, self.col), self.val)
        return d

    def row_ptr(self) -> np.ndarray:
        """CSR row pointer (requires row-sorted triplets)."""
        counts = np.bincount(self.row, minlength=self.n_row)
        rp = np.zeros(self.n_row + 1, dtype=np.int64)
        np.cumsum(counts, out=rp[1:])
        return rp

    def row_lengths(self) -> np.ndarray:
        return np.bincount(self.row, minlength=self.n_row)

    def transpose(self) -> "COOMatrix":
        return COOMatrix.from_triplets(
            self.n_col, self.n_row, self.col, self.row, self.val, sort=True
        )


def round_up(x: int, m: int) -> int:
    return -(-int(x) // int(m)) * int(m)


def cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad 1-D array to length n with `fill` (static-shape discipline for XLA)."""
    if a.shape[0] == n:
        return a
    out = np.full((n,), fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def matrix_stats(coo: COOMatrix) -> dict:
    """Row/col nnz stats (analog of matrix/script/counter.cpp:28-44)."""
    rl = coo.row_lengths()
    cl = np.bincount(coo.col, minlength=coo.n_col)
    return {
        "n_row": coo.n_row,
        "n_col": coo.n_col,
        "nnz": coo.nnz,
        "row_max": int(rl.max(initial=0)),
        "row_min": int(rl.min(initial=0) if coo.n_row else 0),
        "row_mean": float(rl.mean()) if coo.n_row else 0.0,
        "row_var": float(rl.var()) if coo.n_row else 0.0,
        "col_max": int(cl.max(initial=0)),
        "col_min": int(cl.min(initial=0) if coo.n_col else 0),
        "empty_rows": int((rl == 0).sum()),
    }
