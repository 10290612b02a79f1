"""jax.experimental.sparse library path ("vendor" path #2 — the cuSPARSE analog).

Reference: /root/reference/src/opt_cusparse.cpp calls ``cusparseDcsrmv`` (:81) as the
GPU vendor baseline.  Here the same slot is ``jax.experimental.sparse``: the matrix
is held as a library ``sparse.CSR`` and multiplied with ``sparse.csr_matvec``, which
XLA lowers to cuSPARSE's CSR SpMV on CUDA (float32/float64) and to the library's
own gather + scatter elsewhere.  Registered as ``bcoo`` for the format sweep's
historical name; benchmarked through the same harness for cross-implementation
checking (SURVEY §4.4).
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix
from .base import pytree_dataclass


@pytree_dataclass(meta=("n_row", "n_col", "nnz"))
class BCOOState:
    n_row: int
    n_col: int
    nnz: int
    mat: object  # sparse.CSR (row-sorted, duplicate-free)


def convert(coo: COOMatrix, cfg: Config) -> BCOOState:
    import jax.numpy as jnp
    from jax.experimental import sparse

    idx = cfg.index_dtype
    if coo.nnz:
        indptr = coo.row_ptr().astype(idx)
        indices = coo.col.astype(idx)
        data = coo.val.astype(cfg.np_dtype)
    else:
        # one explicit zero keeps nse == indptr[-1] (the library's contract)
        indptr = np.ones(coo.n_row + 1, dtype=idx)
        indptr[0] = 0
        indices = np.zeros(1, dtype=idx)
        data = np.zeros(1, dtype=cfg.np_dtype)
    mat = sparse.CSR((jnp.asarray(data), jnp.asarray(indices),
                      jnp.asarray(indptr)), shape=(coo.n_row, coo.n_col))
    return BCOOState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, mat=mat)


def spmv(state: BCOOState, x):
    from jax.experimental import sparse

    return sparse.csr_matvec(state.mat, x.astype(state.mat.dtype))


def report_fields(state: BCOOState, cfg: Config) -> dict:
    return {"Library": "jax.experimental.sparse.csr_matvec"}


def to_coo(state: BCOOState) -> COOMatrix:
    """Inverse conversion."""
    indptr = np.asarray(state.mat.indptr).astype(np.int64)
    rows = np.repeat(np.arange(state.n_row), np.diff(indptr))
    cols = np.asarray(state.mat.indices)
    vals = np.asarray(state.mat.data)
    keep = vals != 0
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows[keep],
                                   cols[keep], vals[keep], sort=True)
