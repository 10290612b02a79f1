"""Dense baseline ("vendor" path #1 — the MKL analog).

Reference: /root/reference/src/opt_mkl.cpp calls Intel MKL's ``mkl_dcsrmv`` (:54) as
the vendor-library baseline.  Here the dense path is XLA itself: densify and run
the matvec as ``jnp.dot`` (cuBLAS on the GPU) at ``Precision.HIGHEST``, so float32
never drops to TF32.  Only sane for matrices that fit densely —
convert() enforces a size guard (the artificial suite's dense-N cases are the target,
matrix/artificial/gen.sh).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..core.types import COOMatrix, round_up
from .base import device_put, pytree_dataclass

MAX_DENSE_ELEMENTS = 1 << 28  # 1 GiB of f32


@pytree_dataclass(meta=("n_row", "n_col", "nnz"))
class DenseState:
    n_row: int
    n_col: int
    nnz: int
    mat: object  # (n_row_pad, n_col_pad) float


def convert(coo: COOMatrix, cfg: Config) -> DenseState:
    rp = round_up(max(coo.n_row, 1), 8)
    cp = round_up(max(coo.n_col, 1), 128)
    if rp * cp > MAX_DENSE_ELEMENTS:
        raise ValueError(
            f"dense baseline: {coo.n_row}x{coo.n_col} exceeds the density guard"
        )
    mat = np.zeros((rp, cp), dtype=cfg.np_dtype)
    np.add.at(mat, (coo.row, coo.col), coo.val.astype(cfg.np_dtype))
    return DenseState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                      mat=device_put(mat))


def spmv(state: DenseState, x):
    xp = jnp.zeros(state.mat.shape[1], dtype=x.dtype).at[: state.n_col].set(x)
    y = jnp.dot(state.mat, xp, preferred_element_type=state.mat.dtype,
                precision=jax.lax.Precision.HIGHEST)
    return y[: state.n_row]


def spmm(state: DenseState, X):
    """Y = A @ X as one dense matrix product."""
    Xp = jnp.zeros((state.mat.shape[1], X.shape[1]), dtype=X.dtype)
    Xp = Xp.at[: state.n_col].set(X)
    return jnp.dot(state.mat, Xp, preferred_element_type=state.mat.dtype,
                   precision=jax.lax.Precision.HIGHEST)[: state.n_row]


def traffic_bytes(state: DenseState, cfg: Config) -> int:
    vsz = np.dtype(cfg.dtype).itemsize
    return (state.mat.shape[0] * state.mat.shape[1] + state.n_col + state.n_row) * vsz


def to_coo(state: DenseState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    mat = np.asarray(state.mat)[: state.n_row, : state.n_col]
    r, c = np.nonzero(mat)
    return COOMatrix.from_triplets(state.n_row, state.n_col, r, c, mat[r, c],
                                   sort=True)
