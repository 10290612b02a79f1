"""ELL format, transposed ("ELL-T").

Reference: /root/reference/src/opt_ell.cpp — pad every row to K = max row length
(:27-59), row-parallel kernel over the fixed K (:75-89).  The layout here is
*transposed*: (K, n_row_pad) with rows on the minor axis, so the k-th entry of all
rows is one contiguous vector; SpMV is K fused gather-multiply steps + a K-reduction,
a perfectly rectangular workload.  Padding entries use col=0 / val=0 (the reference pads with
col=position, val=0 — equivalent: val 0 annihilates).
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, round_up
from .base import device_put, pytree_dataclass


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "k", "n_row_pad"))
class ELLState:
    n_row: int
    n_col: int
    nnz: int
    k: int          # max row length (ELL width)
    n_row_pad: int
    col: object     # (k, n_row_pad) int
    val: object     # (k, n_row_pad) float


def _ell_arrays(coo: COOMatrix, k: int, n_row_pad: int, idx_dtype, val_dtype):
    """Vectorized (K, R) transposed ELL build from row-sorted triplets."""
    col = np.zeros((k, n_row_pad), dtype=idx_dtype)
    val = np.zeros((k, n_row_pad), dtype=val_dtype)
    if coo.nnz:
        rp = coo.row_ptr()
        j = np.arange(coo.nnz) - rp[coo.row]  # position within row
        col[j, coo.row] = coo.col
        val[j, coo.row] = coo.val.astype(val_dtype)
    return col, val


def convert(coo: COOMatrix, cfg: Config) -> ELLState:
    k = max(1, int(coo.row_lengths().max(initial=0)))
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    col, val = _ell_arrays(coo, k, n_row_pad, cfg.index_dtype, cfg.np_dtype)
    return ELLState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, k=k, n_row_pad=n_row_pad,
        col=device_put(col), val=device_put(val),
    )


def mul(state: ELLState, x):
    return state.val * x[state.col]


def reduce(state: ELLState, products):
    return products.sum(axis=0)[: state.n_row]


def spmv(state: ELLState, x):
    return reduce(state, mul(state, x))


def phases(state: ELLState):
    return {"Mul": mul, "Sum": reduce}


def spmm(state: ELLState, X):
    """Y = A @ X, X (n_col, B): scan over the K ELL slots, one row-gather each —
    peak memory stays (n_row_pad, B) instead of (K, n_row_pad, B)."""
    import jax
    import jax.numpy as jnp

    def body(acc, kv):
        colk, valk = kv
        return acc + valk[:, None] * X[colk], None

    acc0 = jnp.zeros((state.n_row_pad, X.shape[1]), X.dtype)
    acc, _ = jax.lax.scan(body, acc0, (state.col, state.val))
    return acc[: state.n_row]


def report_fields(state: ELLState, cfg: Config) -> dict:
    return {"K": state.k, "PaddingRatio": round(
        state.k * state.n_row_pad / max(state.nnz, 1), 4)}


def traffic_bytes(state: ELLState, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = np.dtype(cfg.dtype).itemsize
    stored = state.k * state.n_row_pad
    return stored * (isz + vsz) + (stored + state.n_row) * vsz


def to_coo(state: ELLState) -> COOMatrix:
    """Inverse conversion; explicit stored zeros are dropped (they are
    indistinguishable from ELL padding)."""
    col = np.asarray(state.col)
    val = np.asarray(state.val)
    k, r = np.nonzero(val)
    return COOMatrix.from_triplets(state.n_row, state.n_col, r, col[k, r],
                                   val[k, r], sort=True)
