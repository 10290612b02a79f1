"""DIA (diagonal) format.

Reference: /root/reference/src/opt_dia.cpp — bucket nnz by diagonal ``col-row``
(:21-62), dense per-diagonal arrays, serial sweep kernel (:75-92).  DIA is the most
streaming-friendly format of the zoo: each diagonal is a dense vector multiplied by a
*shifted* window of x — no index arrays touched in the hot loop at all.  We store a
(nDiag, n_row_pad) dense table plus a zero-padded x window gather whose indices are an
affine iota (diag offset + row), which XLA turns into cheap strided loads.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..core import hostmem as hm
from ..core.types import COOMatrix, round_up
from .base import device_put, pytree_dataclass

MAX_DIA_ELEMENTS = 1 << 30  # 4 GiB of f32 diagonal storage: admits the
#                             stencil-giant class (cage15's ~91 jittered
#                             stripe offsets × 5.15 M rows = 1.9 GB)


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "n_diag", "n_row_pad", "x_pad_left",
                        "x_pad_len", "offsets"))
class DIAState:
    n_row: int
    n_col: int
    nnz: int
    n_diag: int
    n_row_pad: int
    x_pad_left: int   # zeros prepended to x so every (row + offset) index is >= 0
    x_pad_len: int    # total padded-x length (static)
    offsets: tuple    # (n_diag,) STATIC python ints — diagonal offsets (col - row).
                      # Static so the kernel unrolls into per-diagonal dense slices
                      # of x: contiguous loads instead of a gather.
    diag: object      # (n_diag, n_row_pad) float


def convert(coo: COOMatrix, cfg: Config) -> DIAState:
    offs = hm.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64)) \
        if coo.nnz else np.zeros(1, dtype=np.int64)
    n_diag = int(offs.shape[0])
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    # Density guard (like the dense baseline's): DIA stores n_diag dense vectors,
    # so scattered matrices (one diagonal per nnz) would explode memory.  The
    # reference's DIA has the same implicit assumption (opt_dia.cpp targets
    # banded/stencil matrices).
    if n_diag * n_row_pad > MAX_DIA_ELEMENTS:
        raise ValueError(
            f"DIA: {n_diag} diagonals x {n_row_pad} rows exceeds the density "
            f"guard ({MAX_DIA_ELEMENTS} elements) — use ss/csr5 for scattered "
            "matrices")
    diag = np.zeros((n_diag, n_row_pad), dtype=cfg.np_dtype)
    if coo.nnz:
        d = np.searchsorted(offs, coo.col.astype(np.int64) - coo.row.astype(np.int64))
        # add.at: duplicate (row, col) triplets must accumulate, not overwrite
        np.add.at(diag, (d, coo.row), coo.val.astype(cfg.np_dtype))
    x_pad_left = int(max(0, -offs.min(initial=0)))
    # row + off ranges over [-x_pad_left, n_row_pad - 1 + max_off]
    x_pad_right = int(max(0, n_row_pad - 1 + offs.max(initial=0) - (coo.n_col - 1)))
    x_pad_len = coo.n_col + x_pad_left + x_pad_right
    return DIAState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, n_diag=n_diag,
        n_row_pad=n_row_pad, x_pad_left=x_pad_left, x_pad_len=x_pad_len,
        offsets=tuple(int(o) for o in offs),
        diag=device_put(diag),
    )


def spmv(state: DIAState, x):
    """y = Σ_d diag[d] · x[row + off_d]: each diagonal is a STATIC slice of the
    padded x — pure streaming loads, no gather and no index arrays."""
    import jax

    xp = jnp.zeros(state.x_pad_len + state.n_row_pad, dtype=x.dtype)
    xp = xp.at[state.x_pad_left : state.x_pad_left + state.n_col].set(x)
    windows = jnp.stack([
        jax.lax.dynamic_slice(xp, (off + state.x_pad_left,), (state.n_row_pad,))
        for off in state.offsets
    ])                                           # (nDiag, R) — static slices
    y = (state.diag * windows).sum(axis=0)
    return y[: state.n_row]


def report_fields(state: DIAState, cfg: Config) -> dict:
    return {"nDiag": state.n_diag}


def traffic_bytes(state: DIAState, cfg: Config) -> int:
    vsz = np.dtype(cfg.dtype).itemsize
    stored = state.n_diag * state.n_row_pad
    return stored * 2 * vsz + state.n_row * vsz + state.n_diag * 4


def to_coo(state: DIAState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    diag = np.asarray(state.diag)
    offs = np.asarray(state.offsets).astype(np.int64)
    d, r = np.nonzero(diag)
    c = r + offs[d]
    return COOMatrix.from_triplets(state.n_row, state.n_col, r, c,
                                   diag[d, r], sort=True)
