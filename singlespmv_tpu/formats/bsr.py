"""BSR — block-sparse rows with dense (bm × bn) tiles: the matrix-product format.

No direct reference analog (the closest is CSR row-parallel,
reference src/opt_crs.cpp:57-69).  Nonzeros are gathered into dense bm×bn
blocks so SpMV becomes a batched (bm×bn)·(bn) product streamed without per-nonzero
indices, and SpMM a batched matmul (``dot_general`` over the block batch), with a
segment-sum over block rows.

Blocks are stored sorted by (block_row, block_col); per-block data is dense with
explicit zeros, so density of the blocking decides efficiency (report_fields exposes
the fill ratio).
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, cdiv
from .base import device_put, pytree_dataclass


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "bm", "bn", "n_blocks",
                        "n_brow", "fill", "ell_k"))
class BSRState:
    n_row: int
    n_col: int
    nnz: int
    bm: int
    bn: int
    n_blocks: int
    n_brow: int
    fill: float          # nnz / (n_blocks·bm·bn)
    blocks: object       # (n_blocks, bm, bn) dense values
    brow: object         # (n_blocks,) block-row id, sorted
    bcol: object         # (n_blocks,) block-col id
    ell_k: int = 0       # block-ELL SpMM panel width (0 = layout not built)
    ell_blocks: object = None   # (n_brow, bm, K·bn) row-concat blocks
    ell_bcol: object = None     # (n_brow, K) int32 block cols (pad → CB)


def convert(coo: COOMatrix, cfg: Config) -> BSRState:
    bm = max(8, cfg.row_block)
    bn = cfg.lane_width
    n_brow = cdiv(max(coo.n_row, 1), bm)
    key = (coo.row.astype(np.int64) // bm) * (2 ** 32) + coo.col.astype(np.int64) // bn
    uniq, inv = np.unique(key, return_inverse=True)
    n_blocks = max(len(uniq), 1)
    # Scattered inputs make one near-empty block per nonzero: the dense block
    # array then dwarfs the matrix (webbase-1M: 3M blocks = 12.6 GB) and the
    # host->device transfer wedges the run.  Refuse; auto falls to csr.
    dense_elems = n_blocks * bm * bn
    if dense_elems > max(32 * coo.nnz, 1 << 22) or \
            dense_elems * np.dtype(cfg.np_dtype).itemsize > (2 << 30):
        raise ValueError(
            f"bsr: {n_blocks} blocks at fill {coo.nnz / dense_elems:.4f} — "
            "block storage would dwarf the matrix; use csr")
    blocks = np.zeros((n_blocks, bm, bn), dtype=cfg.np_dtype)
    if coo.nnz:
        lr = coo.row.astype(np.int64) % bm
        lc = coo.col.astype(np.int64) % bn
        np.add.at(blocks, (inv, lr, lc), coo.val.astype(cfg.np_dtype))
        brow = (uniq // (2 ** 32)).astype(cfg.index_dtype)
        bcol = (uniq % (2 ** 32)).astype(cfg.index_dtype)
    else:
        brow = np.zeros(1, dtype=cfg.index_dtype)
        bcol = np.zeros(1, dtype=cfg.index_dtype)
    fill = coo.nnz / float(n_blocks * bm * bn)

    # Block-ELL SpMM layout (SURVEY §7.6 "x → (nCol, B) panel"):
    # per block-row, its K blocks concatenate along the contraction dim so
    # Y = batched (bm, K·bn) @ (K·bn, B) — one dot_general, no segment
    # sum, and the X gather is block-row-granular.  Built only when padding
    # to the max blocks/row stays bounded (FEM/band classes: K ≈ 2-4).
    ell_k, ell_blocks, ell_bcol = 0, None, None
    if coo.nnz:
        counts = np.bincount(brow.astype(np.int64), minlength=n_brow)
        k_max = int(counts.max())
        cb = cdiv(max(coo.n_col, 1), bn)
        if 0 < k_max * n_brow <= 3 * n_blocks and \
                k_max * n_brow * bm * bn * blocks.itemsize <= (2 << 30):
            ell_bcol = np.full((n_brow, k_max), cb, dtype=np.int32)
            eb = np.zeros((n_brow, k_max, bm, bn), dtype=blocks.dtype)
            pos = np.arange(n_blocks) - np.concatenate(
                [[0], np.cumsum(counts)[:-1]])[brow.astype(np.int64)]
            ell_bcol[brow.astype(np.int64), pos] = bcol.astype(np.int32)
            eb[brow.astype(np.int64), pos] = blocks
            ell_blocks = np.ascontiguousarray(
                eb.transpose(0, 2, 1, 3).reshape(n_brow, bm, k_max * bn))
            ell_k = k_max
    return BSRState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, bm=bm, bn=bn,
        n_blocks=n_blocks, n_brow=n_brow, fill=fill,
        blocks=device_put(blocks), brow=device_put(brow), bcol=device_put(bcol),
        ell_k=ell_k,
        ell_blocks=device_put(ell_blocks) if ell_k else None,
        ell_bcol=device_put(ell_bcol) if ell_k else None,
    )


def spmv(state: BSRState, x):
    import jax
    import jax.numpy as jnp

    n_col_pad = cdiv(state.n_col, state.bn) * state.bn
    xp = jnp.zeros((n_col_pad,), x.dtype).at[: state.n_col].set(x)
    xb = xp.reshape(-1, state.bn)[state.bcol]              # (n_blocks, bn)
    # Broadcast-multiply + minor-axis reduce: an elementwise stream that
    # stays exact in float32 (a batched matvec may run in TF32).
    part = (state.blocks * xb[:, None, :]).sum(-1)
    yb = jax.ops.segment_sum(part, state.brow, num_segments=state.n_brow,
                             indices_are_sorted=True)
    return yb.reshape(-1)[: state.n_row]


MAX_GATHERED_ELEMS = 1 << 28    # cap on the materialized (n_blocks, bn, Bc) gather


def spmm(state: BSRState, X):
    """Y = A @ X with X (n_col, B): batched dense (bm×bn)@(bn×B) products.

    The gathered X blocks materialize (n_blocks, bn, B) — for block-scattered
    matrices that explodes, so wide panels process in column chunks.
    """
    import jax
    import jax.numpy as jnp

    b = X.shape[1]
    if state.ell_k:
        # block-ELL fast path: one batched matmul, scatter-free
        cb = cdiv(state.n_col, state.bn)
        Xp = jnp.zeros((cb * state.bn, b), X.dtype).at[: state.n_col].set(X)
        Xp = jnp.concatenate(       # block row cb = all-zero pad target
            [Xp.reshape(cb, state.bn, b),
             jnp.zeros((1, state.bn, b), X.dtype)], axis=0)
        Xg = Xp[state.ell_bcol.reshape(-1)].reshape(
            state.n_brow, state.ell_k * state.bn, b)
        Y = jax.lax.dot_general(
            state.ell_blocks, Xg,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=state.ell_blocks.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )                                                   # (n_brow, bm, b)
        return Y.reshape(-1, b)[: state.n_row]
    chunk = max(8, min(b, MAX_GATHERED_ELEMS // max(state.n_blocks * state.bn, 1)))

    def one_chunk(Xc):
        bc = Xc.shape[1]
        n_col_pad = cdiv(state.n_col, state.bn) * state.bn
        Xp = jnp.zeros((n_col_pad, bc), Xc.dtype).at[: state.n_col].set(Xc)
        Xb = Xp.reshape(-1, state.bn, bc)[state.bcol]       # (n_blocks, bn, Bc)
        part = jax.lax.dot_general(
            state.blocks, Xb,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=state.blocks.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )                                                   # (n_blocks, bm, Bc)
        Yb = jax.ops.segment_sum(part, state.brow, num_segments=state.n_brow,
                                 indices_are_sorted=True)
        return Yb.reshape(-1, bc)[: state.n_row]

    if chunk >= b:
        return one_chunk(X)
    outs = [one_chunk(X[:, i: i + chunk]) for i in range(0, b, chunk)]
    return jnp.concatenate(outs, axis=1)


def report_fields(state: BSRState, cfg: Config) -> dict:
    return {"BlockM": state.bm, "BlockN": state.bn, "nBlocks": state.n_blocks,
            "BlockFill": round(state.fill, 6)}


def traffic_bytes(state: BSRState, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = np.dtype(cfg.dtype).itemsize
    return (state.n_blocks * (state.bm * state.bn + state.bn) * vsz
            + state.n_blocks * 2 * isz + state.n_row * vsz)


def to_coo(state: BSRState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    blocks = np.asarray(state.blocks)
    brow = np.asarray(state.brow).astype(np.int64)
    bcol = np.asarray(state.bcol).astype(np.int64)
    b, lr, lc = np.nonzero(blocks)
    rows = brow[b] * state.bm + lr
    cols = bcol[b] * state.bn + lc
    keep = (rows < state.n_row) & (cols < state.n_col)
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows[keep],
                                   cols[keep], blocks[b, lr, lc][keep], sort=True)
