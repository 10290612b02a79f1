"""SpGEMM — sparse × sparse matrix multiply (north-star op).

No reference analog (the reference is SpMV-only); design follows the row-merge
family the SS/CSR5 machinery belongs to, with XLA's static-shape discipline:

1. B is laid out as ELL (padded rows, K_b slots) — regular gathers.
2. Every A-nonzero (i, k, va) expands to K_b candidate products
   (i, B.col[k, :], va · B.val[k, :]) — an (nnz_A, K_b) rectangle, fully vectorized.
3. Candidates are key-sorted by (i, j) (``lax.sort`` pairs) and duplicate keys are
   segment-summed via a head-flag prefix rank — the scan/sort replacement for the
   hash tables a hand-written CPU/GPU SpGEMM would use (deterministic, no atomics).

Everything is jit-compatible with static output capacity nnz_A × K_b; the true
output nnz is returned as a device scalar.  Use ``spgemm_coo`` for a host-side
COOMatrix result.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix
from ..formats import ell as ell_format


def spgemm_arrays(a_state, b_state, n_col_b: int):
    """C = A·B from two ELL-T states; returns (keys, vals, n_unique) padded arrays.

    keys: (cap,) int64 sorted row-major flat indices i·n_col_b + j (ghost = cap
    sentinel for annihilated/padded products); vals: (cap,) accumulated values
    aligned with keys' first occurrence; n_unique: device scalar count.
    """
    import jax
    import jax.numpy as jnp

    # A in ELL-T: col/val are (K_a, n_row_pad). Expand per (slot, row).
    ka, nra = a_state.col.shape
    kb, nrb = b_state.col.shape
    arow = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (ka, nra), 1), (ka, nra))
    acol = a_state.col
    aval = a_state.val

    # For each A entry (slot s, row i): partner row acol[s,i] of B.
    bcol = b_state.col[:, acol]          # (K_b, K_a, n_row_pad)
    bval = b_state.val[:, acol]
    prod = aval[None] * bval             # (K_b, K_a, n_row_pad)
    out_i = jnp.broadcast_to(arow[None], prod.shape)
    key = out_i.astype(jnp.int64) * n_col_b + bcol.astype(jnp.int64)

    ghost = jnp.int64(a_state.n_row) * n_col_b + n_col_b  # > any real key
    key = jnp.where(prod != 0, key, ghost).reshape(-1)
    vals = prod.reshape(-1)

    key_sorted, val_sorted = jax.lax.sort_key_val(key, vals)
    heads = jnp.concatenate(
        [jnp.ones((1,), bool), key_sorted[1:] != key_sorted[:-1]])
    seg = jnp.cumsum(heads) - 1                       # dense rank of each key
    cap = key.shape[0]
    sums = jax.ops.segment_sum(val_sorted, seg, num_segments=cap,
                               indices_are_sorted=True)
    first = jnp.where(heads, jnp.arange(cap), cap)
    first = jax.ops.segment_min(first, seg, num_segments=cap,
                                indices_are_sorted=True)
    uniq_keys = jnp.where(first < cap, key_sorted[jnp.minimum(first, cap - 1)],
                          ghost)
    n_unique = jnp.sum((uniq_keys != ghost).astype(jnp.int32))
    return uniq_keys, sums, n_unique


DEG_GROUPS = (8, 32, 128, 512, 2048, 8192, 1 << 30)


def spgemm_coo(a: COOMatrix, b: COOMatrix, cfg: Config = None) -> COOMatrix:
    """Host-facing C = A·B as a COOMatrix (explicit zeros dropped).

    B's rows are bucketed by degree (a single dense row of B would make the
    candidate rectangle nnz_A × max-deg explode).  Each group g
    holds B rows with degree ≤ K_g and only the A entries that point at
    them, so the total candidate capacity is Σ_g nnz_Ag·K_g ≈ the true
    flop count Σ_r coldeg_A(r)·deg_B(r) instead of nnz_A·max_deg."""
    assert a.n_col == b.n_row, "inner dimensions must agree"
    cfg = cfg or Config(dtype="float64")
    bdeg = np.bincount(b.row.astype(np.int64), minlength=b.n_row)
    parts = []
    lo = 0
    for K in DEG_GROUPS:
        rows_g = (bdeg > lo) & (bdeg <= K)
        lo = K
        if not rows_g.any():
            continue
        bm = rows_g[b.row.astype(np.int64)]
        am = rows_g[a.col.astype(np.int64)]
        if not am.any():
            continue
        # COMPACT the group's B-row space: the ELL plane is (K_g, n_rows),
        # so leaving B's full row space makes the dense-row group allocate
        # K_g × n_row dense (a 20k-deg row in a 100k B meant a 15 GiB
        # plane and ~130 GB of expansion)
        gsel = np.flatnonzero(rows_g)
        remap = np.zeros(b.n_row, np.int64)
        remap[gsel] = np.arange(len(gsel))
        # also compact A's ROW space to the rows that touch this group —
        # the expansion rectangle is (K_b, K_a, n_rows_A_pad), so a dense-B
        # group must only carry its few source rows of A
        arows = np.unique(a.row[am].astype(np.int64))
        armap = np.zeros(a.n_row, np.int64)
        armap[arows] = np.arange(len(arows))
        a_sub = COOMatrix(n_row=len(arows), n_col=len(gsel),
                          row=armap[a.row[am].astype(np.int64)],
                          col=remap[a.col[am].astype(np.int64)],
                          val=a.val[am])
        b_sub = COOMatrix(n_row=len(gsel), n_col=b.n_col,
                          row=remap[b.row[bm].astype(np.int64)],
                          col=b.col[bm], val=b.val[bm])
        a_state = ell_format.convert(a_sub, cfg)
        b_state = ell_format.convert(b_sub, cfg)
        keys, vals, n = spgemm_arrays(a_state, b_state, b.n_col)
        keys = np.asarray(keys)[: int(n)]
        vals = np.asarray(vals)[: int(n)]
        live = vals != 0
        keys, vals = keys[live], vals[live]
        # local A rows -> global output rows
        keys = arows[keys // b.n_col] * np.int64(b.n_col) + keys % b.n_col
        parts.append((keys, vals))
    if not parts:
        return COOMatrix.from_triplets(a.n_row, b.n_col, [], [], [],
                                       sort=True)
    keys = np.concatenate([p[0] for p in parts])
    vals = np.concatenate([p[1] for p in parts])
    # an output entry (i, j) can accumulate from several degree groups —
    # sum across them (within a group spgemm_arrays already merged)
    return COOMatrix.from_triplets(
        a.n_row, b.n_col, (keys // b.n_col).astype(np.int64),
        (keys % b.n_col).astype(np.int64), vals, sort=True,
        sum_duplicates=True)
