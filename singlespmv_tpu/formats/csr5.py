"""CSR5-style tiled format.

Reference: the vendored CSR5 benchmark (/root/reference/opt/Benchmark_SpMV_using_CSR5;
Liu & Vinter, ICS'15).  Structure: the nnz space is cut into ω×σ tiles with per-tile
metadata — partition_pointer (first row per tile, MSB dirty bit for empty rows,
CSR5_avx2/detail/avx2/format_avx2.h:57-62), bit-packed per-lane descriptors, and a
3-kernel SpMV: fast-track tiles living in a single row (FMA + horizontal sum,
csr5_spmv_avx2.h:7-45), normal-track in-register segmented scan (:47-267), and
cross-tile calibration (:269-284).

XLA-level re-design:
- ω = cfg.omega (128 by default), σ auto-tuned from nnz/row when cfg.sigma == 0
  (the spirit of the CUDA backend's r/s/t/u rule, anonymouslib_cuda.h:296-312);
- tiles are **partitioned at convert time** into a fast track (single-row tiles →
  dense (Tf, ωσ) row-sum, a plain reduction, no scan) and a normal track (segmented
  scan + run-end extraction, shared with formats.ss);
- bit-packed descriptors become plain int32 arrays (end_pos / rank_rows) — XLA prefers
  vectors over bitfields; the empty-row descriptor_offset machinery is
  subsumed by ghost-row ids dropped in the combine;
- the calibration kernel (cross-tile partial rows) becomes the final sorted
  segment-sum over per-run partials.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, round_up
from ..ops.segsum import (combine_partials, extract_run_partials,
                          segmented_scan_inclusive)
from .base import device_put, pytree_dataclass


def auto_sigma(n_row: int, nnz: int) -> int:
    avg = nnz / max(n_row, 1)
    if avg < 8:
        return 4
    if avg < 32:
        return 8
    if avg < 128:
        return 16
    return 32


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "omega", "sigma", "w", "n_tile",
                        "n_fast", "n_normal", "r_max", "variant"))
class CSR5State:
    n_row: int
    n_col: int
    nnz: int
    omega: int
    sigma: int
    w: int         # ω·σ elements per tile
    n_tile: int
    n_fast: int    # fast-track (single-row) tiles
    n_normal: int
    r_max: int
    variant: str
    # fast track
    fast_col: object   # (n_fast, W)
    fast_val: object
    fast_rows: object  # (n_fast,)
    # normal track
    col: object        # (n_normal, W)
    val: object
    heads: object
    end_pos: object    # (n_normal, r_max)
    rank_rows: object


def convert(coo: COOMatrix, cfg: Config) -> CSR5State:
    from ..core.timing import now

    t0 = now()
    omega = cfg.omega
    sigma = cfg.sigma if cfg.sigma > 0 else auto_sigma(coo.n_row, coo.nnz)
    w = omega * sigma
    nnz_pad = round_up(max(coo.nnz, 1), w)
    n_tile = nnz_pad // w
    idx = cfg.index_dtype

    row_s = np.full(nnz_pad, coo.n_row, dtype=np.int64)
    col_s = np.zeros(nnz_pad, dtype=idx)
    val_s = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    row_s[: coo.nnz] = coo.row
    col_s[: coo.nnz] = coo.col
    val_s[: coo.nnz] = coo.val.astype(cfg.np_dtype)
    row2d = row_s.reshape(n_tile, w)
    t_alloc = now()

    # Fast track: tile entirely within one (real) row.
    single = (row2d == row2d[:, :1]).all(axis=1) & (row2d[:, 0] < coo.n_row)
    # Tiles that are pure padding are "fast" with a ghost row — dropped in combine.
    all_ghost = (row2d == coo.n_row).all(axis=1)
    fast = single | all_ghost
    fi = np.nonzero(fast)[0]
    ni = np.nonzero(~fast)[0]

    col2d = col_s.reshape(n_tile, w)
    val2d = val_s.reshape(n_tile, w)
    t_ptr = now()

    # Normal track metadata (heads / run ends / run rows), like formats.ss.
    nrow2d = row2d[ni]
    n_normal = int(ni.shape[0])
    if n_normal:
        prev = np.empty_like(nrow2d)
        prev[:, 0] = -1
        prev[:, 1:] = nrow2d[:, :-1]
        heads = nrow2d != prev
        heads[:, 0] = True
        nxt = np.empty_like(nrow2d)
        nxt[:, -1] = -1
        nxt[:, :-1] = nrow2d[:, 1:]
        ends = nrow2d != nxt
        ends[:, -1] = True
        rank = np.cumsum(heads, axis=1) - 1
        r_max = round_up(int(rank[:, -1].max(initial=0)) + 1, 8)
        end_pos = np.zeros((n_normal, r_max), dtype=np.int32)
        rank_rows = np.full((n_normal, r_max), coo.n_row, dtype=idx)
        hh, ww = np.nonzero(ends)
        rr = rank[hh, ww]
        end_pos[hh, rr] = ww
        rank_rows[hh, rr] = nrow2d[hh, ww]
    else:
        heads = np.zeros((0, w), dtype=bool)
        r_max = 8
        end_pos = np.zeros((0, r_max), dtype=np.int32)
        rank_rows = np.zeros((0, r_max), dtype=idx)

    fast_rows = np.minimum(row2d[fi, 0], coo.n_row).astype(idx)
    t_desc = now()

    state = CSR5State(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, omega=omega, sigma=sigma,
        w=w, n_tile=n_tile, n_fast=int(fi.shape[0]), n_normal=n_normal,
        r_max=r_max, variant=cfg.variant,
        fast_col=device_put(col2d[fi]), fast_val=device_put(val2d[fi]),
        fast_rows=device_put(fast_rows),
        col=device_put(col2d[ni]), val=device_put(val2d[ni]),
        heads=device_put(heads), end_pos=device_put(end_pos),
        rank_rows=device_put(rank_rows),
    )
    import jax

    jax.block_until_ready(state)
    # asCSR5 phase breakdown (anonymouslib_avx2.h:207-210).  Stored as a
    # non-field attribute on the instance (frozen-dataclass bypass): it stays
    # out of the pytree (timings as static metadata would defeat the jit
    # cache), dies with the state (no global side table to leak or to attach
    # a recycled id's timings to the wrong state), and report_fields reads it
    # off the same host object convert returned.
    object.__setattr__(state, "_convert_ms", (
        round((t_alloc - t0) * 1e3, 3), round((t_ptr - t_alloc) * 1e3, 3),
        round((t_desc - t_ptr) * 1e3, 3), round((now() - t_desc) * 1e3, 3)))
    return state


def spmv(state: CSR5State, x):
    import jax

    # Fast track: dense per-tile row-sum (the FMA+hsum kernel, csr5_spmv_avx2.h:7-45).
    fast_partials = (state.fast_val * x[state.fast_col]).sum(axis=1)
    y = jax.ops.segment_sum(
        fast_partials, state.fast_rows, num_segments=state.n_row + 1,
        indices_are_sorted=True,
    )[: state.n_row]
    # Normal track: segmented scan + run-end extraction + calibration-combine.
    prod = state.val * x[state.col]
    scanned = segmented_scan_inclusive(prod, state.heads)
    partials = extract_run_partials(scanned, state.end_pos)
    y = y + combine_partials(partials, state.rank_rows, state.n_row)
    return y


def report_fields(state: CSR5State, cfg: Config) -> dict:
    out = {
        "Omega": state.omega, "Sigma": state.sigma, "nTile": state.n_tile,
        "nFastTile": state.n_fast, "nNormalTile": state.n_normal,
        "R_max": state.r_max,
    }
    ms = getattr(state, "_convert_ms", None)
    if ms:
        for name, v in zip(("malloc", "tile_ptr", "tile_desc", "transpose"), ms):
            out[f"Convert-{name}(ms)"] = v
    return out


def traffic_bytes(state: CSR5State, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = np.dtype(cfg.dtype).itemsize
    stream = state.n_tile * state.w
    combine = state.n_normal * state.r_max + state.n_fast
    return stream * (isz + 2 * vsz) + combine * (isz + vsz) + state.n_row * vsz


def to_coo(state: CSR5State) -> COOMatrix:
    """Inverse conversion (asCSR analog, anonymouslib_avx2.h asCSR; explicit
    zeros dropped)."""
    from .ss import stream_rows

    frows = np.repeat(np.asarray(state.fast_rows).astype(np.int64), state.w)
    fcol = np.asarray(state.fast_col).reshape(-1)
    fval = np.asarray(state.fast_val).reshape(-1)
    nrows = stream_rows(state.heads, state.rank_rows).reshape(-1)
    ncol = np.asarray(state.col).reshape(-1)
    nval = np.asarray(state.val).reshape(-1)
    rows = np.concatenate([frows, nrows.astype(np.int64)])
    cols = np.concatenate([fcol, ncol])
    vals = np.concatenate([fval, nval])
    keep = (rows < state.n_row) & (vals != 0)
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows[keep],
                                   cols[keep], vals[keep], sort=True)
