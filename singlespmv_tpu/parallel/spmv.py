"""Distributed SpMV over a device mesh.

The north-star extension of the single-node reference (BASELINE.json: "matrices
row/block-partitioned across hosts, halo segments of the dense vector exchanged via
all-gather/all-to-all overlapped with local SpMV compute").  Design:

- 2-D logical grid ("row" × "col") over a ``jax.sharding.Mesh``.  Each (i, j) shard
  owns a row-block × column-block of the matrix, stored as a local SS segmented-scan
  stream (formats.ss) with *identical static shapes* across shards so the whole
  partition stacks into single arrays that ``shard_map`` splits.
- **Load balance** (the distributed analog of CSR5's tile balancing): rows are
  sorted by nnz and snake-dealt to row shards, so every shard gets ~equal nnz and an
  equal row count.  The inverse permutation is applied to y at the end (one gather —
  the same trick as the reference's JDS row sort, /root/reference/src/opt_jds.cpp:41-46).
- **x exchange**: x is sharded over "col" (each shard holds the slice its column
  block needs — the CSS idea, cache→HBM-locality, /root/reference/src/opt_css.cpp:33-45).
  With ``gather_x=True`` (1-D row meshes) x is sharded over "row" and all-gathered
  inside shard_map.
- **y reduce**: partial row results are ``psum``'d over "col" (the analog of
  CSR5's cross-thread calibration), then shards' row blocks concatenate over "row".

No NCCL/MPI analog exists in the reference (SURVEY §2.6) — collectives here are XLA
collectives, which the GPU backend hands to NCCL over NVLink.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, cdiv, round_up
from ..formats import ss as ss_format
from ..ops.segsum import (combine_partials, extract_run_partials,
                          segmented_scan_inclusive)


def partition_rows_balanced(coo: COOMatrix, n_shards: int) -> np.ndarray:
    """Assign rows to shards, balancing nnz; returns (n_shards, rows_per) global
    row ids, padded with the ghost id n_row.

    Rows sorted by descending nnz are snake-dealt across shards: shard loads differ
    by at most one max-row.  Equal row counts keep shard_map shapes uniform.
    """
    rows_per = cdiv(max(coo.n_row, 1), n_shards)
    lengths = coo.row_lengths()
    order = np.argsort(-lengths, kind="stable")
    perm = np.full((n_shards, rows_per), coo.n_row, dtype=np.int64)
    for k, r in enumerate(order):
        cycle, pos = divmod(k, n_shards)
        s = pos if cycle % 2 == 0 else n_shards - 1 - pos  # snake order
        perm[s, cycle] = r
    return perm


@dataclasses.dataclass
class DistSpMV:
    """Converted, mesh-stacked distributed SpMV operator.

    Build with ``DistSpMV.convert(coo, cfg, mesh)``; apply with ``op(x)`` where x is
    a (n_col,) array (host or device); returns the full y on all devices.
    """

    mesh: object
    cfg: Config
    n_row: int
    n_col: int
    nnz: int
    R: int                 # row shards
    C: int                 # col shards
    rows_per: int
    cols_per: int
    gather_x: bool
    # stacked device arrays, leading dim R*C (row-major over (row, col) grid)
    col: object            # (S, H, W)
    val: object
    heads: object
    end_pos: object        # (S, H, r_max)
    rank_rows: object
    perm: object           # (R, rows_per) global row per local slot (ghost n_row)
    _jitted: object = None

    @staticmethod
    def convert(coo: COOMatrix, cfg: Config, mesh, *,
                row_axis: str = "row", col_axis: Optional[str] = "col",
                gather_x: bool = False) -> "DistSpMV":
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = dict(zip(mesh.axis_names, mesh.devices.shape))
        R = axes.get(row_axis, 1)
        C = axes.get(col_axis, 1) if col_axis else 1
        if gather_x and C != 1:
            raise ValueError("gather_x requires a 1-D row mesh (C == 1)")

        perm = partition_rows_balanced(coo, R)
        rows_per = perm.shape[1]
        cols_per = cdiv(max(coo.n_col, 1), C)

        # Global row id -> (shard, local slot).
        local_of = np.full(coo.n_row + 1, 0, dtype=np.int64)
        shard_of = np.full(coo.n_row + 1, 0, dtype=np.int64)
        for s in range(R):
            valid = perm[s] < coo.n_row
            local_of[perm[s][valid]] = np.nonzero(valid)[0]
            shard_of[perm[s][valid]] = s

        er, ec, ev = coo.row, coo.col, coo.val
        e_rs = shard_of[er]
        e_cs = np.minimum(ec // cols_per, C - 1)
        e_lr = local_of[er]
        e_lc = ec - e_cs * cols_per

        # Bucket triplets per (row-shard, col-shard); sort within by local row.
        tri = {}
        for s in range(R):
            for c in range(C):
                m = (e_rs == s) & (e_cs == c)
                lr, lc, lv = e_lr[m], e_lc[m], ev[m]
                o = np.lexsort((lc, lr))
                tri[(s, c)] = (lr[o], lc[o], lv[o])
        w = max(cfg.lane_width, round_up(cfg.segment_width, cfg.lane_width))
        h_needed = max(cdiv(max(len(t[0]), 1), w) for t in tri.values())
        # Pass 1 sizes r_max; pass 2 builds equal-static-shape states.
        subs = {
            key: COOMatrix(n_row=rows_per, n_col=cols_per,
                           row=lr.astype(coo.row.dtype),
                           col=lc.astype(coo.col.dtype), val=lv)
            for key, (lr, lc, lv) in tri.items()
        }
        r_needed = max(
            ss_format.build_stream(sub, cfg, min_h=h_needed).r_max
            for sub in subs.values()
        )
        states = [
            ss_format.build_stream(subs[(s, c)], cfg, min_h=h_needed,
                                   min_r_max=r_needed)
            for s in range(R) for c in range(C)
        ]

        def stack(field):
            return np.stack([np.asarray(getattr(st, field)) for st in states])

        # Only reference col_axis in the spec when the mesh actually has it
        # (same guard as _build) — a 1-D row mesh with the default col_axis
        # must degrade to P(row_axis), not device_put onto a ghost axis.
        grid_spec = P((row_axis, col_axis)) \
            if (col_axis and col_axis in mesh.axis_names) else P(row_axis)
        def put(a, spec):
            return jax.device_put(a, NamedSharding(mesh, spec))

        op = DistSpMV(
            mesh=mesh, cfg=cfg, n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
            R=R, C=C, rows_per=rows_per, cols_per=cols_per, gather_x=gather_x,
            col=put(stack("col"), grid_spec),
            val=put(stack("val"), grid_spec),
            heads=put(stack("heads"), grid_spec),
            end_pos=put(stack("end_pos"), grid_spec),
            rank_rows=put(stack("rank_rows"), grid_spec),
            perm=put(jnp.asarray(perm.reshape(-1)), P()),
        )
        op._jitted = op._build(row_axis, col_axis)
        return op

    def _build(self, row_axis: str, col_axis: Optional[str]):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map

        mesh, R, C = self.mesh, self.R, self.C
        rows_per, cols_per = self.rows_per, self.cols_per
        gather_x = self.gather_x
        # In gather mode x is sharded over "row", so pad to a multiple of R.
        n_col_pad = round_up(self.n_col, R) if gather_x else cols_per * C
        grid = (row_axis, col_axis) if (col_axis and col_axis in mesh.axis_names) \
            else (row_axis,)
        grid_spec = P(grid)
        x_spec = P(row_axis) if gather_x else P(col_axis if C > 1 else None)

        def local_spmv(col, val, heads, end_pos, rank_rows, x_loc):
            col, val = col[0], val[0]
            heads, end_pos, rank_rows = heads[0], end_pos[0], rank_rows[0]
            if gather_x:
                x_all = jax.lax.all_gather(x_loc, row_axis, tiled=True)
            else:
                x_all = x_loc
            x_all = x_all[:cols_per] if not gather_x else x_all
            prod = val * x_all[col]
            scanned = segmented_scan_inclusive(prod, heads.astype(bool))
            partials = extract_run_partials(scanned, end_pos)
            y_loc = combine_partials(partials, rank_rows, rows_per)
            if C > 1:
                y_loc = jax.lax.psum(y_loc, col_axis)
            return y_loc[None]

        sharded = shard_map(
            local_spmv, mesh=mesh,
            in_specs=(grid_spec, grid_spec, grid_spec, grid_spec, grid_spec,
                      x_spec),
            out_specs=P(row_axis),
            check_vma=False,
        )

        @jax.jit
        def run(col, val, heads, end_pos, rank_rows, perm, x):
            xp = jnp.zeros((n_col_pad,), x.dtype).at[: x.shape[0]].set(x)
            y_perm = sharded(col, val, heads, end_pos, rank_rows, xp).reshape(-1)
            y = jnp.zeros((self.n_row + 1,), y_perm.dtype)
            y = y.at[perm].add(y_perm)
            return y[: self.n_row]

        return run

    def __call__(self, x):
        import jax.numpy as jnp

        x = jnp.asarray(np.asarray(x, dtype=self.cfg.np_dtype))
        return self._jitted(self.col, self.val, self.heads, self.end_pos,
                            self.rank_rows, self.perm, x)

    def spmm(self, X):
        """Distributed Y = A @ X for a (n_col, B) panel — the north-star's
        "row/block-partitioned SpMV + SpMM across a pod slice" op.  Columns are
        batched over the same sharded kernel (vmap over shard_map)."""
        import jax
        import jax.numpy as jnp

        X = jnp.asarray(np.asarray(X, dtype=self.cfg.np_dtype))
        run_cols = jax.vmap(self._jitted,
                            in_axes=(None, None, None, None, None, None, 1),
                            out_axes=1)
        return run_cols(self.col, self.val, self.heads, self.end_pos,
                        self.rank_rows, self.perm, X)
