"""SpTRSV — sparse triangular solve (north-star op).

No reference analog (the reference is SpMV-only).  Classic level scheduling, built
with the same analysis machinery as the JDS/DIA converts: rows are grouped into
dependency levels on the host (level[r] = 1 + max level over r's off-diagonal
columns), then the solve runs one ``lax.fori_loop`` step per level — each level is a
rectangular padded gather/FMA (ELL-style slots), fully data-parallel; the
sequential depth is the DAG depth, not n_row.

Solves L·y = b (lower, unit or not) and U·y = b (upper) — the substitution kernels
the north-star's "sparse triangular solve/factorization path" requires.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import Config
from ..core.types import COOMatrix, cdiv


@dataclasses.dataclass(frozen=True)
class TriSolveplan:
    """Host-built level schedule + device arrays (static shapes)."""
    n_row: int
    n_levels: int
    rows_per_level: int   # padded level width
    k: int                # padded off-diagonal slots per row
    level_rows: object    # (n_levels, rows_per_level) row ids (ghost n_row)
    col: object           # (n_levels, rows_per_level, k)
    val: object
    diag: object          # (n_levels, rows_per_level) diagonal values (pad 1.0)
    lower: bool


def analyze(coo: COOMatrix, cfg: Config = None, *, lower: bool = True) -> TriSolveplan:
    cfg = cfg or Config(dtype="float64")
    n = coo.n_row
    assert coo.n_row == coo.n_col, "triangular solve needs a square matrix"

    off = (coo.col < coo.row) if lower else (coo.col > coo.row)
    dmask = coo.col == coo.row
    diag = np.ones(n, dtype=np.float64)
    diag[coo.row[dmask]] = coo.val[dmask]
    has_diag = np.zeros(n, dtype=bool)
    has_diag[coo.row[dmask]] = True
    if not has_diag.all():
        missing = int(n - has_diag.sum())
        raise ValueError(
            f"triangular matrix has {missing} row(s) with no stored diagonal "
            "entry — store an explicit diagonal (unit-diagonal factors must "
            "store their 1.0s, as ops.ilu does)")
    if np.any(diag == 0):
        raise ValueError("singular triangular matrix (zero diagonal)")

    orow, ocol, oval = coo.row[off], coo.col[off], coo.val[off]
    # Dependency levels: level[r] = 1 + max level over r's off-diag columns,
    # computed in topological (row) order — native C++ pass when available
    # (core/native/factor_native.cpp), python fallback otherwise.
    rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(orow, minlength=n), out=rp[1:])

    from ..core import native

    level = native.tri_levels(rp, ocol.astype(np.int64), lower=lower)
    if level is None:
        level = np.zeros(n, dtype=np.int64)
        order = np.arange(n) if lower else np.arange(n)[::-1]
        for r in order:
            deps = ocol[rp[r]: rp[r + 1]]
            if deps.size:
                level[r] = level[deps].max() + 1
    n_levels = int(level.max(initial=0)) + 1

    counts = np.bincount(level, minlength=n_levels)
    rows_per = max(1, int(counts.max(initial=1)))
    k = max(1, int(np.bincount(orow, minlength=n).max(initial=1)))

    # Vectorized level packing: rows grouped by level (stable ⇒ ascending row
    # within a level), pos_of = index within the level.
    order2 = np.argsort(level, kind="stable")
    starts = np.zeros(n_levels, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[order2] = np.arange(n) - starts[level[order2]]
    level_rows = np.full((n_levels, rows_per), n, dtype=np.int64)
    level_rows[level, pos_of] = np.arange(n)

    col = np.zeros((n_levels, rows_per, k), dtype=np.int64)
    val = np.zeros((n_levels, rows_per, k), dtype=np.float64)
    within = np.arange(len(orow)) - rp[orow]
    col[level[orow], pos_of[orow], within] = ocol
    val[level[orow], pos_of[orow], within] = oval

    dlev = np.ones((n_levels, rows_per), dtype=np.float64)
    dlev[level, pos_of] = diag

    import jax.numpy as jnp

    dt = cfg.np_dtype
    return TriSolveplan(
        n_row=n, n_levels=n_levels, rows_per_level=rows_per, k=k,
        level_rows=jnp.asarray(level_rows, dtype=jnp.int32),
        col=jnp.asarray(col, dtype=jnp.int32),
        val=jnp.asarray(val.astype(dt)),
        diag=jnp.asarray(dlev.astype(dt)),
        lower=lower,
    )


def solve(plan: TriSolveplan, b):
    """Substitution: one masked rectangular FMA step per level."""
    import jax
    import jax.numpy as jnp

    b = jnp.asarray(b)
    n = plan.n_row
    y0 = jnp.zeros((n + 1,), b.dtype)  # slot n = ghost

    def body(lv, y):
        rows = plan.level_rows[lv]                    # (rows_per,)
        cols = plan.col[lv]                           # (rows_per, k)
        vals = plan.val[lv]
        acc = (vals * y[cols]).sum(axis=-1)           # Σ L[r,c]·y[c]
        br = jnp.where(rows < n, b[jnp.minimum(rows, n - 1)], 0.0)
        yr = (br - acc) / plan.diag[lv]
        return y.at[rows].set(jnp.where(rows < n, yr, y[rows]))

    y = jax.lax.fori_loop(0, plan.n_levels, body, y0)
    return y[:n]


def sptrsv(coo: COOMatrix, b, cfg: Config = None, *, lower: bool = True):
    """One-shot analyze + solve (prefer caching the plan for repeated solves)."""
    return solve(analyze(coo, cfg, lower=lower), b)
