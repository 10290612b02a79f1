"""HYB — dense-diagonal peel + scattered residual.

Many of the reference's 26 SuiteSparse matrices are *mixtures*: dense or
near-dense diagonal stripes (3-D stencils, circuit diagonals, spectral bands,
Jacobian coupling stripes) carrying 20-100% of the nnz, plus a scattered
remainder.  A dense diagonal streams with *zero index arrays* (``formats.dia``:
static shifted slices of x), while a scattered nonzero pays a random gather of
x and a scatter-add.  So the structure-adaptive move is to split the matrix by
diagonal density and give each part its own format:

- every diagonal offset whose nnz count clears a cost threshold (the dia
  stream cost of the diagonal against the gather + scatter cost of its nnz,
  both from the device's calibrated rates, ``core/chipconst``) is peeled into
  a DIA table;
- the residual rides the cheapest of csr / coo / ell / bsr, chosen by the same
  cost model ``formats.auto`` uses.

This is the classic GPU HYB (ELL+COO) split re-cut along the axis of streamed
vs gathered data instead of row regularity.  Reference context: DIA kernel
`src/opt_dia.cpp:75-92`, format sweep `script/gen_todo.sh` (the reference
benchmarks formats one at a time; the hybrid is this rebuild's own contribution).
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core import chipconst
from ..core.types import COOMatrix, round_up
from . import dia as dia_mod
from .base import pytree_dataclass

MAX_PEEL_ELEMENTS = 1 << 28  # respect dia's density guard (1 GiB of f32)


def _diag_histogram(coo: COOMatrix):
    """Offset histogram of col-row; returns (offsets, counts) sorted by count
    descending."""
    if not coo.nnz:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    offs = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return uniq[order], counts[order]


def _rates(cfg: Config, consts):
    """(seconds per peeled diagonal slot, seconds per residual nonzero)."""
    c = consts or chipconst.constants()
    vsz = np.dtype(cfg.dtype).itemsize
    return (2 * vsz / c["hbm_bps"],
            1.0 / c["gather_rate"] + 1.0 / c["scatter_rate"])


def plan_peel(coo: COOMatrix, cfg: Config, consts: dict = None):
    """Greedy diagonal selection: peel offsets (densest first) while the DIA
    stream cost of one more diagonal is below the scattered-path cost of its
    nnz, within dia's memory guard.  Returns (peel_offsets, peel_nnz)."""
    uniq, counts = _diag_histogram(coo)
    slot_s, nnz_s = _rates(cfg, consts)
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    max_diags = max(0, int(MAX_PEEL_ELEMENTS // max(n_row_pad, 1)))
    keep = counts * nnz_s > n_row_pad * slot_s
    n_keep = min(int(keep.sum()), max_diags)
    return uniq[:n_keep], int(counts[:n_keep].sum())


def estimate(coo: COOMatrix, cfg: Config, consts: dict = None) -> dict:
    """Convert-free cost probe for formats.auto: seconds per SpMV if hyb is
    chosen, or infeasible when no diagonal clears the peel threshold."""
    peel_offs, peel_nnz = plan_peel(coo, cfg, consts)
    resid_nnz = coo.nnz - peel_nnz
    feasible = peel_offs.size > 0 and peel_nnz >= max(coo.nnz // 8, 1)
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    slot_s, _ = _rates(cfg, consts)
    dia_sec = peel_offs.size * n_row_pad * slot_s
    return {"feasible": feasible, "n_diag": int(peel_offs.size),
            "peel_offs": peel_offs, "peel_nnz": peel_nnz,
            "resid_nnz": int(resid_nnz), "dia_sec": dia_sec}


def _split(coo: COOMatrix, peel_offs: np.ndarray, cfg: Config):
    offs = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    on_diag = np.isin(offs, peel_offs)
    dia_coo = COOMatrix.from_triplets(
        coo.n_row, coo.n_col, coo.row[on_diag], coo.col[on_diag],
        coo.val[on_diag], index_bits=cfg.index_bits, sort=True)
    rest_coo = COOMatrix.from_triplets(
        coo.n_row, coo.n_col, coo.row[~on_diag], coo.col[~on_diag],
        coo.val[~on_diag], index_bits=cfg.index_bits, sort=True)
    return dia_coo, rest_coo


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "rest_fmt", "peel_nnz"))
class HYBState:
    n_row: int
    n_col: int
    nnz: int
    rest_fmt: str        # "" when the residual is empty
    peel_nnz: int
    dia_state: object    # DIAState
    rest_state: object   # scattered-format state or None


def _rest_modules():
    from . import bsr as bsr_mod
    from . import coo as coo_mod
    from . import csr as csr_mod
    from . import ell as ell_mod

    return {"csr": csr_mod, "coo": coo_mod, "ell": ell_mod, "bsr": bsr_mod}


def convert(coo: COOMatrix, cfg: Config) -> HYBState:
    peel_offs, peel_nnz = plan_peel(coo, cfg)
    if peel_offs.size == 0 and coo.nnz:
        # Stay valid on any input (the planner decides when hyb is *smart*):
        # peel the densest offset so the DIA part is never empty.
        uniq, counts = _diag_histogram(coo)
        peel_offs, peel_nnz = uniq[:1], int(counts[0])
    dia_coo, rest_coo = _split(coo, peel_offs, cfg)
    dia_state = dia_mod.convert(dia_coo, cfg)
    if rest_coo.nnz == 0:
        return HYBState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                        rest_fmt="", peel_nnz=peel_nnz,
                        dia_state=dia_state, rest_state=None)
    # Residual: pick the cheapest residual format with auto's cost model
    # (dia/dense/hyb excluded — the residual has no dense stripes left).
    from .auto import estimate_costs

    costs = estimate_costs(rest_coo, cfg, _inner=True)
    mods = _rest_modules()
    last_err = None
    for name in sorted((k for k in costs if k in mods), key=costs.get):
        try:
            rest_state = mods[name].convert(rest_coo, cfg)
            return HYBState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                            rest_fmt=name, peel_nnz=peel_nnz,
                            dia_state=dia_state, rest_state=rest_state)
        except (ValueError, TypeError) as e:
            last_err = e
    raise last_err if last_err else ValueError("hyb: no viable residual format")


def spmv(state: HYBState, x):
    y = dia_mod.spmv(state.dia_state, x)
    if state.rest_fmt:
        y = y + _rest_modules()[state.rest_fmt].spmv(state.rest_state, x)
    return y


def spmm(state: HYBState, X):
    import jax

    y = jax.vmap(dia_mod.spmv, in_axes=(None, 1), out_axes=1)(state.dia_state, X)
    if state.rest_fmt:
        mod = _rest_modules()[state.rest_fmt]
        native = getattr(mod, "spmm", None)
        if native is not None:
            y = y + native(state.rest_state, X)
        else:
            y = y + jax.vmap(mod.spmv, in_axes=(None, 1), out_axes=1)(
                state.rest_state, X)
    return y


def report_fields(state: HYBState, cfg: Config) -> dict:
    out = {"PeelDiags": state.dia_state.n_diag, "PeelNnz": state.peel_nnz,
           "RestFormat": (state.rest_fmt or "none").upper(),
           "RestNnz": state.nnz - state.peel_nnz}
    if state.rest_fmt:
        fn = getattr(_rest_modules()[state.rest_fmt], "report_fields", None)
        if fn:
            out.update({f"Rest{k}": v
                        for k, v in fn(state.rest_state, cfg).items()})
    return out


def traffic_bytes(state: HYBState, cfg: Config) -> int:
    total = dia_mod.traffic_bytes(state.dia_state, cfg)
    if state.rest_fmt:
        fn = getattr(_rest_modules()[state.rest_fmt], "traffic_bytes", None)
        if fn:
            total += int(fn(state.rest_state, cfg))
    return total


def to_coo(state: HYBState) -> COOMatrix:
    dia_coo = dia_mod.to_coo(state.dia_state)
    if not state.rest_fmt:
        return dia_coo
    rest = _rest_modules()[state.rest_fmt].to_coo(state.rest_state)
    return COOMatrix.from_triplets(
        state.n_row, state.n_col,
        np.concatenate([dia_coo.row, rest.row.astype(dia_coo.row.dtype)]),
        np.concatenate([dia_coo.col, rest.col.astype(dia_coo.col.dtype)]),
        np.concatenate([dia_coo.val, rest.val]),
        sort=True, sum_duplicates=True)
