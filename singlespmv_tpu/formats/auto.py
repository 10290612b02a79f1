"""`auto` — structure-adaptive format selection.

The reference compiles one binary per format and sweeps them (Makefile:10-21,
script/gen_todo.sh); here the format choice is a runtime planning problem.
``estimate_costs`` prices each XLA-level candidate from the matrix structure and
four rates measured on the attached device (``core/chipconst``: streamed bytes/s,
random-gather and sorted scatter-add elements/s, matrix-product flop/s):

- dia streams one dense diagonal per distinct offset (no index arrays), so it
  wins on banded matrices and explodes on scattered ones;
- dense streams the whole matrix when it fits;
- bsr streams dense (bm x bn) blocks; its cost grows as block fill drops;
- ell gathers K = max-row-length slots per row (bounded padding only);
- csr / ss gather x[col] per nonzero and scatter-add per row (csr sorted
  segment-sum, ss a segmented scan first); csr runs every structure;
- hyb peels dense diagonals into dia and prices its residual recursively.

On a device, the close candidates are then converted and timed briefly
(``convert``), and the fastest is kept.  The chosen format's name is surfaced in
report_fields (the block shows both ``MatrixFormat AUTO`` and ``ChosenFormat``).
"""
from __future__ import annotations

import math

import numpy as np

from ..config import Config
from ..core import chipconst
from ..core import hostmem as hm
from ..core.types import COOMatrix, round_up
from . import bsr as bsr_mod
from . import coo as coo_mod
from . import csr as csr_mod
from . import dense as dense_mod
from . import dia as dia_mod
from . import ell as ell_mod
from . import hyb as hyb_mod
from . import ss as ss_mod

STATE_REV = 4   # bump with planner/layout revisions (4: XLA-level candidates)


def _stats(coo: COOMatrix, cfg: Config):
    vsz = np.dtype(cfg.dtype).itemsize
    # past 20 M nnz the exact uniques cost seconds of sorts; a strided
    # sample scaled by the sampling factor ranks the same formats (distinct
    # counts scale sublinearly, so the scaled value over-counts — conservative
    # for dia/bsr, which only matters when they were hopeless anyway)
    SAMP = 20_000_000
    if coo.nnz > SAMP:
        step = coo.nnz // (SAMP // 4)
        row = coo.row[::step].astype(np.int64)
        col = coo.col[::step].astype(np.int64)
        scale = coo.nnz / len(row)
    else:
        row = coo.row.astype(np.int64)
        col = coo.col.astype(np.int64)
        scale = 1.0
    n_diag = int(len(hm.unique(col - row)) * scale) if coo.nnz else 1
    bm, bn = max(8, cfg.row_block), cfg.lane_width
    blocks = int(len(hm.unique((row // bm) * (2 ** 32) + col // bn))
                 * scale) if coo.nnz else 1
    return vsz, n_diag, blocks


def estimate_costs(coo: COOMatrix, cfg: Config, _inner: bool = False,
                   consts: dict = None) -> dict:
    """Seconds per SpMV by format, from the measured-rate model.

    ``consts`` defaults to the attached device's calibrated rates (measured on
    first use, ``core/chipconst``).  ``_inner`` marks the recursive call used
    to cost hyb's residual (no hyb-in-hyb)."""
    c = consts or chipconst.constants()
    hbm, gather, scatter, flops = (c["hbm_bps"], c["gather_rate"],
                                   c["scatter_rate"], c["matmul_flops"])
    vsz, n_diag, blocks = _stats(coo, cfg)
    n, m, nnz = coo.n_row, coo.n_col, max(coo.nnz, 1)
    costs = {}
    dia_elems = n_diag * max(n, 1)
    if dia_elems * vsz <= (4 << 30):      # matches dia.MAX_DIA_ELEMENTS
        costs["dia"] = 2 * dia_elems * vsz / hbm
    dense_elems = n * m
    if dense_elems * vsz <= (1 << 30):
        costs["dense"] = dense_elems * vsz / hbm
    bm, bn = max(8, cfg.row_block), cfg.lane_width
    bsr_elems = blocks * bm * bn
    if bsr_elems <= max(32 * nnz, 1 << 22) and bsr_elems * vsz <= (2 << 30):
        # mirrors bsr's guard: stream the blocks and their x rows, then a
        # sorted segment-sum over the block rows
        costs["bsr"] = ((bsr_elems + blocks * bn) * vsz / hbm
                        + blocks * bm / scatter)
    k = int(coo.row_lengths().max(initial=0))
    ell_slots = max(k, 1) * round_up(max(n, 1), cfg.lane_width)
    if ell_slots <= 4 * nnz + (1 << 16):
        costs["ell"] = ell_slots / gather + ell_slots * vsz / hbm
    costs["csr"] = nnz / gather + nnz / scatter
    costs["coo"] = costs["csr"]             # the same gather + sorted segment-sum
    # ss: the same gather, then a log2(W)-step segmented scan over the stream
    # and a scatter-add of the per-row partials
    w = max(cfg.lane_width, round_up(cfg.segment_width, cfg.lane_width))
    costs["ss"] = (nnz / gather + math.ceil(math.log2(w)) * 2 * nnz * vsz / hbm
                   + (n + nnz / w) / scatter)

    # SpMM-aware planning: a B-column dense panel amortizes the sparse index
    # streams; the matrix-product formats (dense/bsr) grow only by the panel
    # flops and the X gather, while vmap-based formats pay the full B×
    # (SURVEY §7.6 "x→(nCol,B) panel").
    if cfg.spmm_b and cfg.spmm_b > 1:
        b = cfg.spmm_b
        for f in list(costs):
            if f == "dense":
                costs[f] = dense_elems * vsz / hbm + dense_elems * b * 2.0 / flops
            elif f == "bsr":
                costs[f] = ((bsr_elems + blocks * bn * b) * vsz / hbm
                            + bsr_elems * b * 2.0 / flops
                            + blocks * bm * b / scatter)
            else:
                costs[f] = costs[f] * b

    # hyb: dense-diagonal peel (dia stream) + residual, costed exactly by
    # splitting off the peel and recursing on the leftover matrix.
    if not _inner:
        bscale = max(cfg.spmm_b, 1)     # hyb runs vmap spmm: B× both parts
        est_h = hyb_mod.estimate(coo, cfg, consts=c)
        if est_h["feasible"]:
            if est_h["resid_nnz"] == 0:
                # pure-diagonal matrix: plain dia covers it; only offer hyb
                # when dia itself is infeasible (peel subset under the guard)
                if "dia" not in costs:
                    costs["hyb"] = bscale * est_h["dia_sec"]
            else:
                _, rest = hyb_mod._split(coo, est_h["peel_offs"], cfg)
                rcosts = estimate_costs(rest, cfg, _inner=True, consts=c)
                rbest = min((v for f, v in rcosts.items()
                             if f in hyb_mod._rest_modules()), default=None)
                if rbest is not None:
                    # two dispatches and the y-add pass: one extra read and
                    # write of y
                    costs["hyb"] = (bscale * est_h["dia_sec"] + rbest
                                    + 3 * n * vsz / hbm)
    return costs


def choose(coo: COOMatrix, cfg: Config) -> str:
    costs = estimate_costs(coo, cfg)
    return min(costs, key=costs.get)


_MODULES = {"dia": dia_mod, "dense": dense_mod, "bsr": bsr_mod,
            "ell": ell_mod, "csr": csr_mod, "coo": coo_mod, "ss": ss_mod,
            "hyb": hyb_mod}


class AutoState:
    """Wrapper pairing the chosen module with its state (pytree via registration).

    ``failed`` names the candidates that raised while ``convert`` built or
    timed them (``name:ExceptionType``), so the report can show them."""

    def __init__(self, chosen: str, inner, failed: tuple = ()):
        self.chosen = chosen
        self.inner = inner
        self.failed = tuple(failed)

    @property
    def n_row(self):
        return self.inner.n_row

    @property
    def n_col(self):
        return self.inner.n_col

    @property
    def nnz(self):
        return self.inner.nnz


import jax  # noqa: E402

jax.tree_util.register_pytree_node(
    AutoState,
    lambda s: ((s.inner,), (s.chosen, s.failed)),
    lambda aux, ch: AutoState(aux[0], ch[0], aux[1]),
)


TRIAL_NNZ_CAP = 20_000_000   # past this a spare candidate conversion costs
#                              minutes of host time: trust the model
TRIAL_SPREAD = 2.5           # try every candidate whose estimate is within
#                              this factor of the best estimate
TRIAL_MAX = 3                # at most this many measured candidates


def _quick_bench(mod, state, n_col, dtype) -> float:
    """Seconds per spmv — median of 3 chained-loop marginals at >= 0.35 s
    windows (the driver's methodology): a min of short-window marginals lets
    one noisy run fabricate a too-good number that auto would then keep."""
    import time as _time

    import jax.numpy as jnp

    from ..harness.driver import make_chained_runner

    x = jnp.asarray(np.linspace(-1.0, 1.0, max(n_col, 1), dtype=dtype))
    run_n = make_chained_runner(lambda s, a: mod.spmv(s, a), x)
    jax.block_until_ready(run_n(state, x, jnp.int32(1)))
    loop = 2
    while loop < (1 << 16):
        t0 = _time.perf_counter()
        jax.block_until_ready(run_n(state, x, jnp.int32(loop)))
        if _time.perf_counter() - t0 >= 0.35:
            break
        loop *= 2
    pers = []
    for _ in range(3):
        half = max(loop // 2, 1)
        t0 = _time.perf_counter()
        jax.block_until_ready(run_n(state, x, jnp.int32(half)))
        t1 = _time.perf_counter()
        jax.block_until_ready(run_n(state, x, jnp.int32(loop)))
        t2 = _time.perf_counter()
        margin = (t2 - t1) - (t1 - t0)
        per = margin / (loop - half) if margin > 0 else \
            (t2 - t0) / (loop + half)
        pers.append(per)
    return float(np.median(pers))


def convert(coo: COOMatrix, cfg: Config, log=None) -> AutoState:
    import os
    import sys

    if log is None and os.environ.get("SPMV_AUTO_LOG"):
        log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    costs = estimate_costs(coo, cfg)
    for ex in cfg.auto_exclude:
        costs.pop(ex, None)
    failed = []

    def _fail(chosen, e):
        failed.append(f"{chosen}:{type(e).__name__}")
        if log:
            log(f"auto: {chosen} failed ({type(e).__name__}: {e}); next")

    ranked = sorted(costs, key=costs.get)
    # measured auto-tuning (the reference's per-format sweep, done online):
    # when several formats are within TRIAL_SPREAD of the model's best,
    # convert them and time each briefly on the device; keep the winner.
    on_device = jax.default_backend() != "cpu"
    trial = [f for f in ranked[:TRIAL_MAX]
             if costs[f] <= costs[ranked[0]] * TRIAL_SPREAD]
    last_err = None
    if on_device and coo.nnz and coo.nnz <= TRIAL_NNZ_CAP and len(trial) > 1:
        best = None
        for chosen in trial:
            try:
                st = _MODULES[chosen].convert(coo, cfg)
                sec = _quick_bench(_MODULES[chosen], st, coo.n_col,
                                   cfg.np_dtype)
                if log:
                    log(f"auto: measured {chosen}: {sec * 1e6:.0f} us "
                        f"(est {costs[chosen] * 1e6:.0f} us)")
                if best is None or sec < best[0]:
                    best = (sec, chosen, st)
                else:
                    del st
            except (ValueError, TypeError, RuntimeError, MemoryError) as e:
                last_err = e
                _fail(chosen, e)
        if best is not None:
            return AutoState(best[1], best[2], failed)
        # every trial candidate failed: fall through to the remaining ranks
        ranked = [f for f in ranked if f not in trial]

    for chosen in ranked:
        if log:
            log(f"auto: trying {chosen} (est {costs[chosen] * 1e6:.0f} us)")
        try:
            return AutoState(chosen, _MODULES[chosen].convert(coo, cfg), failed)
        # ValueError/TypeError: a guard refused.  RuntimeError/MemoryError:
        # device out-of-memory or compile failure at convert time (jax's
        # JaxRuntimeError subclasses RuntimeError) — fall through to the
        # next candidate, and keep the failure in ``failed``.
        except (ValueError, TypeError, RuntimeError, MemoryError) as e:
            last_err = e
            _fail(chosen, e)
    raise last_err if last_err else ValueError("auto: no viable format")


def spmv(state: AutoState, x):
    return _MODULES[state.chosen].spmv(state.inner, x)


def spmm(state: AutoState, X):
    mod = _MODULES[state.chosen]
    native = getattr(mod, "spmm", None)
    if native is not None:
        return native(state.inner, X)
    return jax.vmap(mod.spmv, in_axes=(None, 1), out_axes=1)(state.inner, X)


def to_coo(state: AutoState) -> COOMatrix:
    return _MODULES[state.chosen].to_coo(state.inner)


def report_fields(state: AutoState, cfg: Config) -> dict:
    mod = _MODULES[state.chosen]
    out = {"ChosenFormat": state.chosen.upper()}
    fn = getattr(mod, "report_fields", None)
    if fn:
        out.update(fn(state.inner, cfg))
    return out


def traffic_bytes(state: AutoState, cfg: Config) -> int:
    mod = _MODULES[state.chosen]
    fn = getattr(mod, "traffic_bytes", None)
    if fn:
        return int(fn(state.inner, cfg))
    m, nnz = state.n_row, state.nnz
    vsz = np.dtype(cfg.dtype).itemsize
    return (m + 1 + nnz) * 4 + (2 * nnz + m) * vsz
