#!/usr/bin/env python3
"""Smoke test of the SpMV benchmark path on one NVIDIA GPU.

    python3 chip_smoke.py            # phases 0-4 on one card
    python3 chip_smoke.py --multi    # phase 5 only, on four cards

Phases (one process, which owns the card; ``nvidia-smi`` is its only child):

0. device: a GPU is required (exit 2 otherwise, no result line); prints the
   device kind and count, the JAX version, XLA_FLAGS, the card's name and
   power limit, and the compile-cache directory;
1. calibration: the planner's four rates for this device (measured on first
   use), then the raw gather (10^8 random int32 indices), sorted scatter-add
   and large-copy rates;
2. main path: ``run_benchmark(format="auto")`` on the raefsky3, circuit5M and
   cage15 stand-ins in float32 and raefsky3 and cage15 in float64, at their
   published sizes, each verified against the float64 oracle; a candidate that
   died on its first run (``AutoExcluded``) fails the phase;
3. every kept format on raefsky3 in float32 and float64 through the same
   driver, with a bitwise-repeat check per format, and csr timed against the
   library path (bcoo) on all three stand-ins;
4. solver: 50 CG iterations in float64 on a 128^3 7-point Laplacian, checked
   against the same iteration run with scipy.sparse;
5. ``--multi``: DistSpMV (2x2 and 4x1 meshes) and HaloSpMV (4x1) on four cards
   with cage15 in float32, against the oracle and beside the one-card csr time.

The last line of stdout is ``{"ok": true, "device": {...}}``, printed only when
every phase passed; any failure exits 1 without it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

MAIN_CASES = [("raefsky3", "float32"), ("circuit5M", "float32"),
              ("cage15", "float32"), ("raefsky3", "float64"),
              ("cage15", "float64")]
STANDINS = ("raefsky3", "circuit5M", "cage15")
KEPT_FORMATS = ("coo", "csr", "ell", "jds", "dia", "ss", "css", "csr5", "bsr",
                "dense", "bcoo", "hostlib", "hyb", "auto")
GATHER_N = 10 ** 8
STREAM_N = 1 << 28
SOLVER_GRID = 128
SOLVER_ITERS = 50
# timing windows: enough for a stable median, short enough for one cold run
TIMING = dict(calibrate_seconds=0.2, n_trials=3)


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    """Collects phase failures; ``ok`` is False once any check failed."""

    def __init__(self):
        self.failures = []
        self._cache = {}

    def fail(self, what: str) -> None:
        self.failures.append(what)
        log(f"FAIL: {what}")

    @property
    def ok(self) -> bool:
        return not self.failures

    def matrix(self, name, make=None):
        """Stand-in ``name`` at its published size (generated once, seed 0)."""
        if name not in self._cache:
            from singlespmv_tpu.data.structgen import synthesize_structured

            t0 = time.perf_counter()
            self._cache[name] = (make or (lambda: synthesize_structured(
                name, seed=0)))()
            coo = self._cache[name]
            log(f"  generated {name}: {coo.n_row} rows, {coo.nnz} nnz "
                f"in {time.perf_counter() - t0:.1f}s")
        return self._cache[name]

    def bench(self, coo, cfg, name, **kw):
        """run_benchmark with the smoke's timing window; None on error."""
        from singlespmv_tpu.harness.driver import run_benchmark

        try:
            res = run_benchmark(coo, cfg.replace(**TIMING), name=name,
                                log=lambda m: None, **kw)
        except Exception as e:  # noqa: BLE001 — report, then fail the phase
            traceback.print_exc(file=sys.stdout)
            self.fail(f"{name} {cfg.format}/{cfg.dtype}: "
                      f"{type(e).__name__}: {str(e)[:200]}")
            return None
        r = res.report
        log(f"  {name:10s} {cfg.dtype:7s} {cfg.format:7s} -> "
            f"{r.get('ChosenFormat', r['MatrixFormat']):6s} "
            f"{res.gflops:9.3f} GFLOP/s  t={res.seconds * 1e6:10.2f} us  "
            f"verify={r['Verify']} maxrel={r.get('MaxRelErr', float('nan')):.3g} "
            f"tol={r.get('VerifyTol', float('nan')):.3g}  "
            f"calib={r['CalibrateTime(s)']:.2f}s "
            f"convert={r['OptimizeTime(s)']:.2f}s "
            f"compile={r['CompileTime(s)']:.2f}s  "
            f"mem(arg/out/temp)={r.get('ArgBytes')}/{r.get('OutBytes')}/"
            f"{r.get('TempBytes')}  on={r['Architecture']}")
        if not res.verify_ok:
            self.fail(f"{name} {cfg.format}/{cfg.dtype}: verify FAIL "
                      f"(maxrel {r.get('MaxRelErr')} > tol {r.get('VerifyTol')})")
        return res


# ------------------------------------------------------------------ phases --

def require_gpu():
    """The first JAX device if it is a GPU, else None (and the reason)."""
    try:
        import singlespmv_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the package is not importable here ({e})",
              file=sys.stderr)
        return None
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{dev.platform} ({dev.device_kind})", file=sys.stderr)
        return None
    return dev


def phase_device(smoke: Smoke) -> None:
    import jax

    from singlespmv_tpu.core import compile_cache
    from singlespmv_tpu.harness.roofline import card_line, detect_chip

    log("== phase 0: device")
    dev = jax.devices()[0]
    log(f"  device_kind={dev.device_kind!r} platform={dev.platform} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    log(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"  compile cache: {compile_cache.setup()}")
    log(f"  card: {card_line()}")
    try:
        chip = detect_chip()
        log(f"  roofline peaks: {chip}")
    except KeyError as e:
        smoke.fail(f"roofline table: {e}")


def phase_calibration(smoke: Smoke, gather_n=GATHER_N, stream_n=STREAM_N):
    from singlespmv_tpu.core import chipconst
    from singlespmv_tpu.harness import microbench as mb

    log("== phase 1: calibration")
    t0 = time.perf_counter()
    c = chipconst.constants(log=log)
    log(f"  planner rates [{chipconst.device_kind()}] "
        f"({time.perf_counter() - t0:.1f}s): "
        f"hbm_bps={c['hbm_bps']:.6g} gather_rate={c['gather_rate']:.6g} "
        f"scatter_rate={c['scatter_rate']:.6g} "
        f"matmul_flops={c['matmul_flops']:.6g}")
    out = {}
    for label, probe, n, unit in (
            ("gather x[col] (random int32)", mb.probe_gather, gather_n, "elem"),
            ("scatter-add (sorted segment_sum)", mb.probe_scatter, gather_n,
             "elem"),
            ("copy (a + 1, float32)", mb.probe_copy, stream_n, "elem")):
        elems, sec = probe(n)
        rate = elems / sec
        out[label] = rate
        extra = f" = {8 * rate / 1e9:.1f} GB/s" if label.startswith("copy") \
            else ""
        log(f"  {label:34s} n={elems}: {sec * 1e3:.3f} ms, "
            f"{rate / 1e9:.3f} G {unit}/s{extra}")
        if not (np.isfinite(rate) and rate > 0):
            smoke.fail(f"calibration probe {label}: rate {rate}")
    return out


def phase_main_path(smoke: Smoke, cases=MAIN_CASES, make=None):
    from singlespmv_tpu.config import Config

    log("== phase 2: main path (format=auto)")
    for name, dtype in cases:
        coo = smoke.matrix(name, make and (lambda: make(name)))
        res = smoke.bench(coo, Config(format="auto", dtype=dtype), name)
        if res is None:
            continue
        log(f"    AutoExcluded={res.report['AutoExcluded']}")
        if res.auto_excluded:
            smoke.fail(f"{name}/{dtype}: auto excluded {res.auto_excluded}")


def _repeat_identical(coo, cfg) -> bool:
    """Two calls of one compiled spmv on the same input: bitwise equal?"""
    import jax

    from singlespmv_tpu import formats
    from singlespmv_tpu.core.rng import create_random_vector

    prev = jax.config.jax_enable_x64
    if cfg.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        state = formats.convert(coo, cfg)
        dev = getattr(formats.get_format(cfg.format), "PREFERRED_DEVICE", None)
        x = create_random_vector(coo.n_col).astype(cfg.np_dtype)
        x = jax.device_put(x, jax.devices(dev)[0] if dev else None)
        f = jax.jit(formats.spmv_fn(cfg))
        y1 = np.asarray(f(state, x))
        y2 = np.asarray(f(state, x))
        return bool(np.array_equal(y1, y2))
    finally:
        jax.config.update("jax_enable_x64", prev)


def phase_formats(smoke: Smoke, fmt_matrix="raefsky3", standins=STANDINS,
                  formats_=KEPT_FORMATS, make=None, dense_n=4096):
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.data.generators import generate

    log(f"== phase 3: every kept format on {fmt_matrix}")
    coo = smoke.matrix(fmt_matrix, make and (lambda: make(fmt_matrix)))
    dense_coo = None
    for dtype in ("float32", "float64"):
        for fmt in formats_:
            cfg = Config(format=fmt, dtype=dtype)
            mat, name = coo, fmt_matrix
            if fmt == "dense":
                from singlespmv_tpu.formats.dense import MAX_DENSE_ELEMENTS

                if coo.n_row * coo.n_col > MAX_DENSE_ELEMENTS:
                    # the dense baseline refuses a matrix this wide by design;
                    # run it on a dense matrix it is meant for
                    dense_coo = dense_coo or generate("dense", dense_n, seed=3)
                    mat, name = dense_coo, f"dense-{dense_n}"
            if smoke.bench(mat, cfg, name) is None:
                continue
            try:
                same = _repeat_identical(mat, cfg)
                log(f"    bitwise repeat ({fmt}/{dtype}): "
                    f"{'identical' if same else 'DIFFERS (atomic order)'}")
            except Exception as e:  # noqa: BLE001
                smoke.fail(f"repeat check {fmt}/{dtype}: {type(e).__name__}: "
                           f"{e}")
    log("== phase 3b: csr vs bcoo (library path), float32")
    for name in standins:
        mat = smoke.matrix(name, make and (lambda n=name: make(n)))
        times = {}
        for fmt in ("csr", "bcoo"):
            res = smoke.bench(mat, Config(format=fmt, dtype="float32"), name)
            if res is not None:
                times[fmt] = res.seconds
        if len(times) == 2:
            log(f"    {name}: csr {times['csr'] * 1e6:.2f} us, bcoo "
                f"{times['bcoo'] * 1e6:.2f} us, csr/bcoo time ratio "
                f"{times['csr'] / times['bcoo']:.3f}")


def laplacian_7pt(n: int):
    """SPD 7-point Laplacian on an n^3 grid (Dirichlet): 6 on the diagonal,
    -1 to each grid neighbour."""
    from singlespmv_tpu.core.types import COOMatrix

    idx = np.arange(n ** 3, dtype=np.int64).reshape(n, n, n)
    rows, cols = [idx.ravel()], [idx.ravel()]
    for axis in range(3):
        for shift in (1, -1):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            src[axis] = slice(max(shift, 0), n + min(shift, 0))
            dst[axis] = slice(max(-shift, 0), n + min(-shift, 0))
            rows.append(idx[tuple(src)].ravel())
            cols.append(idx[tuple(dst)].ravel())
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.where(r == c, 6.0, -1.0)
    return COOMatrix.from_triplets(n ** 3, n ** 3, r, c, v, sort=True)


def cg_reference(coo, b, iters):
    """The same CG recurrence with scipy.sparse CSR in float64."""
    import scipy.sparse as sp

    a = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=(coo.n_row,
                                                           coo.n_col))
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rz = r @ r
    for _ in range(iters):
        ap = a @ p
        alpha = rz / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rz_new = r @ r
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x, float(np.linalg.norm(r))


def phase_solver(smoke: Smoke, grid=SOLVER_GRID, iters=SOLVER_ITERS):
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.ops.solvers import cg

    log(f"== phase 4: CG, {iters} iterations, float64, {grid}^3 7-point "
        "Laplacian")
    t0 = time.perf_counter()
    coo = laplacian_7pt(grid)
    b = np.random.default_rng(0).uniform(-1.0, 1.0, coo.n_row)
    log(f"  built {coo.n_row} rows, {coo.nnz} nnz in "
        f"{time.perf_counter() - t0:.1f}s")
    try:
        t0 = time.perf_counter()
        res = cg(coo, b, cfg=Config(format="auto", dtype="float64",
                                    verify=False), tol=0.0, maxiter=iters)
        t_dev = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001
        traceback.print_exc(file=sys.stdout)
        smoke.fail(f"cg: {type(e).__name__}: {e}")
        return
    x_ref, res_ref = cg_reference(coo, b, iters)
    rel_res = abs(res.residual - res_ref) / res_ref
    rel_x = np.linalg.norm(res.x - x_ref) / np.linalg.norm(x_ref)
    log(f"  device: {res.iterations} iterations, |r|={res.residual:.10e} "
        f"({t_dev:.1f}s incl. convert+compile); scipy: |r|={res_ref:.10e}; "
        f"rel diff |r| {rel_res:.3g}, x {rel_x:.3g} (tol 1e-6)")
    if res.iterations != iters or not (rel_res <= 1e-6 and rel_x <= 1e-6):
        smoke.fail(f"cg: iterations {res.iterations}, rel |r| diff {rel_res}, "
                   f"rel x diff {rel_x}")


def _time_jitted(fn, *args, reps=20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_multi(smoke: Smoke, name="cage15", make=None, n_dev=4):
    import jax
    import jax.numpy as jnp

    from singlespmv_tpu.config import Config
    from singlespmv_tpu.core.oracle import verify_result
    from singlespmv_tpu.core.rng import create_random_vector
    from singlespmv_tpu.parallel import DistSpMV, HaloSpMV, make_mesh

    log(f"== phase 5: distributed SpMV on {n_dev} devices, {name} float32")
    if len(jax.devices()) < n_dev:
        smoke.fail(f"--multi needs {n_dev} devices, have {len(jax.devices())}")
        return
    coo = smoke.matrix(name, make and (lambda: make(name)))
    one = smoke.bench(coo, Config(format="csr", dtype="float32"), name)
    t_one = one.seconds if one is not None else float("nan")
    x = create_random_vector(coo.n_col).astype(np.float32)
    xd = jnp.asarray(x)
    cfg = Config(format="ss", dtype="float32")
    half = max(n_dev // 2, 1)
    ops = [
        (f"DistSpMV {half}x{n_dev // half}",
         lambda: DistSpMV.convert(coo, cfg, make_mesh(
             (("row", half), ("col", n_dev // half)))),
         lambda op: (op._jitted, (op.col, op.val, op.heads, op.end_pos,
                                  op.rank_rows, op.perm, xd))),
        (f"DistSpMV {n_dev}x1",
         lambda: DistSpMV.convert(coo, cfg, make_mesh(
             (("row", n_dev), ("col", 1)))),
         lambda op: (op._jitted, (op.col, op.val, op.heads, op.end_pos,
                                  op.rank_rows, op.perm, xd))),
        (f"HaloSpMV {n_dev}x1",
         lambda: HaloSpMV.convert(coo, cfg, make_mesh((("row", n_dev),))),
         lambda op: (op._jitted, (op.local_state, op.halo_state, op.send_idx,
                                  op.perm, xd))),
    ]
    for label, build, call in ops:
        try:
            t0 = time.perf_counter()
            op = build()
            t_conv = time.perf_counter() - t0
            fn, args = call(op)
            y = np.asarray(fn(*args))
            ok, det = verify_result(coo, x, y, dtype=np.float32)
            sec = _time_jitted(fn, *args)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc(file=sys.stdout)
            smoke.fail(f"{label}: {type(e).__name__}: {str(e)[:200]}")
            continue
        log(f"  {label:16s} convert={t_conv:.1f}s  t={sec * 1e6:10.2f} us "
            f"({2.0 * coo.nnz / sec / 1e9:.3f} GFLOP/s)  one-card csr "
            f"t={t_one * 1e6:.2f} us  verify={'PASS' if ok else 'FAIL'} "
            f"maxrel={det['max_rel_err']:.3g} tol={det['tol']:.3g}")
        if not ok:
            smoke.fail(f"{label}: verify FAIL {det}")


# -------------------------------------------------------------------- main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card distributed phase")
    args = ap.parse_args(argv)
    dev = require_gpu()
    if dev is None:
        return 2
    import jax

    smoke = Smoke()
    t_start = time.perf_counter()
    phase_device(smoke)
    if args.multi:
        phases = [phase_multi]
    else:
        phases = [phase_calibration, phase_main_path, phase_formats,
                  phase_solver]
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase(smoke)
        except Exception as e:  # noqa: BLE001 — a phase crash fails the run
            traceback.print_exc(file=sys.stdout)
            smoke.fail(f"{phase.__name__}: {type(e).__name__}: {e}")
        log(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f}s)")
    log(f"total {time.perf_counter() - t_start:.1f}s; "
        f"{len(smoke.failures)} failure(s)")
    from singlespmv_tpu.harness.roofline import card_line

    log(card_line())        # name and power limit, as nvidia-smi gives them
    if not smoke.ok:
        for f in smoke.failures:
            log(f"FAILED: {f}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
