"""Benchmark driver — the L4 layer.

Re-designs the reference's benchmark main (/root/reference/src/main.cpp:17-209) as a
library function:

    load → convert ("OptimizeProblem") → verify twice → calibrate loop count
    (doubling until ≥ calibrate_seconds, main.cpp:58-71) → n_trials × loop timed
    SpMVs keeping the best trial (main.cpp:80-102) → key-value report block
    (main.cpp:109-207).

Device semantics:
- the jitted spmv is lowered and compiled once up front (compile time is reported
  separately, the analog of `make` time, not counted in the hot loop);
- a timed trial runs `loop` chained spmv calls in one executable and blocks on the
  result — back-to-back device execution, like the reference's tight loop;
- verify-twice is kept even though JAX kernels cannot corrupt their operands
  (frozen pytrees): it still catches convert-time aliasing bugs.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional

import numpy as np

from ..config import Config
from ..core.mmio import load_matrix as _load_mtx
from ..core.oracle import verify_result
from ..core.rng import create_random_vector
from ..core.timing import now
from ..core.types import COOMatrix
from .. import formats
from .report import FORMAT_NAMES, format_block, get_basename
from .roofline import detect_chip, roofline


@dataclasses.dataclass
class BenchResult:
    report: Dict[str, object]      # ordered report block (reference key schema)
    gflops: float
    seconds: float                 # best per-SpMV seconds
    loop: int
    verify_ok: bool
    y: np.ndarray                  # final output vector
    auto_excluded: tuple = ()      # format=auto candidates that died at first run

    @property
    def block(self) -> str:
        return format_block(self.report)


def _device_fields(dev) -> Dict[str, object]:
    """The device the timed loop ran on (the host CPU for hostlib)."""
    return {"Architecture": dev.platform.upper(),
            "DeviceKind": dev.device_kind}


def _memory_fields(compiled) -> Dict[str, object]:
    """Buffer sizes XLA assigned to the compiled step (bytes)."""
    mem = compiled.memory_analysis()
    if mem is None:
        return {}
    return {"ArgBytes": mem.argument_size_in_bytes,
            "OutBytes": mem.output_size_in_bytes,
            "TempBytes": mem.temp_size_in_bytes}


def make_chained_runner(fn, arg_template):
    """Jitted ``run_n(state, arg, n)``: apply fn n times ON DEVICE.

    The reference times a tight host loop of SpMV calls (main.cpp:80-102); on an
    accelerator a host loop also measures per-call dispatch, which is comparable to
    a small SpMV.  So the timed loop is a ``lax.fori_loop`` in one executable:
    each iteration perturbs the (shape-preserved) input by out[0]·tiny — a real but
    numerically negligible data dependency that stops XLA from CSE-ing the repeated
    applications.  n is a traced argument: calibration never recompiles.
    """
    import jax
    import jax.numpy as jnp

    dt = np.dtype(arg_template.dtype)
    tiny = np.finfo(dt).tiny if np.issubdtype(dt, np.floating) else 0

    @jax.jit
    def run_n(state, arg, n):
        def body(i, a):
            out = fn(state, a)
            s = out.reshape(-1)[0].astype(a.dtype)
            return a + s * jnp.asarray(tiny, a.dtype)

        return jax.lax.fori_loop(0, n, body, arg)

    return run_n


def load_matrix(path, cfg: Config) -> COOMatrix:
    return _load_mtx(path, index_bits=cfg.index_bits, sum_duplicates=True)


def run_benchmark(
    matrix,                      # path or COOMatrix
    cfg: Config = None,
    *,
    x: Optional[np.ndarray] = None,
    name: Optional[str] = None,
    quick: bool = False,         # skip calibration (tests): 1 trial × 3 iterations
    trace_dir: Optional[str] = None,   # jax.profiler trace (VTune-ITT analog,
                                       # reference main.cpp:10-12 commented hooks)
    cache_dir: Optional[str] = None,   # converted-state cache (formats/cache.py):
                                       # OptimizeTime then measures the cache load
    log=lambda msg: print(msg, file=sys.stderr),
) -> BenchResult:
    import jax

    cfg = cfg or Config()
    if isinstance(matrix, COOMatrix):
        coo, mat_name = matrix, (name or "in-memory")
    else:
        mat_name = name or get_basename(matrix)
        log(f"Loading matrix {matrix} ...")
        coo = load_matrix(matrix, cfg)

    # f64 contract: flip x64 HERE, before x placement — jnp.asarray under
    # x64-off silently downcasts f64 to f32.  The prior setting is restored
    # on exit (the finally below), so a later f32 benchmark in the same
    # process traces with the default 32-bit indices.
    x64_prev = jax.config.jax_enable_x64
    if cfg.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        return _run_benchmark_inner(
            matrix, cfg, coo=coo, mat_name=mat_name, x=x, quick=quick,
            trace_dir=trace_dir, cache_dir=cache_dir, log=log)
    finally:
        if cfg.dtype == "float64":
            jax.config.update("jax_enable_x64", x64_prev)


def _marginal_seconds(run_n, state, arg, loop):
    """Per-iteration seconds of a chained runner.

    With loop >= 8: (t(loop) - t(loop/2)) / (loop/2), which cancels the fixed
    per-call cost (dispatch, loop ramp).  A non-positive margin (host-clock
    noise during the half run) falls back to the overhead-inclusive, hence
    conservative, average."""
    import jax

    if loop < 8:
        t0 = now()
        jax.block_until_ready(run_n(state, arg, loop))
        return (now() - t0) / loop
    half = loop // 2
    t0 = now()
    jax.block_until_ready(run_n(state, arg, half))
    t1 = now()
    jax.block_until_ready(run_n(state, arg, loop))
    t2 = now()
    margin = (t2 - t1) - (t1 - t0)
    return margin / (loop - half) if margin > 0 else (t2 - t0) / (loop + half)


def _run_benchmark_inner(matrix, cfg, *, coo, mat_name, x, quick,
                         trace_dir, cache_dir, log):
    import jax

    if x is None:
        x = create_random_vector(coo.n_col)  # deterministic, seed 3 (main.cpp:18)
    # host-library baselines (hostlib/mkl) pin themselves to the CPU device:
    # jit follows input placement, so the whole benchmark loop runs host-side
    # — the reference's mkl_dcsrmv never ran on the accelerator either.
    # Place x on the target device DIRECTLY (staging through the default
    # accelerator would add a device->host transfer per run).
    pref_dev = getattr(formats.get_format(cfg.format), "PREFERRED_DEVICE", None)
    x_host = np.asarray(x, dtype=cfg.np_dtype)
    if pref_dev is not None:
        xd = jax.device_put(x_host, jax.devices(pref_dev)[0])
    else:
        xd = jax.numpy.asarray(x_host)

    # --- planner rates: measured once per device kind, counted as set-up ---
    calibrate_s = 0.0
    if cfg.format in ("auto", "hyb"):
        from ..core import chipconst

        t0 = now()
        chipconst.constants(log=log)
        calibrate_s = now() - t0

    # --- OptimizeProblem (format conversion), timed (CSR5 reports this too) ---
    # With format=auto, a candidate that converts fine can still fail to
    # compile, run out of device memory or raise a guard at its first run —
    # retry with that candidate excluded, and record every exclusion in the
    # report (AutoExcluded) so such a failure stays visible.
    excluded = []
    for _attempt in range(4):
        log(f"{mat_name}: convert (format={cfg.format}) ...")
        t0 = now()
        if cache_dir:
            from ..formats.cache import convert_cached

            state = convert_cached(coo, cfg, cache_dir, mat_name)
        else:
            state = formats.convert(coo, cfg)
        state = jax.block_until_ready(state)
        optimize_s = now() - t0
        excluded.extend(f for f in getattr(state, "failed", ())
                        if f not in excluded)

        log(f"{mat_name}: converted in {optimize_s:.1f}s; compiling ...")
        try:
            t0 = now()
            compiled = jax.jit(formats.spmv_fn(cfg)).lower(state, xd).compile()
            compile_s = now() - t0
            log(f"{mat_name}: compiled in {compile_s:.1f}s")
            y = jax.block_until_ready(compiled(state, xd))

            # --- verify twice (main.cpp:40-56; catches operand corruption) ---
            verify_ok = True
            vdetails = {}
            if cfg.verify:
                for trial in range(2):
                    y = jax.block_until_ready(compiled(state, xd))
                    ok, vdetails = verify_result(coo, x, np.asarray(y),
                                                 dtype=cfg.np_dtype)
                    verify_ok = verify_ok and ok
                    if not ok:
                        log(f"VERIFY FAILED (pass {trial}): {vdetails}")
            break
        # ValueError/TypeError join RuntimeError/MemoryError here: a
        # candidate can refuse at trace time with a guard, exactly like a
        # device out-of-memory or a compile failure.
        except (ValueError, TypeError, RuntimeError, MemoryError) as e:
            chosen = getattr(state, "chosen", None)
            if cfg.format != "auto" or chosen is None or _attempt == 3:
                raise
            first_line = str(e).strip().splitlines()[0][:300] if str(e) else ""
            log(f"{mat_name}: {chosen} died at first run "
                f"({type(e).__name__}: {first_line}); excluding and re-planning")
            excluded.append(f"{chosen}:{type(e).__name__}")
            cfg = cfg.replace(auto_exclude=cfg.auto_exclude + (chosen,))
            del state
            import gc

            gc.collect()

    # --- calibration: double loop until a trial takes >= calibrate_seconds ---
    run_n = make_chained_runner(formats.spmv_fn(cfg), xd)
    jax.block_until_ready(run_n(state, xd, 1))  # compile the chained runner
    if quick:
        loop, n_trials = 3, 1
    else:
        loop, n_trials = 1, cfg.n_trials
        while loop < cfg.max_loop:
            t0 = now()
            jax.block_until_ready(run_n(state, xd, loop))
            dt = now() - t0
            if dt >= cfg.calibrate_seconds:
                break
            loop *= 2

    # --- best-of-N timed trials (main.cpp:80-102), loop chained on device ---
    import contextlib

    tracer = (jax.profiler.trace(trace_dir) if trace_dir
              else contextlib.nullcontext())
    with tracer:
        pers = [_marginal_seconds(run_n, state, xd, loop)
                for _ in range(n_trials)]

    # MEDIAN of trials, not min: noise that shrinks one trial's half run
    # fabricates a too-good margin that min() would keep.  The median
    # tolerates noise in either direction.
    best = float(np.median(pers)) if pers else float("inf")

    flops = 2.0 * coo.nnz                        # main.cpp:196 / CSR5 utils.h:17-20
    gflops = flops / best / 1e9 if best > 0 else 0.0

    # --- per-phase profile (PROF_BEGIN/END analog; un-fused = honest split) ---
    phase_perf: Dict[str, float] = {}
    phases = formats.phases_fn(cfg)
    ph = phases(state) if (cfg.profiling and phases) else None
    if ph:
        inputs, cur = {}, xd
        for pname, fn in ph.items():
            inputs[pname] = cur
            cur = jax.block_until_ready(jax.jit(fn)(state, cur))
        for pname, fn in ph.items():
            arg = inputs[pname]
            runner = make_chained_runner(fn, arg)
            jax.block_until_ready(runner(state, arg, 1))
            phase_perf[pname] = _marginal_seconds(runner, state, arg, loop)

    # --- per-tree-step timing (-DMEASURE_STEP_TIME; opt_ss.cpp:244-259) ---
    step_perf = {}
    if cfg.measure_step_time:
        mod = formats.get_format(cfg.format)
        sfns = getattr(mod, "step_fns", None)
        sinit = getattr(mod, "step_init", None)
        if sfns and sinit:
            vf = jax.block_until_ready(jax.jit(sinit)(state, xd))
            step_loop = max(loop, 8)
            for sname, fn in sfns(state):
                runner = make_chained_runner(fn, vf)
                jax.block_until_ready(runner(state, vf, 1))
                step_perf[sname] = _marginal_seconds(runner, state, vf,
                                                     step_loop)
                vf = jax.jit(fn)(state, vf)

    traffic = formats.traffic_bytes(state, cfg)
    roof = roofline(traffic, coo.nnz, best,
                    None if pref_dev == "cpu" else detect_chip())

    # --- report block, reference key schema first (main.cpp:109-207) ---
    report: Dict[str, object] = {"Matrix": mat_name}
    report.update(_device_fields(next(iter(xd.devices()))))
    report.update({
        "MatrixFormat": FORMAT_NAMES.get(cfg.format, cfg.format.upper()),
        "Variant": cfg.variant.upper(),
        "Dtype": cfg.dtype,
        "Omega": cfg.omega,
        "RowBlock": cfg.row_block,
        "LaneWidth": cfg.lane_width,
    })
    report.update(formats.report_fields(state, cfg))
    report.update({
        "nRow": coo.n_row,
        "nCol": coo.n_col,
        "nNnz": coo.nnz,
        "LoopCount": loop,
        "Time(s)": best,
        "Performance(GFLOPS)": gflops,
    })
    if phase_perf:
        # MulPerf/SumPerf split (main.cpp:173-174); Sum = all non-Mul phases.
        mul_s = phase_perf.get("Mul", 0.0)
        sum_s = sum(v for k, v in phase_perf.items() if k != "Mul")
        if mul_s > 0:
            report["MulPerf"] = flops / mul_s / 1e9 / 2  # one flop class per phase
        if sum_s > 0:
            report["SumPerf"] = flops / sum_s / 1e9 / 2
        for pname, sec in phase_perf.items():
            report[f"PhaseTime-{pname}(s)"] = sec
    for sname, sec in step_perf.items():
        report[f"StepTime-{sname}"] = sec     # src/main.cpp:163-167 schema
    report.update(roof)
    report.update({
        "CalibrateTime(s)": calibrate_s,
        "OptimizeTime(s)": optimize_s,
        "CompileTime(s)": compile_s,
        "nDevice": len(jax.devices()),
        "Verify": "PASS" if (cfg.verify and verify_ok) else
                  ("FAIL" if cfg.verify else "SKIPPED"),
    })
    if cfg.verify and vdetails:
        report["MaxAbsErr"] = vdetails["max_abs_err"]
        report["MaxRelErr"] = vdetails["max_rel_err"]
        report["VerifyTol"] = vdetails["tol"]
    if cfg.format == "auto":
        report["AutoExcluded"] = ",".join(excluded) or "none"
    report.update(_memory_fields(compiled))

    return BenchResult(report=report, gflops=gflops, seconds=best, loop=loop,
                       verify_ok=verify_ok, y=np.asarray(y),
                       auto_excluded=tuple(excluded))
