"""Headline benchmark — prints ONE JSON line.

Benchmarks the reference's own headline class: the FULL 26-matrix natural
SuiteSparse suite (structure-matched stand-ins, data/structgen.py — no
egress), through the auto planner on the attached device.  The metric is the
median per-matrix ratio vs the reference's measured CSR5/AVX2 GFLOPS on the
same matrices (/root/reference/opt/Benchmark_SpMV_using_CSR5/CSR5_avx2/
cpu-15-10-01-13-17.tsv, tabulated in BASELINE.md).

Conversion states are cached in results/state_cache/ (formats/cache.py,
fingerprinted by matrix, config and device kind).  The device kind and the
card's power limit are printed on the line before the JSON.  The exit code is
non-zero when any matrix failed or failed verification.
"""
import json
import sys
import time


def main() -> int:
    import jax
    import numpy as np

    from singlespmv_tpu.config import Config
    from singlespmv_tpu.core import compile_cache
    from singlespmv_tpu.data.structgen import RECIPES, synthesize_structured
    from singlespmv_tpu.harness.driver import run_benchmark
    from singlespmv_tpu.harness.roofline import card_line
    from singlespmv_tpu.harness.suite import BASELINE_AVX2

    compile_cache.setup()
    names = sorted(RECIPES, key=lambda n: RECIPES[n][1])   # all 26, nnz order
    cfg = Config(format="auto", dtype="float32",
                 calibrate_seconds=0.4, n_trials=5)

    gflops = {}
    ratios = {}
    chosen = {}
    failed = []
    for name in names:
        t0 = time.time()
        try:
            coo = synthesize_structured(name, seed=0)
            res = run_benchmark(coo, cfg, name=f"synth-{name}",
                                cache_dir="results/state_cache",
                                log=lambda m: print(m, file=sys.stderr))
        except Exception as e:  # noqa: BLE001 — report every matrix, then fail
            print(f"{name}: ERROR {type(e).__name__}: {e}", file=sys.stderr)
            gflops[name] = 0.0
            ratios[name] = 0.0
            chosen[name] = "ERROR"
            failed.append(name)
            continue
        if not res.verify_ok:
            failed.append(name)
        gflops[name] = round(res.gflops, 3)
        base = BASELINE_AVX2.get(name)
        if base:
            ratios[name] = round(res.gflops / base, 3)
        chosen[name] = res.report.get("ChosenFormat", cfg.format)
        print(f"{name}: {res.gflops:.2f} GFLOPS in {time.time() - t0:.0f}s "
              f"[{chosen[name]}] verify={res.report['Verify']}",
              file=sys.stderr)

    med_ratio = float(np.median(list(ratios.values()))) if ratios else 0.0
    wins = sum(1 for v in ratios.values() if v >= 1.0)
    dev = jax.devices()[0]
    line = {
        "metric": "natural_suite_full26_median_vs_csr5avx2",
        "value": round(float(np.median(list(gflops.values()))), 3),
        "unit": "GFLOPS",
        "vs_baseline": round(med_ratio, 3),
        "wins": wins,
        "losses": len(ratios) - wins,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "failed": failed,
        "detail": gflops,
        "per_matrix_ratio": ratios,
        "chosen_format": chosen,
    }
    print(f"device: {dev.device_kind} | {card_line()}")
    print(json.dumps(line))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
