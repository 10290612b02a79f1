"""Harness tests: driver semantics, report block round-trip, log pipeline, sweep."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.mmio import write_matrix_market
from singlespmv_tpu.data.fixtures import fixture_10x10
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.harness.driver import run_benchmark
from singlespmv_tpu.harness.logfmt import format_logs, sum_gflops
from singlespmv_tpu.harness.report import format_block, parse_blocks
from singlespmv_tpu.harness.sweep import (config_from_row, default_todo,
                                          parse_todo, run_sweep)


def quiet(msg):
    pass


class TestDriver:
    def test_verify_and_report_schema(self):
        coo = generate("unbalance", 64, seed=9)
        res = run_benchmark(coo, Config(format="csr", dtype="float64"),
                            quick=True, log=quiet)
        assert res.verify_ok
        r = res.report
        for key in ("Matrix", "Architecture", "MatrixFormat", "nRow", "nCol",
                    "nNnz", "Performance(GFLOPS)", "Bandwidth(GB/s)"):
            assert key in r, key
        assert r["MatrixFormat"] == "CRS"  # reference spelling
        assert r["nNnz"] == coo.nnz
        assert r["Verify"] == "PASS"
        assert r["VerifyTol"] == 1e-6 and r["MaxRelErr"] <= 1e-6
        assert r["DeviceKind"] == jax.devices()[0].device_kind
        assert (r["Omega"], r["RowBlock"], r["LaneWidth"]) == (128, 8, 128)
        assert r["ArgBytes"] > 0
        if r["Architecture"] == "CPU":
            assert "RooflinePct" not in r      # no device roofline for a host

    def test_from_file_and_phases(self, tmp_path):
        p = tmp_path / "m.mtx"
        write_matrix_market(p, fixture_10x10())
        cfg = Config(format="ss", dtype="float64", segment_width=128,
                     profiling=True)
        res = run_benchmark(str(p), cfg, quick=True, log=quiet)
        assert res.verify_ok
        assert res.report["Matrix"] == "m"
        assert "nStep" in res.report
        assert any(k.startswith("PhaseTime-") for k in res.report)

    def test_auto_replans_when_top_candidate_raises_at_convert(
            self, monkeypatch):
        # The top-ranked candidate raising at CONVERT time (a guard's
        # ValueError) must fall through to the next candidate, not
        # hard-fail the benchmark — and the failure must show in the report.
        from singlespmv_tpu.formats import auto as auto_mod

        coo = generate("random", 128, 900, seed=6)
        orig_costs = auto_mod.estimate_costs

        def rigged(coo_, cfg_, _inner=False, consts=None):
            costs = orig_costs(coo_, cfg_, _inner=_inner, consts=consts)
            costs["bsr"] = min(costs.values()) / 10.0  # force top rank
            return costs

        def boom(coo_, cfg_):
            raise ValueError("synthetic convert failure")

        monkeypatch.setattr(auto_mod, "estimate_costs", rigged)
        monkeypatch.setattr(auto_mod._MODULES["bsr"], "convert", boom)
        cfg = Config(format="auto", dtype="float64")
        res = run_benchmark(coo, cfg, quick=True, log=quiet)
        assert res.verify_ok
        assert res.report["ChosenFormat"] != "BSR"
        assert res.auto_excluded == ("bsr:ValueError",)
        assert res.report["AutoExcluded"] == "bsr:ValueError"

    def test_driver_excludes_candidate_failing_at_first_run(
            self, monkeypatch):
        # A candidate that converts fine but raises a NON-RuntimeError at
        # its first spmv (TypeError guard class) must be excluded, the
        # benchmark re-planned, and the exclusion recorded.
        from singlespmv_tpu.formats import auto as auto_mod

        coo = generate("random", 128, 900, seed=7)
        cfg = Config(format="auto", dtype="float64")
        first = auto_mod.convert(coo, cfg)
        bad = first.chosen

        def boom_spmv(state, x):
            raise TypeError("synthetic first-run failure")

        monkeypatch.setattr(auto_mod._MODULES[bad], "spmv", boom_spmv)
        res = run_benchmark(coo, cfg, quick=True, log=quiet)
        assert res.verify_ok
        assert res.report["ChosenFormat"] != bad.upper()
        assert res.auto_excluded == (f"{bad}:TypeError",)

    def test_verify_catches_bad_result(self, monkeypatch):
        # A format whose spmv is wrong must be flagged, not crash.
        from singlespmv_tpu.formats import coo as coo_fmt

        orig = coo_fmt.spmv
        monkeypatch.setattr(coo_fmt, "spmv", lambda s, x: orig(s, x) + 1.0)
        res = run_benchmark(generate("dense", 16, seed=1),
                            Config(format="coo", dtype="float64"),
                            quick=True, log=quiet)
        assert not res.verify_ok
        assert res.report["Verify"] == "FAIL"


class TestReportBlock:
    def test_round_trip(self):
        data = {"Matrix": "abc", "nNnz": 42, "Performance(GFLOPS)": 1.5}
        blocks = parse_blocks(format_block(data))
        assert len(blocks) == 1
        assert blocks[0]["Matrix"] == "abc"
        assert blocks[0]["nNnz"] == "42"

    def test_logfmt_sorted_by_nnz(self):
        text = "\n".join(
            format_block({"Matrix": m, "nNnz": n, "Performance(GFLOPS)": 2.0})
            for m, n in [("big", 100), ("small", 5)]
        )
        tsv = format_logs(text)
        lines = tsv.splitlines()
        assert lines[0].startswith("Matrix\t")
        assert lines[1].split("\t")[0] == "small"
        assert lines[2].split("\t")[0] == "big"
        assert sum_gflops(text) == pytest.approx(4.0)


class TestSweep:
    def test_todo_parse_and_config(self):
        rows = parse_todo(default_todo())
        assert any(r["format"] == "csr5" for r in rows)
        cfg = config_from_row(
            {"prefix": "x", "format": "ss", "segment_width": "512",
             "variant": "simple"})
        assert cfg.format == "ss" and cfg.segment_width == 512
        assert cfg.variant == "simple"

    def test_sweep_idempotent(self, tmp_path):
        m = tmp_path / "t.mtx"
        write_matrix_market(m, generate("band", 32, 3, seed=2))
        todo = tmp_path / "todo.csv"
        todo.write_text(
            "prefix,format,dtype\nA,csr,float64\nB,coo,float64\n")
        out = tmp_path / "log"
        fails = run_sweep(str(todo), [str(m)], str(out), quick=True, log=quiet)
        assert fails == 0
        manifest = json.loads((out / "manifest.json").read_text())
        assert manifest == {"A::t": "done", "B::t": "done"}
        text = (out / "A.log").read_text()
        assert len(parse_blocks(text)) == 1
        # Re-run: nothing re-executes, logs unchanged.
        fails = run_sweep(str(todo), [str(m)], str(out), quick=True, log=quiet)
        assert fails == 0
        assert len(parse_blocks((out / "A.log").read_text())) == 1


class TestCLI:
    def _run(self, *args, tmp=None):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        return subprocess.run(
            [sys.executable, "-m", "singlespmv_tpu", *args],
            capture_output=True, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )

    def test_formats_info_spy_gen_bench(self, tmp_path):
        r = self._run("formats")
        assert r.returncode == 0 and "csr5" in r.stdout

        out = tmp_path / "g.mtx"
        r = self._run("gen", "band", "32", "3", "--out", str(out))
        assert r.returncode == 0, r.stderr
        assert out.exists()

        r = self._run("info", str(out))
        assert r.returncode == 0 and "nnz" in r.stdout

        r = self._run("spy", str(out), "--size", "16")
        assert r.returncode == 0 and "nnz=" in r.stdout

        r = self._run("bench", str(out), "--format=csr", "--dtype=float64",
                      "--quick")
        assert r.returncode == 0, r.stderr
        blocks = parse_blocks(r.stdout)
        assert len(blocks) == 1 and blocks[0]["Verify"] == "PASS"


class TestGraftEntry:
    def test_entry_jits(self):
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import jax

        import __graft_entry__ as ge

        fn, args = ge.entry()
        y = jax.jit(fn)(*args)
        assert y.shape == (512,)
        assert np.isfinite(np.asarray(y)).all()

    def test_dryrun_multichip(self):
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import jax

        import __graft_entry__ as ge

        ge.dryrun_multichip(len(jax.devices()))


def test_measure_step_time_rows():
    """cfg.measure_step_time must produce StepTime-NN rows for the scan
    formats (reference -DMEASURE_STEP_TIME, src/main.cpp:163-167)."""
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.data.generators import powerlaw
    from singlespmv_tpu.harness.driver import run_benchmark

    cfg = Config(format="ss", dtype="float64", segment_width=256,
                 measure_step_time=True)
    res = run_benchmark(powerlaw(200, 3000, seed=5), cfg, quick=True,
                        log=lambda m: None)
    keys = [k for k in res.report if k.startswith("StepTime-")]
    assert keys == [f"StepTime-{i:02d}" for i in range(res.report["nStep"])]
    assert all(res.report[k] >= 0 for k in keys)
