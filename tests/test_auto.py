"""Tests for the auto planner: its cost model over the XLA-level formats
(driven by injected device rates, tests/conftest.py) and its end-to-end
choice through convert and the benchmark driver."""
import numpy as np
import pytest

from singlespmv_tpu import formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.core.oracle import verify_result
from singlespmv_tpu.core.rng import create_random_vector
from singlespmv_tpu.data.generators import generate, powerlaw

F64 = Config(dtype="float64")


class TestAuto:
    @pytest.mark.parametrize("name,make,expect", [
        # banded: one dense stream per diagonal beats any gather
        ("band", lambda: generate("band", 2048, 16, seed=1), {"dia"}),
        # fully dense: the dense stream, or its blocked form
        ("dense", lambda: generate("dense", 256, seed=2), {"dense", "bsr"}),
        # power-law scatter: blocks and diagonals explode, rows are skewed
        # (ell padding refused) — the gather + segment-sum paths remain
        ("powerlaw", lambda: powerlaw(4096, 4096 * 24, seed=3),
         {"csr", "coo"}),
    ], ids=["band", "dense", "powerlaw"])
    def test_choice_and_correctness(self, name, make, expect):
        import jax

        coo = make()
        cfg = F64.replace(format="auto")
        st = formats.convert(coo, cfg)
        assert st.chosen in expect, st.chosen
        assert st.failed == ()
        x = create_random_vector(coo.n_col)
        y = np.asarray(jax.jit(formats.spmv_fn(cfg))(st, x))
        ok, det = verify_result(coo, x, y, dtype=np.float64)
        assert ok, det
        fields = formats.report_fields(st, cfg)
        assert fields["ChosenFormat"] == st.chosen.upper()

    def test_through_benchmark_driver(self):
        from singlespmv_tpu.harness.driver import run_benchmark

        res = run_benchmark(powerlaw(512, 8000, seed=6),
                            F64.replace(format="auto"), quick=True,
                            log=lambda m: None)
        assert res.verify_ok
        assert "ChosenFormat" in res.report
        assert res.report["AutoExcluded"] == "none"
        assert res.auto_excluded == ()


class TestPlannerClasses:
    """Planner regression per structural class, under the injected rates:
    streamed formats win where the structure streams, the gather +
    segment-sum fallbacks are always offered, so auto never fails."""

    CASES = [
        ("band", lambda: generate("band", 1024, 8, seed=31), {"dia", "hyb"}),
        ("block-fem", lambda: _block_fem_small(), {"bsr", "dense", "hyb",
                                                   "ell"}),
        ("scattered", lambda: powerlaw(4096, 40000, seed=33),
         {"csr", "coo", "ell"}),
        ("web", lambda: powerlaw(8192, 40000, seed=34),
         {"csr", "coo", "ell"}),
    ]

    @pytest.mark.parametrize("name,make,expect", CASES,
                             ids=[c[0] for c in CASES])
    def test_class_choice(self, name, make, expect):
        from singlespmv_tpu.formats.auto import estimate_costs

        coo = make()
        cfg = Config(dtype="float32")
        costs = estimate_costs(coo, cfg)
        assert {"csr", "ss"} <= set(costs)        # fallbacks always offered
        chosen = min(costs, key=costs.get)
        assert chosen in expect, (chosen, costs)

    def test_f64_auto_end_to_end(self):
        """float64 is native on every candidate: auto plans it like float32
        (values twice as wide) and the result verifies at the f64 tolerance."""
        import jax

        coo = powerlaw(2048, 20000, seed=35)
        cfg = Config(format="auto", dtype="float64")
        st = formats.convert(coo, cfg)
        x = create_random_vector(coo.n_col)
        y = np.asarray(jax.jit(formats.spmv_fn(cfg))(st, x))
        ok, det = verify_result(coo, x, y, dtype=np.float64)
        assert ok, det


def _block_fem_small():
    from singlespmv_tpu.data.structgen import _assemble, _block_band, _diag

    rng = np.random.default_rng(32)
    n, nnz = 4096, 160000
    parts = [_diag(n), _block_band(rng, n, 8, nnz - n, 8)]
    return _assemble(rng, n, n, nnz, parts)
