"""Stand-in structural-fidelity tests.

Zero-egress environment: real SuiteSparse .mtx downloads are impossible, so
GFLOPS(real)/GFLOPS(synth) cannot be measured.  The honest substitute validated here: every stand-in in
`data/structgen.py` must exhibit the *published structural class* of the matrix
it imitates — the same classes the reference's own matrix tools report
(/root/reference/matrix/script/counter.cpp:28-44 row-degree stats,
visualizer.cpp spy shape).  Metrics from `data.tools.structure_metrics`.
"""
import numpy as np
import pytest

from singlespmv_tpu.data.structgen import RECIPES, synthesize_structured
from singlespmv_tpu.data.tools import structure_metrics

# Class profiles: metric -> (lo, hi) bounds each member must satisfy.
# FEM/structural solids: clustered block bands -> long row runs, even degrees.
FEM = {"run2_frac": (0.85, 1.0), "row_cv": (0.0, 0.35), "local_frac": (0.6, 1.0)}
# Circuit/DAE giants: diagonal + local scatter + hub columns, NO runs.
CIRCUIT = {"run2_frac": (0.0, 0.15), "diag_cover": (0.9, 1.0),
           "top1pct_col": (0.02, 0.25), "row_cv": (0.2, 1.2)}
# Web graph: power-law hubs -> extreme row-degree variance, heavy top columns.
WEB = {"row_cv": (10.0, 1e9), "top1pct_col": (0.1, 1.0), "run2_frac": (0.0, 0.1)}

CLASS_OF = {
    "raefsky3": FEM, "sme3Dc": FEM, "laminar_duct3D": FEM, "ohne2": FEM,
    "PR02R": FEM, "para-4": FEM, "TSOPF_RS_b2383_c1": FEM,
    "ASIC_680ks": CIRCUIT, "Freescale1": CIRCUIT, "rajat31": CIRCUIT,
    "webbase-1M": WEB,
    # Irregular chemical-process / econ classes: mid run-fraction, scattered.
    "lhr34": {"run2_frac": (0.3, 0.9), "med_reldist": (0.005, 0.1)},
    "mac_econ_fwd500": {"run2_frac": (0.1, 0.7), "med_reldist": (0.005, 0.1)},
    # torso1: dense-row appendix drives high row variance over a banded body.
    "torso1": {"row_cv": (1.0, 10.0), "run2_frac": (0.5, 1.0)},
    # Chebyshev4: few spectral dense rows on a band.
    "Chebyshev4": {"row_cv": (3.0, 30.0), "run2_frac": (0.7, 1.0)},
    "Hamrle3": {"run2_frac": (0.0, 0.3), "diag_cover": (0.8, 1.0)},
}

SMALL = [n for n in CLASS_OF if RECIPES[n][1] < 12_000_000]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_standin_matches_class_profile(name):
    m = synthesize_structured(name, seed=0)
    s = structure_metrics(m)
    # size must match the published SuiteSparse dimensions (BASELINE.md table)
    n_pub, nnz_pub, _ = RECIPES[name]
    assert s["n_row"] == n_pub
    assert abs(s["nnz"] - nnz_pub) / nnz_pub < 0.05, (name, s["nnz"], nnz_pub)
    for metric, (lo, hi) in CLASS_OF[name].items():
        assert lo <= s[metric] <= hi, (
            f"{name}: {metric}={s[metric]:.4f} outside class bounds "
            f"[{lo}, {hi}] — stand-in no longer matches its structural class")


def test_metrics_separate_classes():
    """The metric space itself must separate FEM / circuit / web classes."""
    fem = structure_metrics(synthesize_structured("raefsky3", seed=0))
    cir = structure_metrics(synthesize_structured("ASIC_680ks", seed=0))
    web = structure_metrics(synthesize_structured("webbase-1M", seed=0))
    assert fem["run2_frac"] > 0.8 > cir["run2_frac"]
    assert web["row_cv"] > 10 * max(fem["row_cv"], cir["row_cv"])
    assert web["top1pct_col"] > 2 * fem["top1pct_col"]
