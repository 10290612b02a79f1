"""HYB (dense-diagonal peel + scattered residual) — correctness + planning.

The hybrid split is this rebuild's own structure-adaptive contribution (no
reference analog; the reference benchmarks one format per binary,
/root/reference/script/gen_todo.sh).  These tests pin: oracle parity on mixed
matrices, round-trip, the peel plan's cost-model behavior, and that the auto
planner offers/withholds hyb by structure.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import convert, spmv_fn, to_coo
from singlespmv_tpu.formats import hyb as hyb_mod


def _mixed(n=384, seed=0):
    """Band + scattered mixture — the structure hyb exists for."""
    rng = np.random.default_rng(seed)
    band = generate("band", n, 6, seed=seed)
    sc_r = rng.integers(0, n, n * 2)
    sc_c = rng.integers(0, n, n * 2)
    rows = np.concatenate([band.row, sc_r])
    cols = np.concatenate([band.col, sc_c])
    vals = np.concatenate([band.val, rng.uniform(size=sc_r.size)])
    return COOMatrix.from_triplets(n, n, rows, cols, vals, sort=True,
                                   sum_duplicates=True)


@pytest.mark.parametrize("make,label", [
    (lambda: _mixed(), "band+scatter"),
    (lambda: generate("band", 256, 8, seed=1), "pure-band"),
    (lambda: powerlaw(256, 256 * 6, seed=2), "powerlaw"),
])
def test_hyb_spmv_vs_oracle(make, label):
    coo = make()
    cfg = Config(format="hyb", dtype="float32")
    st = convert(coo, cfg)
    x = np.random.default_rng(3).uniform(size=coo.n_col).astype(np.float32)
    fn = jax.jit(spmv_fn(cfg))
    y = np.asarray(fn(st, x))
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, f"{label}: {det}"
    y2 = np.asarray(fn(st, x))
    assert (y == y2).all()


def test_hyb_round_trip():
    coo = _mixed(seed=4)
    cfg = Config(format="hyb", dtype="float64")
    st = convert(coo, cfg)
    back = to_coo(st, cfg)
    np.testing.assert_allclose(back.to_dense(), coo.to_dense(), atol=0)


def test_hyb_peel_plan_splits_by_density():
    """Dense band diagonals peel; the scattered tail stays residual."""
    coo = _mixed(n=512, seed=5)
    cfg = Config(dtype="float32")
    st = hyb_mod.convert(coo, cfg)
    # band width 6 is |i-j| < 6: 11 diagonals dominate; scattered nnz residual
    assert st.dia_state.n_diag >= 11
    assert st.peel_nnz >= 512 * 11 * 0.9
    assert st.rest_fmt != ""
    assert st.nnz - st.peel_nnz > 0


def test_hyb_spmm_matches_columnwise_spmv():
    coo = _mixed(n=256, seed=6)
    cfg = Config(format="hyb", dtype="float32")
    st = convert(coo, cfg)
    X = np.random.default_rng(7).uniform(size=(coo.n_col, 4)).astype(np.float32)
    Y = np.asarray(jax.jit(hyb_mod.spmm)(st, X))
    for b in range(4):
        ok, det = verify_result(coo, X[:, b], Y[:, b], dtype=np.float32)
        assert ok, det


def test_auto_offers_hyb_on_stencil_mix():
    """A band + scatter matrix must surface a hyb candidate whose cost beats
    the one-format scattered paths (the natural-suite regime), and that cost
    must be the peel's dia stream + the cheapest residual format + one extra
    pass over y (the rates are the injected test constants)."""
    from singlespmv_tpu.core import chipconst
    from singlespmv_tpu.formats.auto import estimate_costs

    coo = _mixed(n=131072, seed=8)
    cfg = Config(dtype="float32")
    costs = estimate_costs(coo, cfg)
    assert "hyb" in costs
    scattered = [v for k, v in costs.items() if k in hyb_mod._rest_modules()]
    assert costs["hyb"] < min(scattered)
    est = hyb_mod.estimate(coo, cfg)
    peel, _ = hyb_mod.plan_peel(coo, cfg)
    _, rest = hyb_mod._split(coo, peel, cfg)
    rcosts = estimate_costs(rest, cfg, _inner=True)
    rbest = min(v for k, v in rcosts.items() if k in hyb_mod._rest_modules())
    y_pass = 3 * coo.n_row * 4 / chipconst.constants()["hbm_bps"]
    assert costs["hyb"] == pytest.approx(est["dia_sec"] + rbest + y_pass)


def test_auto_withholds_hyb_on_pure_scatter():
    """Uniform scatter has no dense diagonals — hyb must not be offered."""
    from singlespmv_tpu.formats.auto import estimate_costs

    rng = np.random.default_rng(9)
    n = 2048
    coo = COOMatrix.from_triplets(n, n, rng.integers(0, n, n * 4),
                                  rng.integers(0, n, n * 4),
                                  rng.uniform(size=n * 4), sort=True,
                                  sum_duplicates=True)
    costs = estimate_costs(coo, Config(dtype="float32"))
    assert "hyb" not in costs
