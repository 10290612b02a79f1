"""Tests for the north-star ops: BSR format, SpMM, SpGEMM, SpTRSV."""
import numpy as np
import pytest

from singlespmv_tpu.config import Config
from singlespmv_tpu import formats
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.rng import create_random_matrix, create_random_vector
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.ops.spgemm import spgemm_coo
from singlespmv_tpu.ops.sptrsv import analyze, solve, sptrsv

F64 = Config(dtype="float64")


def mats():
    return [
        generate("band", 64, 5, seed=1),
        generate("unbalance", 48, seed=2),
        powerlaw(96, 900, seed=3),
    ]


class TestBSR:
    @pytest.mark.parametrize("coo", mats(), ids=["band", "unbal", "powerlaw"])
    def test_spmv(self, coo):
        cfg = F64.replace(format="bsr")
        state = formats.convert(coo, cfg)
        x = create_random_vector(coo.n_col)
        y = np.asarray(formats.spmv_fn(cfg)(state, x))
        np.testing.assert_allclose(y, reference_spmv(coo, x), rtol=1e-10)

    def test_fill_reported(self):
        cfg = F64.replace(format="bsr")
        state = formats.convert(generate("dense", 32, seed=4), cfg)
        assert 0 < state.fill <= 1.0
        assert formats.report_fields(state, cfg)["nBlocks"] == state.n_blocks


class TestSpMM:
    @pytest.mark.parametrize("fmt", ["csr", "ell", "bsr", "dense", "ss", "coo"])
    def test_matches_dense(self, fmt):
        import jax.numpy as jnp

        coo = powerlaw(80, 700, seed=5)
        cfg = F64.replace(format=fmt)
        state = formats.convert(coo, cfg)
        X = create_random_matrix(coo.n_col, 16, seed=6)
        Y = np.asarray(formats.spmm_fn(cfg)(state, jnp.asarray(X)))
        np.testing.assert_allclose(Y, coo.to_dense() @ X, rtol=1e-9, atol=1e-9)

    def test_rectangular(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(1)
        coo = COOMatrix.from_triplets(
            40, 100, rng.integers(0, 40, 500), rng.integers(0, 100, 500),
            rng.uniform(-1, 1, 500), sum_duplicates=True)
        cfg = F64.replace(format="bsr")
        state = formats.convert(coo, cfg)
        X = create_random_matrix(100, 8, seed=7)
        Y = np.asarray(formats.spmm_fn(cfg)(state, jnp.asarray(X)))
        np.testing.assert_allclose(Y, coo.to_dense() @ X, rtol=1e-9, atol=1e-9)


class TestSpGEMM:
    def test_small_exact(self):
        a = generate("band", 24, 3, seed=8)
        b = generate("band", 24, 2, seed=9)
        c = spgemm_coo(a, b)
        np.testing.assert_allclose(c.to_dense(), a.to_dense() @ b.to_dense(),
                                   rtol=1e-9, atol=1e-12)

    def test_rectangular_chain(self):
        rng = np.random.default_rng(2)
        a = COOMatrix.from_triplets(20, 30, rng.integers(0, 20, 120),
                                    rng.integers(0, 30, 120),
                                    rng.uniform(-1, 1, 120), sum_duplicates=True)
        b = COOMatrix.from_triplets(30, 15, rng.integers(0, 30, 90),
                                    rng.integers(0, 15, 90),
                                    rng.uniform(-1, 1, 90), sum_duplicates=True)
        c = spgemm_coo(a, b)
        assert (c.n_row, c.n_col) == (20, 15)
        np.testing.assert_allclose(c.to_dense(), a.to_dense() @ b.to_dense(),
                                   rtol=1e-9, atol=1e-12)

    def test_empty_product(self):
        a = COOMatrix.from_triplets(5, 5, np.array([0]), np.array([4]),
                                    np.array([2.0]))
        b = COOMatrix.from_triplets(5, 5, np.array([0]), np.array([0]),
                                    np.array([3.0]))
        c = spgemm_coo(a, b)  # A's col 4 misses B's only row 0
        assert c.nnz == 0

    def test_powerlaw_b_no_capacity_blowup(self):
        """One dense row in B must not explode the candidate
        rectangle (old capacity nnz_A·max_deg(B) = 100k·20k slots here)."""
        rng = np.random.default_rng(5)
        n = 100_000
        a = COOMatrix.from_triplets(
            n, n, rng.integers(0, n, 100_000), rng.integers(0, n, 100_000),
            rng.uniform(1, 2, 100_000), sum_duplicates=True)
        # B: light scatter + one 20k-entry dense row
        br = np.concatenate([rng.integers(0, n, 80_000),
                             np.full(20_000, 1234)])
        bc = np.concatenate([rng.integers(0, n, 80_000),
                             rng.choice(n, 20_000, replace=False)])
        b = COOMatrix.from_triplets(n, n, br, bc,
                                    rng.uniform(1, 2, len(br)),
                                    sum_duplicates=True)
        c = spgemm_coo(a, b)
        # spot-check against the scipy-style reference on a row sample
        import scipy.sparse as sp  # noqa: F401  (absent: skip check)
        A = sp.coo_matrix((a.val, (a.row, a.col)), shape=(n, n)).tocsr()
        B = sp.coo_matrix((b.val, (b.row, b.col)), shape=(n, n)).tocsr()
        C = (A @ B).tocoo()
        ref = COOMatrix.from_triplets(n, n, C.row, C.col, C.data,
                                      sum_duplicates=True)
        assert c.nnz == ref.nnz
        np.testing.assert_allclose(c.val, ref.val, rtol=1e-9, atol=1e-12)


def _tri(n, lower=True, seed=0, density=0.2):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(n):
        rng_cols = range(r) if lower else range(r + 1, n)
        for c in rng_cols:
            if rng.uniform() < density:
                rows.append(r); cols.append(c); vals.append(rng.uniform(-1, 1))
        rows.append(r); cols.append(r); vals.append(rng.uniform(1, 2))
    return COOMatrix.from_triplets(n, n, np.array(rows), np.array(cols),
                                   np.array(vals, dtype=np.float64))


class TestSpTRSV:
    @pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
    def test_solve(self, lower):
        t = _tri(64, lower=lower, seed=3)
        b = create_random_vector(64, seed=4)
        y = np.asarray(sptrsv(t, b, lower=lower))
        np.testing.assert_allclose(t.to_dense() @ y, b, rtol=1e-9, atol=1e-9)

    def test_plan_reuse_and_levels(self):
        t = _tri(48, seed=5, density=0.4)
        plan = analyze(t)
        assert plan.n_levels >= 1
        for seed in (6, 7):
            b = create_random_vector(48, seed=seed)
            y = np.asarray(solve(plan, b))
            np.testing.assert_allclose(t.to_dense() @ y, b, rtol=1e-9, atol=1e-9)

    def test_diagonal_only(self):
        i = np.arange(10)
        t = COOMatrix.from_triplets(10, 10, i, i, np.full(10, 2.0))
        b = np.ones(10)
        y = np.asarray(sptrsv(t, b))
        np.testing.assert_allclose(y, 0.5 * np.ones(10))

    def test_singular_raises(self):
        i = np.arange(4)
        vals = np.array([1.0, 0.0, 1.0, 1.0])
        t = COOMatrix.from_triplets(4, 4, i, i, vals)
        with pytest.raises(ValueError):
            analyze(t)
