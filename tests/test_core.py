"""Core types, Matrix-Market I/O, oracle, generators."""
import io

import numpy as np
import pytest

from singlespmv_tpu.core import (COOMatrix, matrix_stats, read_matrix_market,
                                 reference_spmv, verify_result,
                                 write_matrix_market)
from singlespmv_tpu.data import fixtures as fx
from singlespmv_tpu.data.generators import generate

from conftest import rand_x


def test_coo_sorted_and_dense_roundtrip():
    m = fx.fixture_10x10()
    assert (np.diff(m.row) >= 0).all()
    d = m.to_dense()
    assert d.shape == (10, 10)
    assert d.sum() == m.val.sum()
    # empty rows 7..9
    assert (d[7:] == 0).all()
    assert (m.row_lengths()[7:] == 0).all()


def test_row_ptr():
    m = fx.fixture_10x10()
    rp = m.row_ptr()
    assert rp[0] == 0 and rp[-1] == m.nnz
    assert (np.diff(rp) == m.row_lengths()).all()


def test_mmio_bannerless():
    # /root/reference/matrix/test/3x3.mtx has no banner — must parse.
    text = "3 3 3\n1 1 1\n2 2 2\n3 3 3\n"
    m = read_matrix_market(io.StringIO(text))
    assert m.n_row == 3 and m.nnz == 3
    assert (m.to_dense() == np.diag([1.0, 2.0, 3.0])).all()


def test_mmio_comments_and_banner():
    text = ("%%MatrixMarket matrix coordinate real general\n"
            "% a comment\n%\n2 3 2\n1 3 1.5\n2 1 -2\n")
    m = read_matrix_market(io.StringIO(text))
    assert m.n_row == 2 and m.n_col == 3 and m.nnz == 2
    assert m.to_dense()[0, 2] == 1.5
    assert m.to_dense()[1, 0] == -2


def test_mmio_symmetric_expansion():
    text = ("%%MatrixMarket matrix coordinate real symmetric\n"
            "3 3 4\n1 1 1\n2 1 2\n3 1 3\n3 3 4\n")
    m = read_matrix_market(io.StringIO(text))
    assert m.nnz == 6  # diagonal not duplicated
    d = m.to_dense()
    assert (d == d.T).all()
    assert d[0, 1] == 2 and d[1, 0] == 2


def test_mmio_skew_symmetric():
    text = ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
            "3 3 2\n2 1 5\n3 2 -1\n")
    m = read_matrix_market(io.StringIO(text))
    d = m.to_dense()
    assert d[1, 0] == 5 and d[0, 1] == -5
    assert d[2, 1] == -1 and d[1, 2] == 1


def test_mmio_pattern():
    text = ("%%MatrixMarket matrix coordinate pattern general\n"
            "2 2 2\n1 1\n2 2\n")
    m = read_matrix_market(io.StringIO(text))
    assert (m.val == 1.0).all()


def test_mmio_integer():
    text = ("%%MatrixMarket matrix coordinate integer general\n"
            "2 2 1\n2 1 7\n")
    m = read_matrix_market(io.StringIO(text))
    assert m.to_dense()[1, 0] == 7


def test_mmio_array_general():
    text = ("%%MatrixMarket matrix array real general\n"
            "2 2\n1\n0\n3\n4\n")  # column-major: [[1,3],[0,4]]
    m = read_matrix_market(io.StringIO(text))
    d = m.to_dense()
    assert d[0, 0] == 1 and d[0, 1] == 3 and d[1, 1] == 4 and m.nnz == 3


def test_mmio_write_read_roundtrip(tmp_path):
    m = generate("random", 20, 50, seed=9)
    p = tmp_path / "t.mtx"
    write_matrix_market(p, m, comment="roundtrip")
    m2 = read_matrix_market(p)
    assert np.allclose(m.to_dense(), m2.to_dense())


def test_reference_fixture_files_parse():
    # The actual reference fixtures must load (read-only parity check).
    import os

    ref = "/root/reference/matrix/test"
    if not os.path.isdir(ref):
        pytest.skip("reference not mounted")
    for name, (nr, nnz) in {"3x3.mtx": (3, 3), "5x5.mtx": (5, 5),
                            "10x10.mtx": (10, 27), "random.mtx": (10, 95)}.items():
        m = read_matrix_market(os.path.join(ref, name))
        assert m.n_row == nr and m.nnz == nnz


def test_oracle_and_verify():
    m = fx.fixture_5x5()
    x = rand_x(5)
    y = reference_spmv(m, x)
    assert np.allclose(y, m.to_dense() @ x)
    ok, det = verify_result(m, x, y, dtype=np.float64)
    assert ok, det
    bad = y.copy()
    bad[2] += 1.0
    ok, det = verify_result(m, x, bad, dtype=np.float64)
    assert not ok and det["n_bad"] == 1


def test_generators_shapes():
    m = generate("band", 32, 3)
    d = m.to_dense()
    rr, cc = np.nonzero(d)
    assert (np.abs(rr - cc) < 3).all()
    m = generate("band", 64, artificial=True, seed=2)
    width = max(1, m.nnz // 64)
    assert (np.abs(m.row - m.col) >= width).all()  # artificial band is OFF-band
    assert (m.val == 1.0).all()
    m = generate("dense", 16)
    assert m.nnz == 256
    m = generate("unbalance", 64, artificial=True)
    assert m.row.max() == -(-m.nnz // 64) - 1
    m = generate("random", 50, 100)
    assert m.nnz == 100
    assert len(set(zip(m.row.tolist(), m.col.tolist()))) == 100


def test_matrix_stats():
    s = matrix_stats(fx.fixture_10x10())
    assert s["empty_rows"] == 3
    assert s["row_max"] == 8


def test_duplicate_positions_kept():
    m = generate("random_unbalance", 16, seed=5)
    assert m.nnz == 16 * 16  # duplicates kept, like the reference generator


def test_bfloat16_pipeline():
    """bf16 device dtype with a row-length-aware tolerance."""
    import jax

    from singlespmv_tpu import formats
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.core.oracle import tolerance_for, verify_result
    from singlespmv_tpu.core.rng import create_random_vector
    from singlespmv_tpu.data.generators import generate

    coo = generate("band", 96, 4, seed=1)
    assert tolerance_for(coo, "bfloat16") > tolerance_for(coo, "float32")
    cfg = Config(format="csr", dtype="bfloat16")
    st = formats.convert(coo, cfg)
    x = create_random_vector(coo.n_col).astype(cfg.np_dtype)
    y = np.asarray(jax.jit(formats.spmv_fn(cfg))(st, x)).astype(np.float64)
    ok, det = verify_result(coo, np.asarray(x, np.float64), y,
                            dtype=cfg.np_dtype)
    assert ok, det
