"""Property tests: every format × every pathological matrix vs the f64 oracle.

This is the rebuild's analog of the reference's compiled-in VERIFY oracle
(/root/reference/src/main.cpp:40-56) run as a proper test pyramid (SURVEY §4).
"""
import jax
import numpy as np
import pytest

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import reference_spmv, verify_result
from singlespmv_tpu.formats import available_formats, convert, get_format, spmv_fn

from conftest import all_test_matrices, rand_x

FORMATS = ["coo", "csr", "ell", "jds", "dia", "ss", "css", "csr5", "dense",
           "bcoo", "hostlib", "bsr", "hyb"]
MATRICES = all_test_matrices()


def _run(fmt, name, mat, cfg):
    state = convert(mat, cfg.replace(format=fmt))
    x = rand_x(mat.n_col).astype(cfg.np_dtype)
    fn = jax.jit(spmv_fn(cfg.replace(format=fmt)))
    y = np.asarray(fn(state, x))
    assert y.shape == (mat.n_row,)
    ok, det = verify_result(mat, x, y, dtype=cfg.np_dtype)
    assert ok, f"{fmt} on {name}: {det}"
    # Idempotence (the reference's verify-twice, main.cpp:40-56): repeat call must
    # be bitwise identical — functional JAX gives this, but we keep the invariant.
    y2 = np.asarray(fn(state, x))
    assert (y == y2).all(), f"{fmt} on {name}: repeat call differs"


@pytest.mark.parametrize("variant", ["simple", "optimized"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name,mat", MATRICES, ids=[n for n, _ in MATRICES])
def test_spmv_f64_vs_oracle(fmt, name, mat, variant):
    _run(fmt, name, mat, Config(dtype="float64", segment_width=256,
                                variant=variant))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name,mat", MATRICES, ids=[n for n, _ in MATRICES])
def test_spmv_f32_vs_oracle(fmt, name, mat):
    """float32 values, float64 oracle, the row-length-aware f32 tolerance."""
    _run(fmt, name, mat, Config(dtype="float32", segment_width=256))


@pytest.mark.parametrize("fmt", ["csr", "ss", "csr5"])
def test_spmv_f32(fmt):
    mats = dict(MATRICES)
    for name in ("10x10", "powerlaw-256", "random-128"):
        _run(fmt, name, mats[name], Config(dtype="float32", segment_width=256))


@pytest.mark.parametrize("width", [128, 256, 1024])
def test_ss_width_sweep(width):
    mats = dict(MATRICES)
    _run("ss", "powerlaw-256", mats["powerlaw-256"],
         Config(dtype="float64", segment_width=width))


@pytest.mark.parametrize("n_block", [1, 2, 7, 16])
def test_css_nblock_sweep(n_block):
    mats = dict(MATRICES)
    _run("css", "random-128", mats["random-128"],
         Config(dtype="float64", segment_width=256, n_block=n_block))


@pytest.mark.parametrize("sigma", [0, 4, 16])
def test_csr5_sigma(sigma):
    mats = dict(MATRICES)
    _run("csr5", "powerlaw-256", mats["powerlaw-256"],
         Config(dtype="float64", sigma=sigma))


def test_registry():
    fmts = available_formats()
    for f in FORMATS + ["crs"]:
        assert f in fmts
    with pytest.raises(KeyError):
        get_format("nope")


def test_index64():
    mats = dict(MATRICES)
    _run("csr", "10x10", mats["10x10"], Config(dtype="float64", index_bits=64))


def test_empty_rows_produce_zero():
    mats = dict(MATRICES)
    mat = mats["10x10"]
    x = rand_x(10)
    for fmt in FORMATS:
        cfg = Config(dtype="float64", format=fmt, segment_width=128)
        y = np.asarray(spmv_fn(cfg)(convert(mat, cfg), x))
        assert (y[7:] == 0).all(), fmt


def test_spmv_jit_cache_stable():
    """Same shapes/meta → no retrace (one compiled binary per config, like make)."""
    cfg = Config(dtype="float64", format="ss", segment_width=128)
    mats = dict(MATRICES)
    fn = jax.jit(spmv_fn(cfg))
    s1 = convert(mats["10x10"], cfg)
    x = rand_x(10)
    fn(s1, x)
    n0 = fn._cache_size()
    fn(s1, x * 2)
    assert fn._cache_size() == n0


def test_empty_matrix_all_formats():
    """nnz = 0 must produce y = 0 of the right shape in every format."""
    import jax

    from singlespmv_tpu import formats
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.core.types import COOMatrix

    empty = COOMatrix.from_triplets(12, 9, np.zeros(0, int), np.zeros(0, int),
                                    np.zeros(0))
    x = np.random.default_rng(0).uniform(size=9)
    for fmt in formats.available_formats():
        if fmt == "crs":
            continue
        cfg = Config(format=fmt, dtype="float64", segment_width=128)
        st = formats.convert(empty, cfg)
        y = np.asarray(jax.jit(formats.spmv_fn(cfg))(st, x))
        assert y.shape == (12,) and np.allclose(y, 0), fmt


def test_single_element_all_formats():
    """nnz = 1 edge case."""
    import jax

    from singlespmv_tpu import formats
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.core.types import COOMatrix

    one = COOMatrix.from_triplets(5, 7, np.array([3]), np.array([6]),
                                  np.array([2.5]))
    x = np.arange(7, dtype=np.float64)
    want = np.zeros(5)
    want[3] = 2.5 * 6
    for fmt in formats.available_formats():
        if fmt == "crs":
            continue
        cfg = Config(format=fmt, dtype="float64", segment_width=128)
        st = formats.convert(one, cfg)
        y = np.asarray(jax.jit(formats.spmv_fn(cfg))(st, x))
        np.testing.assert_allclose(y, want, rtol=1e-12, err_msg=fmt)


def test_csr5_convert_timings_on_instance():
    """Convert-phase timings live on the state instance (no global id-keyed
    side table that grows across sweeps or mixes up recycled ids)."""
    from singlespmv_tpu import formats
    from singlespmv_tpu.config import Config
    from singlespmv_tpu.data.generators import powerlaw
    from singlespmv_tpu.formats import csr5 as csr5_mod

    assert not hasattr(csr5_mod, "_LAST_CONVERT_MS")
    cfg = Config(format="csr5", dtype="float64")
    states = [formats.convert(powerlaw(128, 1500, seed=s), cfg)
              for s in range(3)]
    for st in states:
        fields = formats.report_fields(st, cfg)
        assert "Convert-malloc(ms)" in fields
        assert "Convert-transpose(ms)" in fields
    # timings are per-instance and distinct objects
    assert states[0]._convert_ms is not states[1]._convert_ms
