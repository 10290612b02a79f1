"""Tests that need an NVIDIA GPU (marker ``gpu``; they skip elsewhere).

Run on a card with: ``SPMV_TEST_DEVICE=gpu python -m pytest tests -m gpu``.
"""
import numpy as np
import pytest

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.oracle import verify_result
from singlespmv_tpu.data.generators import generate, powerlaw

from conftest import rand_x

KEPT = ["coo", "csr", "ell", "jds", "dia", "ss", "css", "csr5", "bsr", "dense",
        "bcoo", "hyb", "auto"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fmt", KEPT)
def test_format_compiles_and_verifies_on_gpu(gpu_device, fmt, dtype):
    """Every kept format compiles for the card and passes the f64 oracle."""
    from singlespmv_tpu.harness.driver import run_benchmark

    res = run_benchmark(powerlaw(2000, 30000, seed=4),
                        Config(format=fmt, dtype=dtype), quick=True,
                        log=lambda m: None)
    assert res.report["Architecture"] == "GPU"
    assert res.verify_ok, res.report
    assert res.auto_excluded == ()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bcoo_lowers_to_cusparse(gpu_device, dtype):
    """The library path hands the product to cuSPARSE on the card."""
    import jax

    from singlespmv_tpu import formats

    cfg = Config(format="bcoo", dtype=dtype)
    coo = generate("random", 256, 2000, seed=2)
    with jax.enable_x64(dtype == "float64"):
        st = formats.convert(coo, cfg)
        x = rand_x(coo.n_col).astype(cfg.np_dtype)
        hlo = jax.jit(formats.spmv_fn(cfg)).lower(st, x).as_text()
    assert "cusparse" in hlo.lower()


@pytest.mark.gpu
def test_dense_float32_is_not_tf32(gpu_device):
    """A dense float32 product with 24-bit-significant inputs passes the f32
    oracle bound only if it is not computed in TF32 (10-bit mantissa)."""
    import jax

    from singlespmv_tpu import formats

    cfg = Config(format="dense", dtype="float32")
    coo = generate("dense", 512, seed=5)
    st = formats.convert(coo, cfg)
    x = (1.0 + np.random.default_rng(0).uniform(0, 1e-3, 512)).astype(
        np.float32)
    y = np.asarray(jax.jit(formats.spmv_fn(cfg))(st, x))
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, det
