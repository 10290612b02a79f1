"""Converted-state cache (checkpoint/resume analog) tests."""
import numpy as np

import jax

from singlespmv_tpu import formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.core.oracle import verify_result
from singlespmv_tpu.core.rng import create_random_vector
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats.cache import convert_cached, load_state, save_state

F64 = Config(dtype="float64", segment_width=128)


def _check(coo, cfg, state):
    x = create_random_vector(coo.n_col)
    y = np.asarray(jax.jit(formats.spmv_fn(cfg))(state, x))
    ok, det = verify_result(coo, x, y, dtype=np.float64)
    assert ok, det


def test_roundtrip_simple(tmp_path):
    coo = generate("band", 96, 5, seed=1)
    cfg = F64.replace(format="csr")
    st = formats.convert(coo, cfg)
    p = str(tmp_path / "s")
    save_state(p, st, coo, cfg)
    st2 = load_state(p, coo, cfg)
    assert st2 is not None and st2.nnz == st.nnz
    _check(coo, cfg, st2)


def test_roundtrip_auto_wrapper(tmp_path):
    coo = generate("band", 512, 8, seed=2)
    cfg = F64.replace(format="auto")
    st = formats.convert(coo, cfg)
    p = str(tmp_path / "auto")
    save_state(p, st, coo, cfg)
    st2 = load_state(p, coo, cfg)
    assert st2.chosen == st.chosen
    _check(coo, cfg, st2)


def test_fingerprint_mismatch_rejected(tmp_path):
    coo = generate("band", 96, 5, seed=1)
    cfg = F64.replace(format="csr")
    p = str(tmp_path / "s")
    save_state(p, formats.convert(coo, cfg), coo, cfg)
    other = generate("band", 96, 5, seed=2)
    assert load_state(p, other, cfg) is None              # different values/nnz
    assert load_state(p, coo, cfg.replace(format="ss")) is None


def test_convert_cached(tmp_path):
    coo = generate("unbalance", 64, seed=3)
    cfg = F64.replace(format="ss")
    st1 = convert_cached(coo, cfg, str(tmp_path), "m1")
    st2 = convert_cached(coo, cfg, str(tmp_path), "m1")   # from disk
    np.testing.assert_array_equal(np.asarray(st1.col), np.asarray(st2.col))
    _check(coo, cfg, st2)


def test_roundtrip_nested_hyb(tmp_path):
    """hyb nests a dia state and a residual state; both survive the cache."""
    from singlespmv_tpu.data.generators import generate as gen

    band = gen("band", 256, 4, seed=2)
    rng = np.random.default_rng(3)
    coo = band.__class__.from_triplets(
        256, 256, np.concatenate([band.row, rng.integers(0, 256, 300)]),
        np.concatenate([band.col, rng.integers(0, 256, 300)]),
        np.concatenate([band.val, rng.uniform(size=300)]),
        sum_duplicates=True)
    cfg = F64.replace(format="hyb")
    st = formats.convert(coo, cfg)
    assert st.rest_fmt
    p = str(tmp_path / "hyb")
    save_state(p, st, coo, cfg)
    st2 = load_state(p, coo, cfg)
    assert st2.rest_fmt == st.rest_fmt and st2.peel_nnz == st.peel_nnz
    _check(coo, cfg, st2)


def test_state_from_other_device_kind_rejected(tmp_path):
    """The fingerprint carries the device kind: a state planned on one
    device is never reused on another."""
    import json

    coo = generate("band", 96, 5, seed=1)
    cfg = F64.replace(format="auto")
    p = str(tmp_path / "s")
    save_state(p, formats.convert(coo, cfg), coo, cfg)
    assert load_state(p, coo, cfg) is not None
    meta = json.loads(open(p + ".json").read())
    assert meta["fingerprint"]["device_kind"] == jax.devices()[0].device_kind
    meta["fingerprint"]["device_kind"] = "Some Other Device"
    with open(p + ".json", "w") as f:
        json.dump(meta, f)
    assert load_state(p, coo, cfg) is None


def test_compile_cache_honours_env(tmp_path, monkeypatch):
    from singlespmv_tpu.core import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_dir(monkeypatch):
    import os

    from singlespmv_tpu.core import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        assert compile_cache.setup() == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
