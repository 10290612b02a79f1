"""Test configuration.

Tests run on the CPU backend with 8 virtual devices (multi-device sharding
tests).  Must be set before jax imports.  ``SPMV_TEST_DEVICE=gpu`` leaves the
default backend alone, so the tests marked ``gpu`` run on an attached card
(``SPMV_TEST_DEVICE=gpu python -m pytest tests -m gpu``); everywhere else they
skip.  Whether a card is present is decided in the ``gpu_device`` fixture, never
at import or collection, so every worker collects the same tests.
"""
import os

ON_GPU = os.environ.get("SPMV_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from singlespmv_tpu.config import Config  # noqa: E402
from singlespmv_tpu.core import chipconst  # noqa: E402
from singlespmv_tpu.data import fixtures as fx  # noqa: E402
from singlespmv_tpu.data.generators import generate, powerlaw  # noqa: E402


def all_test_matrices():
    """(name, COOMatrix) pairs covering every format's pathological cases."""
    mats = [(n, f()) for n, f in fx.ALL_FIXTURES.items()]
    mats += [
        ("band-64", generate("band", 64, 5, seed=1)),
        ("band-art-128", generate("band", 128, artificial=True, seed=2)),
        ("dense-32", generate("dense", 32, seed=3)),
        ("unbalance-64", generate("unbalance", 64, seed=4)),
        ("unbalance-art-64", generate("unbalance", 64, artificial=True, seed=4)),
        ("random_unbalance-32", generate("random_unbalance", 32, seed=5)),
        ("random-128", generate("random", 128, 900, seed=6)),
        ("powerlaw-256", powerlaw(256, 4000, seed=8)),
    ]
    return mats


@pytest.fixture(scope="session")
def matrices():
    return all_test_matrices()


@pytest.fixture(scope="session")
def f64_cfg():
    return Config(dtype="float64")


def rand_x(n, seed=3):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=n)


# Planner rates injected for every test, so no test measures the host and the
# planner's choices are deterministic.  Made-up values of a plausible
# accelerator (streamed bytes cheap, random gathers and scatter-adds dearer);
# they are inputs to the mechanism under test, not measurements.
TEST_CONSTANTS = {"hbm_bps": 2.0e12, "gather_rate": 50e9,
                  "scatter_rate": 50e9, "matmul_flops": 50e12}


@pytest.fixture(autouse=True, scope="session")
def _planner_constants():
    chipconst.inject(TEST_CONSTANTS)
    yield
    chipconst.inject(None)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with SPMV_TEST_DEVICE=gpu)")
    return gpus[0]
