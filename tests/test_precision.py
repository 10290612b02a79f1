"""GPU-facing numerics and the absence of backend-specific code paths.

float32 products must ask for Precision.HIGHEST (the GPU would otherwise run
them in TF32); no module uses Pallas, runs a kernel in interpret mode, or
branches on the name of an accelerator backend.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singlespmv_tpu import formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.data.generators import generate

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "singlespmv_tpu")


def _dot_eqns(closed):
    """The precision param of every dot_general, nested jaxprs included."""
    out = []

    def walk(jaxpr):
        for eq in jaxpr.eqns:
            if eq.primitive.name == "dot_general":
                out.append(eq.params["precision"])
            for p in eq.params.values():
                for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed.jaxpr)
    return out


def _all_highest(precs):
    hi = jax.lax.Precision.HIGHEST
    return bool(precs) and all(
        p is not None and all(q == hi for q in (p if isinstance(p, tuple)
                                                else (p,)))
        for p in precs)


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_dense_f32_products_are_highest(op):
    from singlespmv_tpu.formats import dense

    cfg = Config(format="dense", dtype="float32")
    st = formats.convert(generate("dense", 16, seed=1), cfg)
    arg = (jnp.ones(16, jnp.float32) if op == "spmv"
           else jnp.ones((16, 3), jnp.float32))
    closed = jax.make_jaxpr(getattr(dense, op))(st, arg)
    assert _all_highest(_dot_eqns(closed)), closed


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_solver_vdots_are_highest(solver, monkeypatch):
    """Every dot product inside the jitted solver loop asks for HIGHEST."""
    from singlespmv_tpu.ops import solvers

    seen = []
    real_jit = jax.jit

    def spy_jit(fn, *a, **k):
        def traced(*args):
            seen.append(jax.make_jaxpr(fn)(*args))
            return real_jit(fn, *a, **k)(*args)
        return traced

    monkeypatch.setattr(solvers.jax, "jit", spy_jit)
    from singlespmv_tpu.core.types import COOMatrix

    diag = np.arange(32)
    coo = COOMatrix.from_triplets(32, 32, diag, diag, np.full(32, 4.0))
    getattr(solvers, solver)(coo, np.ones(32), maxiter=3,
                             cfg=Config(format="csr", dtype="float32"))
    assert seen
    precs = _dot_eqns(seen[0])
    assert len(precs) >= (3 if solver == "cg" else 4)
    assert _all_highest(precs)


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(root, f)
                yield os.path.relpath(p, PKG), open(p).read()


def test_no_pallas_or_interpret_mode():
    bad = [(name, pat) for name, src in _sources()
           for pat in ("experimental.pallas", "experimental import pallas",
                       "interpret=")
           if pat in src]
    bad += [(name, "backend branch") for name, src in _sources()
            if re.search(r'default_backend\(\)\s*[!=]=\s*"(?!cpu")', src)]
    assert not bad, bad


def test_no_pallas_package_left():
    assert not os.path.exists(os.path.join(PKG, "ops", "pallas"))
    for gone in ("ops/df64.py", "formats/slab.py", "formats/xch.py",
                 "formats/bkt.py", "formats/ellg.py", "parallel/xchd.py"):
        assert not os.path.exists(os.path.join(PKG, gone)), gone
