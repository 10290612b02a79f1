"""singlespmv_tpu — a sparse linear-algebra framework in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA re-design with the capabilities of the reference
single-node SpMV benchmark laboratory (hir0shim/singleSpMV): a swappable format zoo
(COO, CSR, ELL, JDS, DIA, SS, CSS, CSR5-tiled + dense/XLA-sparse vendor baselines)
behind a fixed (convert, spmv) op pair, a verified/calibrated/best-of-N benchmark
harness with the reference's key-value report block, a matrix data layer (fixtures,
generators, SuiteSparse tooling), a sweep runner + TSV pipeline, SpMM/SpGEMM/SpTRSV,
and multi-chip sharding via jax.sharding/shard_map.
"""
from .config import Config, DEFAULT

# Host-memory setup: on this machine's microVM kernel a 2 MB huge-page write
# fault stalls ~360 ms, and numpy madvises MADV_HUGEPAGE on every >= 4 MB
# buffer by default — making convert-time numpy work (np.empty/full/arange,
# ufunc temporaries) minutes-slow at GB scale.  Turn numpy's madvise off and
# install the freelist NEP-49 allocator (core/native/npalloc_native.c).
# Disable with SPMV_NO_HUGEPAGE_ALLOC=1.
import os as _os

if not _os.environ.get("SPMV_NO_HUGEPAGE_ALLOC"):
    try:
        import numpy as _np

        _np._core.multiarray._set_madvise_hugepage(False)
    except Exception:
        pass
from .core.native import install_hugepage_allocator as _install_npalloc

_install_npalloc()
del _install_npalloc, _os

__version__ = "0.2.0"

__all__ = ["Config", "DEFAULT", "__version__"]


def __getattr__(name):
    # Lazy convenience access: singlespmv_tpu.formats / .ops / .parallel etc.
    if name in ("formats", "core", "ops", "parallel", "harness", "data"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
