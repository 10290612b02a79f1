"""Native (C++) runtime components, bound via ctypes.

The reference's runtime is all C++; here the JAX/XLA/Pallas side owns compute
while I/O-heavy host paths run native:

- ``mmio_native.cpp`` — Matrix-Market parser (the analog of
  /root/reference/src/util.cpp:30-66 and the vendored mmio.c);
- ``logfmt_native.cpp`` — report-block → TSV formatter (log/format.cpp).

Shared libraries compile on demand with g++ and cache next to the sources;
every entry point has a pure-Python fallback, so the package works without a
toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_libs = {}
_failed = set()


def _build(src: str, out: str, extra_flags=()) -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src,
           *extra_flags, "-o", out + ".tmp"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(out + ".tmp", out)
        return True
    except Exception:
        return False


def _get_lib(name: str, src_name: str) -> Optional[ctypes.CDLL]:
    src = os.path.join(_DIR, src_name)
    lib_path = os.path.join(_DIR, name)
    with _lock:
        if name in _libs:
            return _libs[name]
        if name in _failed:
            return None
        if not os.path.exists(lib_path) or (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(lib_path)
        ):
            if not _build(src, lib_path):
                _failed.add(name)
                return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            _failed.add(name)
            return None
        _libs[name] = lib
        return lib


# --------------------------------------------------------------- npalloc ----

_npalloc_mod = None
_npalloc_tried = False


def install_hugepage_allocator() -> bool:
    """Install the NEP-49 hugepage numpy allocator (npalloc_native.c).

    On this machine first-touch page faults run ~1 ms/page, making fresh
    numpy buffers (np.empty/full/arange and ufunc temporaries) pathologically
    slow at GB scale; the handler maps data 2 MB-aligned with MADV_HUGEPAGE
    and reuses mappings via a freelist.  Returns True if installed.
    """
    global _npalloc_mod, _npalloc_tried
    if _npalloc_mod is not None:
        return True
    if _npalloc_tried:
        return False
    _npalloc_tried = True
    if os.environ.get("SPMV_NO_HUGEPAGE_ALLOC"):
        return False
    src = os.path.join(_DIR, "npalloc_native.c")
    lib_path = os.path.join(_DIR, "_npalloc.so")
    try:
        import sysconfig

        if not os.path.exists(lib_path) or (
            os.path.getmtime(src) > os.path.getmtime(lib_path)
        ):
            flags = ["-I" + sysconfig.get_paths()["include"],
                     "-I" + np.get_include()]
            if not _build(src, lib_path, flags):
                return False
        import importlib.machinery
        import importlib.util

        loader = importlib.machinery.ExtensionFileLoader("_npalloc", lib_path)
        spec = importlib.util.spec_from_loader("_npalloc", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        mod.install()
        _npalloc_mod = mod
        return True
    except Exception:
        return False


def npalloc_stats():
    """Allocator counters (freelist hits, mmaps) or None if not installed."""
    return _npalloc_mod.stats() if _npalloc_mod is not None else None


def npalloc_prefault(total_bytes: int, block_bytes: int = 1 << 30) -> int:
    """Pay the kernel's one-time slow-fault cost up front.

    Beyond ~2.5 GB of process-lifetime fresh pages, anonymous first-touch
    faults on this machine run ~25-90 s/GB; blocks touched here land on the
    allocator freelist already warm, so convert-path temporaries reuse them
    at memset speed (~5 GB/s).  Returns the number of blocks prefaulted
    (0 if the native allocator is not installed).
    """
    if _npalloc_mod is None:
        return 0
    got = 0
    # ladder: half the budget in big blocks, the rest across smaller classes
    # (converts make temporaries at every scale; cross-class reuse covers 4x)
    remaining = total_bytes
    cap = block_bytes
    while remaining > 0 and cap >= (4 << 20):
        count = max(1, (remaining // 2) // cap) if cap > (4 << 20) else \
            max(1, remaining // cap)
        got += _npalloc_mod.prefault(cap, count)
        remaining -= count * cap
        cap //= 4
    return got


# ------------------------------------------------------------------ mmio ----

class _MtxResult(ctypes.Structure):
    _fields_ = [
        ("n_row", ctypes.c_int64),
        ("n_col", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int64)),
        ("cols", ctypes.POINTER(ctypes.c_int64)),
        ("vals", ctypes.POINTER(ctypes.c_double)),
        ("err", ctypes.c_char * 256),
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    lib = _get_lib("_mmio.so", "mmio_native.cpp")
    if lib is not None and not hasattr(lib, "_configured"):
        lib.spmv_load_mtx.restype = ctypes.POINTER(_MtxResult)
        lib.spmv_load_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.spmv_free_result.restype = None
        lib.spmv_free_result.argtypes = [ctypes.POINTER(_MtxResult)]
        lib._configured = True
    return lib


def load_mtx(path: str, *, index_bits: int = 32, sum_duplicates: bool = False):
    """Parse path with the native library; None if the library is unavailable."""
    from ..types import COOMatrix, INDEX_DTYPES

    lib = get_lib()
    if lib is None:
        return None
    res = lib.spmv_load_mtx(os.fsencode(path), 1 if sum_duplicates else 0)
    if not res:
        return None
    try:
        r = res.contents
        err = bytes(r.err).split(b"\0", 1)[0]
        if err:
            from ..mmio import MatrixMarketError

            raise MatrixMarketError(f"{path}: {err.decode()}")
        n = int(r.nnz)
        rows = np.ctypeslib.as_array(r.rows, shape=(n,)).copy() if n else \
            np.zeros(0, np.int64)
        cols = np.ctypeslib.as_array(r.cols, shape=(n,)).copy() if n else \
            np.zeros(0, np.int64)
        vals = np.ctypeslib.as_array(r.vals, shape=(n,)).copy() if n else \
            np.zeros(0, np.float64)
        idx_t = INDEX_DTYPES[index_bits]
        return COOMatrix(
            n_row=int(r.n_row), n_col=int(r.n_col),
            row=rows.astype(idx_t), col=cols.astype(idx_t), val=vals,
        )
    finally:
        lib.spmv_free_result(res)


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------- logfmt ----

def get_logfmt_lib() -> Optional[ctypes.CDLL]:
    lib = _get_lib("_logfmt.so", "logfmt_native.cpp")
    if lib is not None and not hasattr(lib, "_configured"):
        lib.spmv_format_logs.restype = ctypes.c_void_p
        lib.spmv_format_logs.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.spmv_free_text.restype = None
        lib.spmv_free_text.argtypes = [ctypes.c_void_p]
        lib._configured = True
    return lib


def format_logs(text: str, extra_keys=None) -> Optional[str]:
    """Native block→TSV formatter; None if the library is unavailable."""
    lib = get_logfmt_lib()
    if lib is None:
        return None
    extra = "\n".join(extra_keys or [])
    ptr = lib.spmv_format_logs(text.encode(), extra.encode())
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.spmv_free_text(ptr)


# ---------------------------------------------------------------- factor ----

def get_factor_lib() -> Optional[ctypes.CDLL]:
    lib = _get_lib("_factor.so", "factor_native.cpp")
    if lib is not None and not hasattr(lib, "_configured"):
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        for fn in (lib.spmv_ilu0, lib.spmv_ic0):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_int64, i64p, i64p, f64p]
        lib._configured = True
    return lib


def ilu0_csr(rp: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """In-place native ILU(0) on CSR arrays; returns failing row or None if
    the native library is unavailable; 0 on success."""
    lib = get_factor_lib()
    if lib is None:
        return None
    n = len(rp) - 1
    rc = lib.spmv_ilu0(n, np.ascontiguousarray(rp, np.int64),
                       np.ascontiguousarray(cols, np.int64), vals)
    return int(rc)


def ic0_csr(rp: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """In-place native IC(0) on lower-triangular CSR arrays; see ilu0_csr."""
    lib = get_factor_lib()
    if lib is None:
        return None
    n = len(rp) - 1
    rc = lib.spmv_ic0(n, np.ascontiguousarray(rp, np.int64),
                      np.ascontiguousarray(cols, np.int64), vals)
    return int(rc)


def tri_levels(rp: np.ndarray, cols: np.ndarray, *, lower: bool):
    """Native dependency-level computation for SpTRSV analysis; returns the
    level array or None if the native library is unavailable."""
    lib = get_factor_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_levels_configured"):
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.spmv_tri_levels.restype = ctypes.c_int64
        lib.spmv_tri_levels.argtypes = [ctypes.c_int64, i64p, i64p,
                                        ctypes.c_int64, i64p]
        lib._levels_configured = True
    n = len(rp) - 1
    level = np.zeros(n, dtype=np.int64)
    lib.spmv_tri_levels(n, np.ascontiguousarray(rp, np.int64),
                        np.ascontiguousarray(cols, np.int64),
                        1 if lower else 0, level)
    return level


# ------------------------------------------------------------ radix sort ----

def get_sort_lib() -> Optional[ctypes.CDLL]:
    return _get_lib("_sort.so", "sort_native.cpp")


def radix_argsort(keys: np.ndarray) -> Optional[np.ndarray]:
    """Stable parallel radix argsort for non-negative integer keys.

    Returns the permutation (int64) or None when the native library is
    unavailable (callers fall back to np.argsort).  ~20-30x numpy's introsort
    at 100 M keys on a 4-core host — the convert-time hotspot of the giant
    suite matrices.
    """
    lib = get_sort_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_sort_configured"):
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.radix_argsort_u64.restype = ctypes.c_int
        lib.radix_argsort_u64.argtypes = [u64p, ctypes.c_int64, i64p]
        lib._sort_configured = True
    k = np.ascontiguousarray(keys).view(np.uint64) \
        if keys.dtype == np.int64 else \
        np.ascontiguousarray(keys.astype(np.uint64))
    out = np.zeros(len(k), dtype=np.int64)
    rc = lib.radix_argsort_u64(k, len(k), out)
    return out if rc == 0 else None


# ----------------------------------------------------------- grid scatter ---

def get_scatter_lib() -> Optional[ctypes.CDLL]:
    return _get_lib("_scatter.so", "scatter_native.cpp")


_SCATTER_FNS = {}


def grid_scatter(grid: np.ndarray, rows: np.ndarray, lanes: np.ndarray,
                 vals) -> bool:
    """grid[rows, lanes] = vals with OpenMP (positions must be unique —
    every convert slot owns one grid cell).  Returns False when the native
    library is unavailable (callers fall back to numpy fancy indexing)."""
    lib = get_scatter_lib()
    if lib is None or grid.ndim != 2 or not grid.flags.c_contiguous:
        return False
    dt = grid.dtype
    name = {np.dtype(np.int8): "grid_scatter_i8",
            np.dtype(np.float32): "grid_scatter_f32",
            np.dtype(np.float64): "grid_scatter_f64"}.get(dt)
    if name is None:
        return False
    if name not in _SCATTER_FNS:
        fn = getattr(lib, name)
        p = np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, ctypes.c_int64, i64p, i64p, p, ctypes.c_int64]
        _SCATTER_FNS[name] = fn
    fn = _SCATTER_FNS[name]
    rows = np.ascontiguousarray(rows, np.int64)
    lanes = np.ascontiguousarray(lanes, np.int64)
    vals_a = np.ascontiguousarray(np.broadcast_to(vals, rows.shape), dt)
    fn(grid, grid.shape[1], rows, lanes, vals_a, len(rows))
    return True
