"""Fast host allocations on slow-page-fault machines.

On sandboxed kernels (gVisor-class: this machine) anonymous first-touch write
faults cost ~1 ms/page (~5 MB/s), so ``np.empty``/``np.full``/``np.arange``/
``astype`` — which malloc then write — take *minutes* at GB scale, while the
``np.zeros`` (calloc) path maps pre-zeroed memory that writes at full speed
(measured on such a host: 400 MB fill 38.6 s via empty+fill vs 0.05 s via
zeros+fill).  Every large allocation in convert paths
must go through these helpers.

No reference analog — the reference's `_mm_malloc` arenas
(/root/reference/src/util.cpp:92-102) never face lazy-fault costs.
"""
from __future__ import annotations

import numpy as np


def zeros(shape, dtype=np.float64) -> np.ndarray:
    return np.zeros(shape, dtype)


def full(shape, value, dtype) -> np.ndarray:
    """np.full through the calloc fast path."""
    out = np.zeros(shape, dtype)
    if value != 0:
        out.fill(value)
    return out


def arange(n: int, dtype=np.int64) -> np.ndarray:
    """np.arange through the calloc fast path (in-place cumsum of ones)."""
    out = np.zeros(n, dtype)
    if n > 1:
        out[1:] = 1
        np.cumsum(out, out=out)
    return out


def astype(x: np.ndarray, dtype) -> np.ndarray:
    """x.astype(dtype) writing into calloc'd memory."""
    dtype = np.dtype(dtype)
    if x.dtype == dtype:
        return x
    out = np.zeros(x.shape, dtype)
    np.copyto(out, x, casting="unsafe")
    return out


def argsort_keys(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative integer keys: native parallel radix
    when available (core/native/sort_native.cpp), numpy otherwise."""
    if len(keys) >= (1 << 16):
        from . import native

        out = native.radix_argsort(keys)
        if out is not None:
            return out
    return np.argsort(keys, kind="stable")


def scatter2d(grid, rows, lanes, vals):
    """grid[rows, lanes] = vals — native OpenMP scatter when available
    (positions unique by construction in convert layouts), numpy fallback."""
    from . import native

    if not native.grid_scatter(grid, rows, lanes, vals):
        grid[rows, lanes] = vals


def unique(a: np.ndarray) -> np.ndarray:
    """Sorted unique values of ``a`` (what plain ``np.unique`` returns).

    Sort-based: the hash-based ``np.unique`` of newer NumPy releases runs
    about 1 µs per element on tens of millions of distinct int64 keys, tens
    of times slower than sorting them."""
    a = np.sort(np.asarray(a).ravel())
    if a.size == 0:
        return a
    keep = np.empty(a.size, dtype=bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]
