"""Format plugin layer.

The reference fixes a 4-symbol interface per format — ``SpMatOpt``, ``VecOpt``,
``OptimizeProblem(A,x,A_opt,x_opt)``, ``SpMV(A_opt,x_opt,y)`` — and link-time selects
exactly one (/root/reference/src/opt.h:1-29).  Here every format is a module
registered at import time exposing:

    convert(coo: COOMatrix, cfg: Config) -> state      # OptimizeProblem analog
    spmv(state, x: jax.Array) -> jax.Array             # jittable hot op
    phases(state) -> dict[str, fn] | None              # optional Mul/Sum split for
                                                       # the profiling harness
    report_fields(state, cfg) -> dict                  # format-specific report keys
    traffic_bytes(state, cfg) -> int                   # roofline traffic model

States are frozen dataclasses registered as JAX pytrees with static metadata, so
``jax.jit(spmv)`` retraces only when shapes/meta change (the analog of one compiled
binary per configuration, Makefile:10-21 — XLA recompilation replaces `make`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import jax
import numpy as np

from ..config import Config
from ..core.types import COOMatrix

_REGISTRY: Dict[str, Any] = {}


def register_format(name: str, module) -> None:
    _REGISTRY[name] = module


def get_format(name: str):
    from . import _ensure_loaded  # noqa: F401  (populate registry lazily)

    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown format {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_formats():
    from . import _ensure_loaded

    _ensure_loaded()
    return sorted(_REGISTRY)


def pytree_dataclass(cls=None, *, meta: tuple = ()):
    """Freeze + register a dataclass as a pytree; ``meta`` fields are static."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        fields = [f.name for f in dataclasses.fields(c)]
        data_fields = [f for f in fields if f not in meta]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(meta)
        )
        return c

    return wrap if cls is None else wrap(cls)


def device_put(arr: np.ndarray, dtype=None):
    import jax.numpy as jnp

    return jnp.asarray(arr if dtype is None else arr.astype(dtype))


def convert(coo: COOMatrix, cfg: Config):
    if cfg.dtype == "float64":
        # without x64, jnp.asarray silently truncates f64 operands to f32 —
        # the f64 paths (csr/ss emulation, hostlib) need real f64 leaves.
        # The full test suite runs green with x64 on, so this is safe to
        # flip globally on first f64 use.
        import jax

        jax.config.update("jax_enable_x64", True)
    return get_format(cfg.format).convert(coo, cfg)


def spmv_fn(cfg: Config) -> Callable:
    return get_format(cfg.format).spmv


def spmm_fn(cfg: Config) -> Callable:
    """SpMM (dense-panel right-hand side).  Formats with a native matmul/scan path
    export ``spmm``; others fall back to vmapping spmv over the panel columns."""
    mod = get_format(cfg.format)
    native = getattr(mod, "spmm", None)
    if native is not None:
        return native

    def fallback(state, X):
        return jax.vmap(mod.spmv, in_axes=(None, 1), out_axes=1)(state, X)

    return fallback


def to_coo(state, cfg: Config) -> COOMatrix:
    """Inverse conversion back to host COO (the CSR5 ``asCSR`` analog)."""
    return get_format(cfg.format).to_coo(state)


def phases_fn(cfg: Config) -> Optional[Callable]:
    return getattr(get_format(cfg.format), "phases", None)


def report_fields(state, cfg: Config) -> dict:
    fn = getattr(get_format(cfg.format), "report_fields", None)
    return fn(state, cfg) if fn else {}


def traffic_bytes(state, cfg: Config) -> int:
    fn = getattr(get_format(cfg.format), "traffic_bytes", None)
    if fn:
        return int(fn(state, cfg))
    # Default CSR-style traffic model (CSR5_avx2/detail/utils.h:10-14):
    # (m+1+nnz) indices + (2·nnz+m) values.
    m, nnz = state.n_row, state.nnz
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = np.dtype(cfg.dtype).itemsize
    return (m + 1 + nnz) * isz + (2 * nnz + m) * vsz
