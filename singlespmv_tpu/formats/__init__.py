"""Format registry — the analog of /root/reference/src/opt.h's ifdef mux, but all
formats coexist at runtime and are selected by Config.format."""
from __future__ import annotations

from .base import (available_formats, convert, get_format, phases_fn,
                   report_fields, spmm_fn, spmv_fn, to_coo, traffic_bytes)

_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (auto, bcoo, bsr, coo, csr, csr5, css, dense, dia, ell,
                   hostlib, hyb, jds, ss)
    from .base import register_format

    register_format("auto", auto)
    register_format("hyb", hyb)
    register_format("bsr", bsr)
    register_format("coo", coo)
    register_format("csr", csr)
    register_format("crs", csr)  # reference spelling (opt_crs)
    register_format("ell", ell)
    register_format("jds", jds)
    register_format("dia", dia)
    register_format("ss", ss)
    register_format("css", css)
    register_format("csr5", csr5)
    register_format("dense", dense)
    register_format("bcoo", bcoo)
    register_format("hostlib", hostlib)
    register_format("mkl", hostlib)  # reference slot name (opt_mkl)


__all__ = [
    "available_formats", "convert", "get_format", "phases_fn",
    "report_fields", "spmm_fn", "spmv_fn", "to_coo", "traffic_bytes",
]
