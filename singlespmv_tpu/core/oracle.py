"""Verification oracle.

Scalar COO SpMV in float64 on the host + the reference's abs-OR-rel ≤ tol check
(/root/reference/src/util.cpp:67-83: ``VerifyResult`` recomputes y from the COO
triplets and passes an element iff ``|y-ref| <= tol`` or ``|y-ref|/|ref| <= tol``).

The reference computes in f64 with tol=1e-6.  The device pipeline runs float64 or
float32, so the tolerance is scaled by dtype: f64 keeps 1e-6; f32 uses a
row-length-aware bound (summing k products of f32 inputs accumulates ~k·eps relative
error in the worst case).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .types import COOMatrix

DEFAULT_TOL = 1e-6


def _row_sums(coo: COOMatrix, terms: np.ndarray) -> np.ndarray:
    """y[r] = Σ terms[i] over row[i] == r, in float64 (np.bincount)."""
    return np.bincount(coo.row, weights=terms,
                       minlength=coo.n_row).astype(np.float64)[: coo.n_row]


def reference_spmv(coo: COOMatrix, x: np.ndarray) -> np.ndarray:
    """Float64 COO oracle: y[r] += val[i] * x[col[i]]."""
    return _row_sums(coo, np.asarray(coo.val, dtype=np.float64)
                     * np.asarray(x, dtype=np.float64)[coo.col])


def tolerance_for(coo: COOMatrix, dtype) -> float:
    name = getattr(dtype, "name", None) or str(dtype)
    if "float64" in name:
        return DEFAULT_TOL
    # Reduced precision: worst-case accumulation error grows with the longest
    # row; bf16 has an 8-bit mantissa (eps = 2^-8).  Floor at 128 terms: the
    # scan formats (ss, css, csr5) add in tree order over whole stream tiles,
    # so their rounding scales with the tile's content, not just the row's.
    max_row = int(coo.row_lengths().max(initial=1))
    eps = 2.0 ** -8 if "bfloat16" in name else float(np.finfo(np.float32).eps)
    return max(DEFAULT_TOL, 16.0 * eps * np.sqrt(max(max_row, 128.0)))


def verify_result(
    coo: COOMatrix,
    x: np.ndarray,
    y: np.ndarray,
    *,
    tol: Optional[float] = None,
    dtype=np.float32,
) -> Tuple[bool, dict]:
    """abs-or-rel check of y against the f64 oracle. Returns (ok, details)."""
    ref = reference_spmv(coo, x)
    y = np.asarray(y, dtype=np.float64)
    if tol is None:
        tol = tolerance_for(coo, dtype)
    abs_err = np.abs(y - ref)
    denom = np.abs(ref)
    rel_err = np.where(denom > 0, abs_err / np.maximum(denom, 1e-300), abs_err)
    # Third disjunct: the componentwise backward bound |ŷ−y| ≤ c·eps·(|A||x|)
    # — rows with heavy cancellation (Σ|aᵢxᵢ| ≫ |y|) cannot beat this in ANY
    # reduced-precision summation order; the abs/rel tol alone would reject
    # every correct f32 kernel on such rows.
    name = getattr(dtype, "name", None) or str(dtype)
    eps = (2.0 ** -8 if "bfloat16" in name
           else float(np.finfo(np.float32).eps)) \
        if "float64" not in name else float(np.finfo(np.float64).eps)
    absref = _row_sums(coo, np.abs(np.asarray(coo.val, dtype=np.float64)
                                   * np.asarray(x, dtype=np.float64)[coo.col]))
    bwd = 64.0 * eps * absref
    ok_elem = (abs_err <= tol) | (rel_err <= tol) | (abs_err <= bwd)
    ok = bool(ok_elem.all())
    worst = int(np.argmax(np.where(ok_elem, -1.0, np.minimum(abs_err, rel_err))))
    details = {
        "tol": tol,
        "max_abs_err": float(abs_err.max(initial=0.0)),
        "max_rel_err": float(rel_err.max(initial=0.0)),
        "n_bad": int((~ok_elem).sum()),
        "worst_index": worst,
        "worst_got": float(y[worst]) if y.size else 0.0,
        "worst_want": float(ref[worst]) if ref.size else 0.0,
    }
    return ok, details
