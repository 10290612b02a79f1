"""Runtime configuration.

The reference's flag registry is entirely compile-time ``-D`` defines
(/root/reference/Makefile:10-21, defaults /root/reference/src/param.h:1-21):
architecture (CPU|MIC|GPU), format (OPT_*), kernel variant (SIMPLE|OPTIMIZED),
SEGMENT_WIDTH / PADDING / N_BLOCK / ALIGNMENT / INDEX_32/64, and instrumentation
(VERIFY / PROFILING / MEASURE_STEP_TIME).  XLA recompilation replaces recompiling
C++, so the same registry becomes a runtime dataclass with identical parameter names.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Config:
    # --- format selection (reference: OPT_* defines, Makefile:12) ---
    format: str = "csr"             # see formats.available_formats()
    variant: str = "optimized"      # simple|optimized (reference: SIMPLE|OPTIMIZED)

    # --- layout / tuning parameters (reference: param.h) ---
    segment_width: int = 2048       # SS/CSS stream tile width, in elements (SEGMENT_WIDTH)
    n_block: int = 1                # CSS column blocking factor (N_BLOCK)
    padding: bool = True            # pad streams/rows to hardware tiles (PADDING)
    index_bits: int = 32            # INDEX_32 / INDEX_64
    # omega / row_block / lane_width follow an (8, 128) tiling; the XLA-level
    # formats run with any values.  They are not yet re-tuned for the GPU.
    omega: int = 128                # CSR5 tile lanes (ω)
    sigma: int = 16                 # CSR5 tile depth (σ); 0 = auto-tune from nnz/row
    row_block: int = 8              # BSR block height (rows per tile)
    lane_width: int = 128           # stream/tile width: ELL/DIA row padding,
    #                                 BSR block width, SS segment granularity

    auto_exclude: tuple = ()        # auto planner: formats to skip (driver
    #                                 retry path after a device OOM/crash)
    spmm_b: int = 0                 # auto planner: plan for SpMM with a
    #                                 B-column panel (0 = plan for SpMV).
    #                                 A dense panel amortizes the sparse
    #                                 index streams, flipping block-structured
    #                                 matrices to the matrix-product formats
    #                                 (bsr/dense).

    # --- numerics ---
    dtype: str = "float32"          # value dtype on device: float32|float64|bfloat16

    # --- instrumentation (reference: VERIFY / PROFILING / MEASURE_STEP_TIME) ---
    verify: bool = True
    profiling: bool = False
    measure_step_time: bool = False

    # --- harness (reference: main.cpp:58-102) ---
    calibrate_seconds: float = 1.0  # double loop count until a trial takes this long
    n_trials: int = 10              # best-of-N timing
    max_loop: int = 1 << 20

    # --- parallel ---
    mesh_shape: Optional[tuple] = None  # e.g. (("row", 4), ("col", 2)); None = single chip

    @property
    def np_dtype(self):
        if self.dtype == "bfloat16":
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.dtype)

    @property
    def index_dtype(self):
        return np.int32 if self.index_bits == 32 else np.int64

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()
