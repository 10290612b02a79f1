"""Host vendor-library baseline ("vendor" path #1 — the MKL analog).

Reference: /root/reference/src/opt_mkl.cpp builds a CSR with ``mkl_malloc`` and
calls ``mkl_dcsrmv`` (:54) as the independent CPU vendor-library baseline that
cross-checks every other format through the same harness (SURVEY §4.4).  The
equivalent *independent library* here is scipy.sparse's
compiled CSR kernel, called on the host through ``jax.pure_callback`` so it
rides the same jitted driver path as every device format.

Like the reference's cuSPARSE baseline — which uploads x and downloads y on
every call (/root/reference/src/opt_cusparse.cpp:72-82) — the per-call
device↔host transfer is part of the measured time: this is a *library
baseline*, not a performance path.  Native f64 comes for free (host doubles),
which also makes it the second f64 cross-check next to the COO oracle.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..core.types import COOMatrix
from .base import pytree_dataclass

# pure_callback closures must be weight-free; the host matrices live here,
# keyed by a handle carried in the (static) pytree meta.  Entries are
# refcounted by the HostLibState instances that reference them (pytree
# flatten/unflatten clones states, so several instances may share a handle)
# and freed when the last instance dies — without this, a suite run over many
# giant matrices leaks GB-scale host memory.
_HOST_MATS: dict = {}
_REFS: dict = {}
_NEXT = [0]

# This is the MKL-slot baseline, a host library by design (mkl_dcsrmv never
# ran on the accelerator either): the driver places state and x on the CPU
# device, so the jitted benchmark loop compiles for the CPU backend and no
# per-call device<->host copy is timed.  Its report says Architecture CPU.
PREFERRED_DEVICE = "cpu"


@pytree_dataclass(meta=("n_row", "n_col", "nnz", "handle", "dtype_name"))
class HostLibState:
    n_row: int
    n_col: int
    nnz: int
    handle: int
    dtype_name: str
    dummy: object       # zero-size leaf so the pytree has a device anchor

    def __post_init__(self):
        _REFS[self.handle] = _REFS.get(self.handle, 0) + 1

    def __del__(self):
        try:
            n = _REFS.get(self.handle, 0) - 1
            if n <= 0:
                _REFS.pop(self.handle, None)
                _HOST_MATS.pop(self.handle, None)
            else:
                _REFS[self.handle] = n
        except Exception:       # interpreter shutdown: globals may be gone
            pass


def convert(coo: COOMatrix, cfg: Config) -> HostLibState:
    import scipy.sparse as sp

    dt = cfg.np_dtype
    mat = sp.csr_matrix(
        (coo.val.astype(dt), (coo.row, coo.col)),
        shape=(max(coo.n_row, 1), max(coo.n_col, 1)))
    mat.sum_duplicates()
    handle = _NEXT[0]
    _NEXT[0] += 1
    _HOST_MATS[handle] = mat
    import jax

    return HostLibState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                        handle=handle, dtype_name=np.dtype(dt).name,
                        dummy=jax.device_put(np.zeros((1,), dt),
                                             jax.devices("cpu")[0]))


def spmv(state: HostLibState, x):
    import jax

    mat = _HOST_MATS[state.handle]
    dt = np.dtype(state.dtype_name)
    out_t = jax.ShapeDtypeStruct((state.n_row,), dt)

    def host_spmv(xv):
        return (mat @ np.asarray(xv, dtype=dt))[: state.n_row].astype(dt)

    # vectorized=False: the driver's fori_loop calls this once per iteration,
    # matching mkl_dcsrmv's one-call-per-SpMV contract
    return jax.pure_callback(host_spmv, out_t, x, vmap_method="sequential")


def spmm(state: HostLibState, X):
    import jax

    mat = _HOST_MATS[state.handle]
    dt = np.dtype(state.dtype_name)

    def host_spmm(Xv):
        return (mat @ np.asarray(Xv, dtype=dt))[: state.n_row].astype(dt)

    out_t = jax.ShapeDtypeStruct((state.n_row, X.shape[1]), dt)
    return jax.pure_callback(host_spmm, out_t, X, vmap_method="sequential")


def to_coo(state: HostLibState) -> COOMatrix:
    mat = _HOST_MATS[state.handle].tocoo()
    return COOMatrix.from_triplets(state.n_row, state.n_col,
                                   mat.row, mat.col, mat.data, sort=True)


def report_fields(state: HostLibState, cfg: Config) -> dict:
    import scipy

    return {"Library": f"scipy.sparse {scipy.__version__}"}


def traffic_bytes(state: HostLibState, cfg: Config) -> int:
    # standard CSR traffic model (CSR5 detail/utils.h:10-14)
    vsz = np.dtype(cfg.dtype).itemsize
    return ((state.n_row + 1 + state.nnz) * 4
            + (2 * state.nnz + state.n_row) * vsz)
