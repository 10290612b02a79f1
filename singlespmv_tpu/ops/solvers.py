"""Iterative solvers on top of the format zoo's SpMV (production-use layer).

No reference analog (the reference benchmarks the kernel; these consume it).
Solvers are jit-compiled ``lax.while_loop``s over a converted format state —
any registered format works, including `auto` — with an optional preconditioner
(ops.ilu).  Shows the framework as a usable sparse library, not just a harness.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import numpy as np

from ..config import Config
from ..core.types import COOMatrix
from .. import formats

# float32 dot products must not drop to TF32 on the GPU
HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    iterations: int
    residual: float
    converged: bool


def _setup(coo: COOMatrix, cfg: Optional[Config]):
    cfg = cfg or Config(format="auto", dtype="float32", verify=False)
    state = formats.convert(coo, cfg)
    spmv = formats.spmv_fn(cfg)
    return cfg, state, spmv


def cg(coo: COOMatrix, b, *, cfg: Optional[Config] = None, tol: float = 1e-6,
       maxiter: int = 1000, M: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients (SPD A), optionally preconditioned."""
    import jax
    import jax.numpy as jnp

    cfg, state, spmv = _setup(coo, cfg)
    b = jnp.asarray(np.asarray(b, dtype=cfg.np_dtype))
    Mi = M if M is not None else (lambda v: v)

    def body(carry):
        x, r, z, p, rz, it = carry
        Ap = spmv(state, p)
        alpha = rz / jnp.vdot(p, Ap, precision=HI)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Mi(r)
        rz_new = jnp.vdot(r, z, precision=HI)
        p = z + (rz_new / rz) * p
        return x, r, z, p, rz_new, it + 1

    def cond(carry):
        _, r, _, _, _, it = carry
        return (jnp.linalg.norm(r) > tol * bnorm) & (it < maxiter)

    bnorm = jnp.linalg.norm(b)

    @jax.jit
    def run(state, b):
        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = Mi(r0)
        carry = (x0, r0, z0, z0, jnp.vdot(r0, z0, precision=HI),
                 jnp.asarray(0))
        x, r, *_, it = jax.lax.while_loop(cond, body, carry)
        return x, jnp.linalg.norm(r), it

    x, res, it = jax.block_until_ready(run(state, b))
    res = float(res)
    return SolveResult(np.asarray(x), int(it), res,
                       res <= tol * float(bnorm) * 1.001)


def bicgstab(coo: COOMatrix, b, *, cfg: Optional[Config] = None,
             tol: float = 1e-6, maxiter: int = 1000,
             M: Optional[Callable] = None) -> SolveResult:
    """BiCGStab (general square A), optionally right-preconditioned."""
    import jax
    import jax.numpy as jnp

    cfg, state, spmv = _setup(coo, cfg)
    b = jnp.asarray(np.asarray(b, dtype=cfg.np_dtype))
    Mi = M if M is not None else (lambda v: v)
    bnorm = jnp.linalg.norm(b)

    def body(carry):
        x, r, rhat, p, v, rho, alpha, omega, it = carry
        rho_new = jnp.vdot(rhat, r, precision=HI)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = Mi(p)
        v = spmv(state, phat)
        alpha = rho_new / jnp.vdot(rhat, v, precision=HI)
        s = r - alpha * v
        shat = Mi(s)
        t = spmv(state, shat)
        omega = (jnp.vdot(t, s, precision=HI)
                 / jnp.vdot(t, t, precision=HI))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return x, r, rhat, p, v, rho_new, alpha, omega, it + 1

    def cond(carry):
        _, r, *_, it = carry
        return (jnp.linalg.norm(r) > tol * bnorm) & (it < maxiter)

    @jax.jit
    def run(state, b):
        x0 = jnp.zeros_like(b)
        one = jnp.asarray(1.0, b.dtype)
        carry = (x0, b, b, jnp.zeros_like(b), jnp.zeros_like(b),
                 one, one, one, jnp.asarray(0))
        x, r, *_, it = jax.lax.while_loop(cond, body, carry)
        return x, jnp.linalg.norm(r), it

    x, res, it = jax.block_until_ready(run(state, b))
    res = float(res)
    return SolveResult(np.asarray(x), int(it), res,
                       res <= tol * float(bnorm) * 1.001)
