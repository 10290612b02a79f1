"""Primitive microbenchmarks — plain-JAX probes of the attached device.

The reference keeps scratch probes under /root/reference/test/ (alignment.cpp,
simd_shift.cpp, mask_load.cpp ...) that validated the SIMD assumptions its
kernels rely on (SURVEY §2.5).  These probes time the data motions the XLA-level
formats are built from: a streamed read, a large copy, a random gather
``x[col]``, a sorted segment-sum and a float32 matrix product.  Each returns
``(work, seconds)``: elements (or flops for the matrix product) and the median
seconds of one call, timed to ``jax.block_until_ready``.  ``harness.calibrate``
turns them into the planner's constants.

Run: ``python -m singlespmv_tpu.harness.microbench [--out micro.tsv] [probe ...]``
"""
from __future__ import annotations

import sys

import numpy as np

from ..core.timing import now


def time_call(fn, *args, reps: int = 5) -> float:
    """Median seconds of one ``jit(fn)(*args)`` call after a warm-up call."""
    import jax

    fj = jax.jit(fn)
    jax.block_until_ready(fj(*args))
    times = []
    for _ in range(reps):
        t0 = now()
        jax.block_until_ready(fj(*args))
        times.append(now() - t0)
    return float(np.median(times))


def _uniform(n, seed=0, dtype=np.float32):
    import jax

    return jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype,
                              minval=-1.0, maxval=1.0)


def probe_hbm_read(n=1 << 25):
    """Streamed read: sum of n float32 (4·n bytes)."""
    import jax.numpy as jnp

    return n, time_call(jnp.sum, _uniform(n))


def probe_copy(n=1 << 25):
    """Large copy: out = a + 1 over n float32 (8·n bytes moved)."""
    return n, time_call(lambda a: a + 1.0, _uniform(n))


def probe_gather(n=1 << 25, table=None):
    """Random gather x[col]: n int32 indices into a ``table``-long float32 x."""
    import jax

    m = table or n
    x = _uniform(m)
    col = jax.random.randint(jax.random.PRNGKey(1), (n,), 0, m, dtype="int32")
    return n, time_call(lambda x, c: x[c], x, col)


def probe_scatter(n=1 << 25, per_segment=8):
    """Sorted scatter-add: segment_sum of n values into n/per_segment rows."""
    import jax
    import jax.numpy as jnp

    segs = max(n // per_segment, 1)
    ids = jnp.arange(n, dtype=jnp.int32) // per_segment

    def f(v, s):
        return jax.ops.segment_sum(v, s, num_segments=segs,
                                   indices_are_sorted=True)

    return n, time_call(f, _uniform(n), ids)


def probe_matmul(k=4096):
    """float32 (k, k) @ (k, k) at Precision.HIGHEST: 2·k³ flops."""
    import jax
    import jax.numpy as jnp

    a = _uniform(k * k).reshape(k, k)
    b = _uniform(k * k, seed=2).reshape(k, k)

    def f(a, b):
        return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)

    return 2 * k ** 3, time_call(f, a, b)


PROBES = {
    "hbm_read_f32": probe_hbm_read,
    "copy_f32": probe_copy,
    "gather_f32": probe_gather,
    "scatter_sorted_f32": probe_scatter,
    "matmul_f32_highest": probe_matmul,
}


def run(names=None, out=None, log=lambda m: print(m, file=sys.stderr)):
    rows = []
    for name, fn in PROBES.items():
        if names and name not in names:
            continue
        work, sec = fn()
        rate = work / sec / 1e9
        rows.append((name, work, sec, rate))
        log(f"{name:24s} {rate:10.2f} G/s   ({sec * 1e6:9.1f} us)")
    if out:
        with open(out, "w") as f:
            f.write("probe\twork\tseconds\tG_per_s\n")
            for r in rows:
                f.write(f"{r[0]}\t{r[1]}\t{r[2]:.3e}\t{r[3]:.3f}\n")
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("probes", nargs="*", default=None)
    a = ap.parse_args()
    run(a.probes or None, a.out)
