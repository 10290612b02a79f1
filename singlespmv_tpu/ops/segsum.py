"""Segment-reduction engines (XLA level).

The reference's atomic-scatter COO kernel (src/opt_coo.cpp:34-45) and its
segmented-scan SS kernels (src/opt_ss.cpp:188-349) both
become *sort-order* segment reductions:

- ``segment_sum_sorted``: XLA scatter-add over row-sorted products (the COO path).
  On the GPU XLA lowers it to atomic adds, so repeated calls may differ in the
  last bits.
- ``segmented_scan_inclusive``: segmented inclusive prefix-sum along the last axis via
  ``lax.associative_scan`` — the "SIMPLE" SS variant; XLA compiles it into log₂(W)
  shifted-add steps, the direct analog of the reference's log-tree
  (/root/reference/src/opt_ss.cpp:121-147,242-260).

Precision note: these never accumulate across row boundaries (no global prefix-sum
differencing), preserving the reference's per-row error characteristics.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sum_sorted(products: jax.Array, rows: jax.Array, n_row: int) -> jax.Array:
    """y[r] = Σ products[i where rows[i]==r]; rows sorted non-decreasing.

    Padding discipline: pad elements carry val=0 and any in-range row id.
    """
    return jax.ops.segment_sum(
        products, rows, num_segments=n_row,
        indices_are_sorted=True, unique_indices=False,
    )


def _segop(a, b):
    """Associative combine for (value, boundary-flag) segmented +-scan pairs."""
    va, fa = a
    vb, fb = b
    return jnp.where(fb, vb, va + vb), fa | fb


def segmented_scan_inclusive(values: jax.Array, heads: jax.Array) -> jax.Array:
    """Inclusive segmented sum-scan along the last axis.

    ``heads`` is True at the first element of each segment run.  Works on any leading
    batch shape; the scan is independent per leading index (cross-batch carries are
    the caller's job — see the (H, R_max) partial/combine scheme in formats.ss).
    """
    scanned, _ = jax.lax.associative_scan(_segop, (values, heads), axis=-1)
    return scanned


def extract_run_partials(scanned: jax.Array, end_pos: jax.Array) -> jax.Array:
    """Gather per-run inclusive totals at each run's last position.

    scanned: (H, W) segment-scanned products. end_pos: (H, R) int32 positions of each
    run's final element within its stream row (padded slots point anywhere; the
    combine masks them via ghost row ids).
    """
    return jnp.take_along_axis(scanned, end_pos, axis=-1)


def combine_partials(partials: jax.Array, partial_rows: jax.Array, n_row: int) -> jax.Array:
    """Scatter-add (H, R) run partials into y by global row id.

    partial_rows uses ``n_row`` as the ghost id for padded slots; we reduce into
    n_row+1 bins and drop the ghost.  NOTE: ghost ids interleave between segments'
    real rows, so the flat id sequence is NOT sorted — do not claim sortedness to XLA.
    """
    y = jax.ops.segment_sum(
        partials.reshape(-1), partial_rows.reshape(-1),
        num_segments=n_row + 1, indices_are_sorted=False,
    )
    return y[:n_row]
