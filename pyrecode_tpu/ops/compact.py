"""Stream compaction: gather masked elements to a dense prefix.

This is the crux of variable-length encoding inside fixed-shape XLA (see
SURVEY.md §7 "hard parts"): the L1 residual stream is the row-major sequence
of foreground pixel values, whose length is data-dependent.  The compaction
keeps shapes static by writing into a max-bound buffer and returning the true
count separately.

Positions come from an inclusive cumsum of the mask; one 1-D scatter per row
with out-of-bounds drop then writes the foreground values.  O(N), jittable
and batched.

Elements beyond the true count are zero, which downstream bit-packing relies
on (the reference zero-initializes its pack buffers, reader.h:117-120).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("out_size",))
def stream_compact(values: jax.Array, mask: jax.Array, out_size: int):
    """Compact ``values[mask]`` (row-major order) into a zero-padded buffer.

    Parameters
    ----------
    values : (..., n) array
    mask : (..., n) boolean
    out_size : static output length (true count may not exceed it; overflowing
        elements are dropped and the returned count still reports the real
        total so callers can detect overflow)

    Returns
    -------
    compacted : (..., out_size) array, zero beyond the count
    count : (...,) int32 — number of True elements in the mask
    """
    mask = mask.astype(jnp.bool_)
    count = jnp.sum(mask, axis=-1).astype(jnp.int32)
    pos = jnp.cumsum(mask, axis=-1, dtype=jnp.int32) - 1
    # out-of-range index drops the element (background and overflow alike)
    idx = jnp.where(mask, pos, out_size)

    def _scatter_1d(vals, indices):
        out = jnp.zeros((out_size,), dtype=vals.dtype)
        return out.at[indices].set(vals, mode="drop", unique_indices=True)

    flat_vals = values.reshape(-1, values.shape[-1])
    flat_idx = idx.reshape(-1, idx.shape[-1])
    out = jax.vmap(_scatter_1d)(flat_vals, flat_idx)
    return out.reshape(*values.shape[:-1], out_size), count
