"""Batched decode kernels: packed streams -> dense frames.

Device replacement for the C decode hot loop ``_unpack_frame_sparse``
(c_extensions/reader.h:10-68).  Where the reference walks the bitmap bit by
bit, the batched kernel is gather-based and fully vectorized:

    mask  = unpack_bits(bitmap)                     (B, H*W)
    rank  = cumsum(mask) - 1                        position among fg pixels
    vals  = bitunpack_values(packed, b)             (B, max_vals)
    dense = vals[rank] * mask                       one gather

Sparse COO extraction (row/col index lists) is a host-side epilogue on the
mask (numpy flatnonzero); the dense form is what device consumers want.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .bitpack import bitunpack_values, unpack_bits


@partial(jax.jit, static_argnames=("height", "width", "bit_depth", "out_dtype"))
def decode_l1_frames(bitmap: jax.Array, packed: jax.Array, height: int, width: int,
                     bit_depth: int, out_dtype=jnp.uint16) -> jax.Array:
    """Decode L1 frames to dense (B, H, W) residual images.

    Parameters
    ----------
    bitmap : (B, ceil(H*W/8)) uint8 bit-packed binary maps
    packed : (B, m) uint8 packed intensity streams, zero-padded; ``m*8`` must
        be >= max foreground count * bit_depth and a multiple of the byte
        group size (the writer's buffers satisfy this by construction)
    """
    B = bitmap.shape[0]
    n = height * width
    mask = unpack_bits(bitmap)[:, :n].astype(jnp.int32)
    rank = jnp.cumsum(mask, axis=-1) - 1
    vals = bitunpack_values(packed, bit_depth, out_dtype=jnp.uint32)
    max_vals = vals.shape[-1]
    gathered = jnp.take_along_axis(vals, jnp.clip(rank, 0, max_vals - 1), axis=-1)
    dense = (gathered * mask.astype(jnp.uint32)).astype(out_dtype)
    return dense.reshape(B, height, width)


@partial(jax.jit, static_argnames=("height", "width", "out_dtype"))
def decode_bitmap_frames(bitmap: jax.Array, height: int, width: int,
                         out_dtype=jnp.uint16) -> jax.Array:
    """Decode L2/L3/L4 bitmaps to dense 0/1 frames (value 1 per set bit,
    matching reader.h:39-41)."""
    B = bitmap.shape[0]
    n = height * width
    mask = unpack_bits(bitmap)[:, :n].astype(out_dtype)
    return mask.reshape(B, height, width)
