"""Fused batched encode pipeline: threshold -> reduce -> pack, one jit.

Device replacement for the reference's per-frame Python encode loop
``ReCoDeWriter._reduce_compress`` (recode_writer.py:430-557).  A whole batch
of frames is processed in one compiled program:

    mask      = frames > threshold                  (all levels)
    L1        residuals -> compact -> bit-pack
    L2        CC-label -> per-puddle stats -> bit-pack
    L3        (bitmap only)
    L4        CC-label -> centroids -> centroid bitmap
    bitmap    bit-pack of the (possibly centroided) mask

Variable-length streams use max-bound buffers plus true counts; the host
writer slices ``packed[:, :packed_len[i]]`` when assembling the container.
The entropy stage stays on host (see codecs/backends.py docstring).

All outputs are bit-identical to the CPU oracle (oracle.py), which in turn
matches the reference wire format.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .bitpack import bitpack_values, pack_bits, packed_group_shape
from .cc_label import label_components
from .compact import stream_compact
from .segment import centroid_pixels_to_mask, l2_summary_stats, l4_centroid_pixels


@jax.tree_util.register_dataclass
@dataclass
class EncodeResult:
    """Device arrays produced by one encode batch.

    bitmap : (B, ceil(H*W/8)) uint8 — bit-packed binary map
    packed : (B, max_packed_bytes) uint8 or None — packed value stream
        (L1 residuals / L2 summary stats), zero-padded beyond packed_len
    counts : (B,) int32 — foreground pixels (L1/L3) or puddles (L2/L4)
    packed_len : (B,) int32 or None — valid bytes of ``packed`` per frame
    overflow : (B,) bool — true count exceeded the static buffer bound
        (the frame must be retried with a larger bound)
    """

    bitmap: jax.Array
    packed: Optional[jax.Array]
    counts: jax.Array
    packed_len: Optional[jax.Array]
    overflow: jax.Array


def _pad_to_group(n: int, bit_depth: int) -> int:
    g_vals, _ = packed_group_shape(bit_depth)
    return -(-n // g_vals) * g_vals


def _pack_mask_batch(mask: jax.Array) -> jax.Array:
    """(B, H, W) bool -> (B, ceil(H*W/8)) uint8, zero-padding the bit tail."""
    B, H, W = mask.shape
    n = H * W
    flat = mask.reshape(B, n)
    if n % 8:
        flat = jnp.pad(flat, ((0, 0), (0, 8 - n % 8)))
    return pack_bits(flat)


@partial(jax.jit, static_argnames=("reduction_level", "bit_depth", "max_values",
                                   "l2_statistic", "l4_scheme"))
def encode_frames(frames: jax.Array, threshold: jax.Array, reduction_level: int,
                  bit_depth: int, max_values: int, l2_statistic: str = "max",
                  l4_scheme: str = "weighted_average") -> EncodeResult:
    """Encode a batch of frames at the given reduction level.

    Parameters
    ----------
    frames : (B, H, W) unsigned source frames
    threshold : (H, W) per-pixel threshold = dark + epsilon, same dtype
        (replicated across the batch — on a mesh it is broadcast once)
    reduction_level : 1..4 (static)
    bit_depth : source bit depth for value packing (static)
    max_values : static bound on values per frame (foreground pixels for L1,
        puddles for L2/L4); rounded up internally to the pack group size
    """
    B, H, W = frames.shape
    mask = frames > threshold[None]

    if reduction_level == 1:
        # residuals only where foreground; uint arithmetic wraps elsewhere but
        # the masked multiply zeroes those lanes (recode_writer.py:440)
        residual = ((frames - threshold[None]) * mask.astype(frames.dtype))
        n_pad = _pad_to_group(max_values, bit_depth)
        compacted, counts = stream_compact(
            residual.reshape(B, -1), mask.reshape(B, -1), n_pad)
        packed = bitpack_values(compacted, bit_depth)
        packed_len = (counts * bit_depth + 7) // 8
        return EncodeResult(
            bitmap=_pack_mask_batch(mask),
            packed=packed,
            counts=counts,
            packed_len=packed_len,
            overflow=counts > n_pad,
        )

    if reduction_level == 2:
        labels, counts = label_components(mask)
        stats = l2_summary_stats(labels, frames, max_puddles=_pad_to_group(max_values, bit_depth),
                                 statistic=l2_statistic, bit_depth=bit_depth)
        packed = bitpack_values(stats, bit_depth)
        packed_len = (counts * bit_depth + 7) // 8
        return EncodeResult(
            bitmap=_pack_mask_batch(mask),
            packed=packed,
            counts=counts,
            packed_len=packed_len,
            overflow=counts > stats.shape[-1],
        )

    if reduction_level == 3:
        counts = jnp.sum(mask.reshape(B, -1), axis=-1).astype(jnp.int32)
        return EncodeResult(
            bitmap=_pack_mask_batch(mask),
            packed=None,
            counts=counts,
            packed_len=None,
            overflow=jnp.zeros((B,), dtype=jnp.bool_),
        )

    if reduction_level == 4:
        labels, counts = label_components(mask)
        pixels = l4_centroid_pixels(labels, frames, max_puddles=max_values, scheme=l4_scheme)
        cmask = centroid_pixels_to_mask(pixels, counts, H, W)
        return EncodeResult(
            bitmap=_pack_mask_batch(cmask),
            packed=None,
            counts=counts,
            packed_len=None,
            overflow=counts > max_values,
        )

    raise ValueError(f"Unknown reduction level: {reduction_level}")


@partial(jax.jit, static_argnames=())
def count_foreground(frames: jax.Array, threshold: jax.Array) -> jax.Array:
    """Cheap first pass: per-frame foreground pixel counts.

    Used by the writer to pick a tight ``max_values`` bucket before running
    the full encode, keeping device->host transfers proportional to the
    actual data instead of the worst case.
    """
    mask = frames > threshold[None]
    return jnp.sum(mask.reshape(frames.shape[0], -1), axis=-1).astype(jnp.int32)
