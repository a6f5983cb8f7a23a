"""Device compute kernels (JAX, compiled by XLA for the accelerator in use).

This package replaces the reference's hot paths:

* numba kernels ``_pack_binary_frame`` / ``_bit_pack`` (recode_writer.py:622-652)
  -> :mod:`bitpack` (vectorized, batched over frames)
* C decode loop ``_unpack_frame_sparse`` (c_extensions/reader.h:10-68)
  -> :mod:`decode` (gather-based, batched)
* ``scipy.ndimage.label`` + centroid/summary numba kernels
  (recode_writer.py:443-449, converters.py:157-309)
  -> :mod:`cc_label` + :mod:`segment` (iterative min-propagation + segment ops)
* the per-frame Python encode loop (recode_writer.py:430-557)
  -> :mod:`encode` (single fused jitted batch pipeline)

Design rules: static shapes everywhere — variable-length outputs are handled
with max-bound buffers plus per-frame counts; no data-dependent Python
control flow under jit; elementwise work fuses into the surrounding ops.
"""

from .bitpack import (
    pack_bits,
    unpack_bits,
    bitpack_values,
    bitunpack_values,
    packed_group_shape,
)
from .compact import stream_compact
from .cc_label import label_components
from .segment import l2_summary_stats, l4_centroids, centroids_to_mask
from .encode import encode_frames, count_foreground, EncodeResult
from .decode import decode_l1_frames, decode_bitmap_frames

__all__ = [
    "pack_bits",
    "unpack_bits",
    "bitpack_values",
    "bitunpack_values",
    "packed_group_shape",
    "stream_compact",
    "label_components",
    "l2_summary_stats",
    "l4_centroids",
    "centroids_to_mask",
    "encode_frames",
    "count_foreground",
    "EncodeResult",
    "decode_l1_frames",
    "decode_bitmap_frames",
]
