"""Multi-device / multi-host encode: per-device encode + ordered gather.

Two pieces (SURVEY.md §2.3 "ordered gather / all-to-one"):

* :func:`make_encode_step` — the fused L1 encode (:func:`ops.encode_frames`)
  wrapped in ``jax.shard_map`` over the mesh's ``data`` axis: every device
  encodes its local frame shard (the encode is embarrassingly parallel over
  frames, so no collective runs inside the step).  The threshold is
  broadcast once.
* :func:`gather_ordered_blocks` — collect the per-frame variable-length
  streams in acquisition order for container assembly.  Frames are sharded
  contiguously over ``data`` (shard d owns frames [d*B/D, (d+1)*B/D)) —
  exactly the reference's per-node slicing (recode_writer.py:320-322) — so
  gathering shards in axis order preserves acquisition order and the
  assembled container is identical to single-device output.

On several hosts, ``jax.experimental.multihost_utils.process_allgather``
brings every shard to every host and process 0 writes the container; on a
single host the addressable shards are read directly.  Either way only the
*compressible* streams move (bitmap + packed values, not raw frames), so the
gather rides the reduction ratio.
"""

from __future__ import annotations


from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_encode_step(mesh: Mesh, max_values: int, bit_depth: int = 12):
    """Build a shard_map'd L1 encode step over the 'data' mesh axis.

    Returns ``step(frames, threshold) -> (bitmap, packed, counts, overflow)``
    with outputs sharded over 'data'.  ``frames.shape[0]`` must divide evenly
    over the data axis; ``max_values`` bounds the foreground pixels of any
    one frame (``overflow`` flags frames above it).
    """
    from ..ops.encode import encode_frames

    def _local(frames, threshold):
        res = encode_frames(frames, threshold, reduction_level=1,
                            bit_depth=bit_depth, max_values=max_values)
        return res.bitmap, res.packed, res.counts, res.overflow

    shard = P("data")
    mapped = jax.shard_map(
        _local, mesh=mesh,
        in_specs=(P("data", None, None), P()),
        out_specs=(shard, shard, shard, shard),
    )
    return jax.jit(mapped)


def gather_ordered_blocks(bitmap, packed, counts, bit_depth: int,
                          process_index: Optional[int] = None):
    """Collect per-frame (bitmap_bytes, packed_bytes) in frame order.

    Works on sharded arrays from :func:`make_encode_step`.  On a
    multi-process runtime the shards are allgathered and only the writer
    process (default 0) returns the blocks; other processes return None.
    """
    if jax.process_count() > 1:
        # exercised by tests/test_multihost.py on a 2-process CPU runtime
        from jax.experimental import multihost_utils

        bitmap = multihost_utils.process_allgather(bitmap, tiled=True)
        packed = multihost_utils.process_allgather(packed, tiled=True)
        counts = multihost_utils.process_allgather(counts, tiled=True)
        if process_index is None:
            process_index = 0
        if jax.process_index() != process_index:
            return None

    bitmap = np.asarray(bitmap)
    packed = np.asarray(packed)
    counts = np.asarray(counts)
    blocks = []
    for i in range(bitmap.shape[0]):
        plen = (int(counts[i]) * bit_depth + 7) // 8
        blocks.append((bitmap[i].tobytes(), packed[i][:plen].tobytes()))
    return blocks


def replicate_threshold(threshold, mesh: Mesh):
    """Place the dark/calibration threshold replicated on every device."""
    return jax.device_put(threshold, NamedSharding(mesh, P()))
