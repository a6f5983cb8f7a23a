"""Multi-device parallelism: device meshes and sharded encode.

The reference scales by forking N host processes that each encode a
contiguous frame slice and write their own part file, coordinated over ZMQ
(recode_server.py:350-363; SURVEY.md §2.3).  Here that data parallelism
moves onto the device mesh:

* frames are sharded over the ``data`` mesh axis (the analogue of the
  reference's ``num_threads`` processes);
* very large frames can additionally shard rows over a ``space`` axis
  (sequence-parallel analogue) — thresholding and bitmap packing are
  row-local, and XLA inserts the collectives the global compaction needs;
* the dark/calibration threshold is replicated (broadcast once);
* variable-length compressed blocks are gathered to the writer host in
  acquisition order, reproducing ``merge_parts`` semantics.

TP/PP/EP have no analogue here — the reference is a codec with no weight
tensors to shard (SURVEY.md §2.3 marks them N/A by design).
"""

from .mesh import make_codec_mesh, frame_sharding, replicated_sharding
from .shard_encode import encode_frames_sharded, make_sharded_encode_step

__all__ = [
    "make_codec_mesh",
    "frame_sharding",
    "replicated_sharding",
    "encode_frames_sharded",
    "make_sharded_encode_step",
]
