"""Sharded encode: the codec's pjit "training step".

One compiled program encodes a frame batch sharded over the mesh:

* inputs: frames (B, H, W) sharded ``P('data', ['space'], None)``; the
  threshold (dark + epsilon) replicated;
* outputs: bitmaps / packed streams / counts sharded over ``data`` — each
  device produces the packed bytes for its own frames (the analogue of each
  reference node writing its own part file, recode_server.py:350-363);
* the host then gathers the variable-length blocks in frame order for
  container assembly (merge_parts semantics), or each host writes its local
  shard as an intermediate part file.

Everything inside is batch-parallel per frame, so with pure data sharding
XLA inserts no cross-device collectives; with ``space`` row-sharding the
per-frame flat cumsum in the compaction stage lowers to a segmented scan +
cross-shard prefix exchange which GSPMD derives automatically — lay out the
mesh so 'space' stays inside one host.
"""

from __future__ import annotations


import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.encode import EncodeResult, encode_frames
from .mesh import frame_sharding, replicated_sharding


def make_sharded_encode_step(mesh: Mesh, reduction_level: int, bit_depth: int,
                             max_values: int, l2_statistic: str = "max",
                             l4_scheme: str = "weighted_average",
                             shard_rows: bool = False):
    """Build a jitted encode step with shardings bound to ``mesh``.

    Returns ``step(frames, threshold) -> EncodeResult`` whose outputs are
    sharded over the 'data' axis (bitmap/packed/counts per frame).
    """
    in_shardings = (frame_sharding(mesh, shard_rows), replicated_sharding(mesh))
    data_vec = NamedSharding(mesh, P("data"))
    data_mat = NamedSharding(mesh, P("data", None))
    packed_out = None if reduction_level in (3, 4) else data_mat
    out_shardings = EncodeResult(
        bitmap=data_mat,
        packed=packed_out,
        counts=data_vec,
        packed_len=packed_out if packed_out is None else data_vec,
        overflow=data_vec,
    )

    def _encode(frames, threshold):
        return encode_frames(
            frames, threshold, reduction_level=reduction_level,
            bit_depth=bit_depth, max_values=max_values,
            l2_statistic=l2_statistic, l4_scheme=l4_scheme)

    return jax.jit(_encode, in_shardings=in_shardings, out_shardings=out_shardings)


def encode_frames_sharded(frames, threshold, mesh: Mesh, reduction_level: int,
                          bit_depth: int, max_values: int,
                          l2_statistic: str = "max",
                          l4_scheme: str = "weighted_average",
                          shard_rows: bool = False) -> EncodeResult:
    """One-shot sharded encode (convenience wrapper over the step factory)."""
    step = make_sharded_encode_step(
        mesh, reduction_level, bit_depth, max_values,
        l2_statistic=l2_statistic, l4_scheme=l4_scheme, shard_rows=shard_rows)
    frames = jax.device_put(frames, frame_sharding(mesh, shard_rows))
    threshold = jax.device_put(threshold, replicated_sharding(mesh))
    return step(frames, threshold)
