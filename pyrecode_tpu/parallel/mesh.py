"""Device mesh construction for the codec.

Mesh axes:

* ``data`` — frames, the primary scaling dimension (the reference's
  multi-process data parallelism, recode_writer.py:320-322).
* ``space`` — frame rows, for frames too large (4096^2) to want a single
  device's memory round-trip per frame; 1 by default.

On several hosts the ``data`` axis should span hosts (each host feeds its
local frames) and ``space`` should stay inside a host so its collectives
ride the cards' direct links (NVLink), not the network.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_codec_mesh(n_data: Optional[int] = None, n_space: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'space') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data * n_space != len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_space} does not match {len(devices)} devices")
    # Auto axis types: let GSPMD propagate shardings through the whole encode
    # program (explicit sharding-in-types rejects the compaction scatter)
    auto = (jax.sharding.AxisType.Auto, jax.sharding.AxisType.Auto)
    return jax.make_mesh((n_data, n_space), ("data", "space"),
                         devices=devices, axis_types=auto)


def frame_sharding(mesh: Mesh, shard_rows: bool = False) -> NamedSharding:
    """Sharding for a (B, H, W) frame batch: frames over 'data', optionally
    rows over 'space'."""
    return NamedSharding(mesh, P("data", "space" if shard_rows else None, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated (the dark/threshold frame — broadcast once)."""
    return NamedSharding(mesh, P())
