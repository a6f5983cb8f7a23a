"""Mesh/sharded-encode tests on the virtual 8-device CPU mesh."""

from pathlib import Path

import numpy as np
import pytest

from pyrecode_tpu import oracle
from pyrecode_tpu.parallel import make_codec_mesh, encode_frames_sharded
from pyrecode_tpu.parallel.multihost import (
    gather_ordered_blocks, make_encode_step, replicate_threshold)

REPO = str(Path(__file__).resolve().parent.parent)


def _frames(batch, shape=(32, 256), density=0.03, seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((batch, *shape)) < density,
                    rng.integers(1, 4096, (batch, *shape)), 0).astype(np.uint16)


def test_xla_sharded_encode_matches_oracle():
    mesh = make_codec_mesh(4, 2)
    frames = _frames(8)
    thr = np.zeros(frames.shape[1:], np.uint16)
    res = encode_frames_sharded(frames, thr, mesh, reduction_level=1,
                                bit_depth=12, max_values=2048, shard_rows=True)
    for i in (0, 5, 7):
        enc = oracle.reduce_frame(frames[i], thr, 1, 12)
        assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"]
        plen = int(np.asarray(res.packed_len)[i])
        assert np.asarray(res.packed)[i][:plen].tobytes() == enc["packed_pixvals"]


def test_shard_map_pallas_encode_and_gather():
    mesh = make_codec_mesh(8, 1)
    frames = _frames(16, seed=2)
    thr = replicate_threshold(np.zeros(frames.shape[1:], np.uint16), mesh)
    step = make_encode_step(mesh, max_values=1024, bit_depth=12)
    bitmap, packed, counts, ovf = step(frames, thr)
    assert not np.asarray(ovf).any()
    assert "data" in str(bitmap.sharding.spec)
    # every device encoded its own shard
    assert len({s.device for s in bitmap.addressable_shards}) == 8

    blocks = gather_ordered_blocks(bitmap, packed, counts, bit_depth=12)
    assert len(blocks) == 16
    for i in (0, 7, 15):  # across shard boundaries: order preserved
        enc = oracle.reduce_frame(frames[i], np.zeros(frames.shape[1:], np.uint16), 1, 12)
        assert blocks[i][0] == enc["packed_binary_map"], i
        assert blocks[i][1] == enc["packed_pixvals"], i


@pytest.mark.slow
def test_dryrun_multichip_16():
    """The full multi-device dry run compiles and executes on a
    16-virtual-device mesh."""
    import subprocess
    import sys as _sys

    proc = subprocess.run(
        [_sys.executable, "-c",
         "import sys; sys.path.insert(0, '.');"
         "import jax; jax.config.update('jax_platforms', 'cpu');"
         "import __graft_entry__ as g; g.dryrun_multichip(16);"
         "print('DRYRUN16 OK')"],
        capture_output=True, text=True, timeout=1200,
        env={**__import__('os').environ,
             'XLA_FLAGS': '--xla_force_host_platform_device_count=16',
             'JAX_PLATFORMS': 'cpu'},
        cwd=REPO)
    assert 'DRYRUN16 OK' in proc.stdout, proc.stderr[-2000:]
