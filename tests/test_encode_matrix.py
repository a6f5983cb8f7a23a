"""``encode_frames`` vs the oracle at levels 1 and 2, across frame
geometries that are odd, not multiples of 128 or of 8 pixels, and across
bit depths 8, 12 and 16 (levels 3 and 4: test_encode_matrix_l34.py)."""

import numpy as np
import pytest

from pyrecode_tpu import oracle
from pyrecode_tpu.ops import encode_frames

GEOMETRIES = [(37, 53), (64, 96), (5, 130)]
BIT_DEPTHS = [8, 12, 16]


def check_level(level, geometry, bit_depth):
    """Encode a small batch at ``level`` and compare every frame's streams
    with ``oracle.reduce_frame`` byte for byte."""
    rng = np.random.default_rng(level * 100 + bit_depth + geometry[1])
    h, w = geometry
    top = (1 << bit_depth) - 1
    # 8-bit sources are uint8: byte-aligned depths store values in the
    # source dtype (oracle.reduce_frame)
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    frames = np.where(rng.random((3, h, w)) < 0.08,
                      rng.integers(1, top + 1, (3, h, w)), 0).astype(dtype)
    frames[1, h // 2, : w // 3] = top       # a long line puddle at full scale
    thr = rng.integers(0, 4, (h, w)).astype(dtype)
    res = encode_frames(frames, thr, reduction_level=level, bit_depth=bit_depth,
                        max_values=h * w, l2_statistic="sum")
    assert not np.asarray(res.overflow).any()
    for i in range(frames.shape[0]):
        enc = oracle.reduce_frame(frames[i], thr, level, bit_depth, l2_statistic="sum")
        assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"], i
        if res.packed is not None:
            plen = int(np.asarray(res.packed_len)[i])
            assert np.asarray(res.packed)[i][:plen].tobytes() == enc["packed_pixvals"], i


@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("level", [1, 2])
def test_encode_levels_1_2_match_oracle(level, geometry, bit_depth):
    check_level(level, geometry, bit_depth)
