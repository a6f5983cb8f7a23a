"""L1/L3 batch encode and L1 dense decode (XLA) vs the numpy oracle.

The file and class names are those of the cases' first subject, a fused
encode kernel; the same cases now hold :func:`ops.encode_frames` and
:func:`ops.decode_l1_frames` to the oracle byte for byte.
"""

import numpy as np
import pytest

from pyrecode_tpu import oracle
from pyrecode_tpu.ops import decode_l1_frames, encode_frames


def _frames(batch=2, shape=(64, 128), density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((batch, *shape)) < density,
                    rng.integers(1, 4096, (batch, *shape)), 0).astype(np.uint16)


def _assert_l1_matches(frames, thr, res):
    bitmap, packed = np.asarray(res.bitmap), np.asarray(res.packed)
    counts, packed_len = np.asarray(res.counts), np.asarray(res.packed_len)
    for i in range(frames.shape[0]):
        enc = oracle.reduce_frame(frames[i], thr, 1, 12)
        assert bitmap[i].tobytes() == enc["packed_binary_map"], i
        assert int(counts[i]) == int((frames[i] > thr).sum()), i
        plen = int(packed_len[i])
        assert packed[i][:plen].tobytes() == enc["packed_pixvals"], i
        assert not packed[i][plen:].any(), i


class TestPallasKernel:
    @pytest.mark.parametrize("density", [0.0, 0.01, 0.05])
    def test_l1_matches_oracle(self, density):
        frames = _frames(density=density)
        thr = np.zeros(frames.shape[1:], np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=1024)
        assert not np.asarray(res.overflow).any()
        _assert_l1_matches(frames, thr, res)

    def test_nonzero_threshold(self):
        frames = _frames(density=0.1, seed=3)
        rng = np.random.default_rng(4)
        thr = rng.integers(0, 64, size=frames.shape[1:]).astype(np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=2048)
        _assert_l1_matches(frames, thr, res)

    def test_l3_bitmap_only(self):
        frames = _frames(seed=5)
        thr = np.zeros(frames.shape[1:], np.uint16)
        res = encode_frames(frames, thr, reduction_level=3, bit_depth=12,
                            max_values=1)
        assert res.packed is None
        for i in range(frames.shape[0]):
            enc = oracle.reduce_frame(frames[i], thr, 3, 12)
            assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"]
            assert int(np.asarray(res.counts)[i]) == int((frames[i] > 0).sum())

    def test_overflow_flag_fires(self):
        frames = np.full((1, 16, 128), 100, dtype=np.uint16)  # fully dense
        thr = np.zeros((16, 128), np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=1024)
        assert bool(np.asarray(res.overflow)[0])
        # a bound that holds the frame encodes it exactly
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=16 * 128)
        assert not bool(np.asarray(res.overflow)[0])
        assert int(np.asarray(res.counts)[0]) == 16 * 128
        _assert_l1_matches(frames, thr, res)

    def test_auto_escalates_and_matches(self):
        frames = _frames(density=0.5, seed=6)  # dense
        thr = np.zeros(frames.shape[1:], np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=8192)
        _assert_l1_matches(frames, thr, res)

    def test_auto_falls_back_for_unsupported_width(self):
        frames = _frames(shape=(64, 96), seed=7)  # 96 % 128 != 0
        thr = np.zeros(frames.shape[1:], np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=2048)
        _assert_l1_matches(frames, thr, res)

    def test_multi_chunk_offsets(self):
        """Counts crossing many 128-alignment boundaries stay consistent."""
        frames = _frames(batch=1, shape=(128, 128), density=0.3, seed=8)
        thr = np.zeros((128, 128), np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=8192)
        assert not np.asarray(res.overflow).any()
        _assert_l1_matches(frames, thr, res)


class TestPallasDecode:
    @pytest.mark.parametrize("density", [0.0, 0.02, 0.1])
    def test_roundtrip(self, density):
        frames = _frames(batch=2, shape=(64, 128), density=density, seed=11)
        rng = np.random.default_rng(12)
        thr = rng.integers(0, 32, size=frames.shape[1:]).astype(np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=2048)
        dense = decode_l1_frames(res.bitmap, res.packed, 64, 128, 12)
        expected = np.where(frames > thr,
                            frames.astype(np.int32) - thr, 0).astype(np.uint16)
        assert np.array_equal(np.asarray(dense), expected)

    def test_dense_bucket_escalation(self):
        frames = _frames(batch=1, shape=(16, 128), density=0.6, seed=13)
        thr = np.zeros(frames.shape[1:], np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=4096)
        assert not np.asarray(res.overflow).any()
        dense = decode_l1_frames(res.bitmap, res.packed, 16, 128, 12)
        assert np.array_equal(np.asarray(dense), frames)


class TestStackedEncode:
    """One batch call equals encoding each frame on its own."""

    def test_matches_per_frame_encode(self):
        rng = np.random.default_rng(31)
        B, H, W = 6, 64, 256
        frames = np.where(rng.random((B, H, W)) < 0.03,
                          rng.integers(1, 4096, (B, H, W)), 0).astype(np.uint16)
        thr = rng.integers(0, 8, (H, W)).astype(np.uint16)
        batch = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                              max_values=2048)
        _assert_l1_matches(frames, thr, batch)
        for i in range(B):
            one = encode_frames(frames[i:i + 1], thr, reduction_level=1,
                                bit_depth=12, max_values=2048)
            assert np.array_equal(np.asarray(one.bitmap)[0],
                                  np.asarray(batch.bitmap)[i]), i
            assert np.array_equal(np.asarray(one.packed)[0],
                                  np.asarray(batch.packed)[i]), i

    def test_empty_and_full_frames(self):
        frames = np.zeros((3, 16, 128), np.uint16)
        frames[1] = 100  # every pixel foreground
        thr = np.zeros((16, 128), np.uint16)
        res = encode_frames(frames, thr, reduction_level=1, bit_depth=12,
                            max_values=2048)
        assert not bool(np.asarray(res.overflow).any())
        counts = np.asarray(res.counts)
        assert counts[0] == 0 and counts[2] == 0 and counts[1] == 16 * 128
        _assert_l1_matches(frames, thr, res)
