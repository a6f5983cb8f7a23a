"""Device ops vs CPU oracle: every kernel must match the oracle byte-for-byte."""

import numpy as np
import pytest

from pyrecode_tpu import oracle
from pyrecode_tpu import ops


def _sparse_frames(batch=3, shape=(64, 64), seed=0, density_offset=3500):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 4096, size=(batch, *shape)).astype(np.int64) - density_offset
    frames[frames < 0] = 0
    return frames.astype(np.uint16)


class TestBitpackOps:
    @pytest.mark.parametrize("bit_depth", [4, 8, 11, 12, 16])
    def test_values_match_oracle(self, bit_depth):
        rng = np.random.default_rng(0)
        g_vals, _ = ops.packed_group_shape(bit_depth)
        n = 24 * g_vals
        vals = rng.integers(0, 1 << bit_depth, size=(2, n), dtype=np.uint16)
        packed = np.asarray(ops.bitpack_values(vals, bit_depth))
        for i in range(2):
            expected = oracle.bit_pack(vals[i], bit_depth)
            assert np.array_equal(packed[i][: expected.size], expected)

    @pytest.mark.parametrize("bit_depth", [4, 11, 12, 16])
    def test_roundtrip(self, bit_depth):
        rng = np.random.default_rng(1)
        g_vals, _ = ops.packed_group_shape(bit_depth)
        n = 16 * g_vals
        vals = rng.integers(0, 1 << bit_depth, size=(3, n), dtype=np.uint16)
        packed = ops.bitpack_values(vals, bit_depth)
        out = np.asarray(ops.bitunpack_values(packed, bit_depth))
        assert np.array_equal(out, vals)

    def test_pack_bits_matches_oracle(self):
        rng = np.random.default_rng(2)
        bits = (rng.random((4, 128)) > 0.7).astype(np.uint8)
        packed = np.asarray(ops.pack_bits(bits))
        for i in range(4):
            assert np.array_equal(packed[i], oracle.pack_binary_frame(bits[i]))

    def test_unpack_bits_roundtrip(self):
        rng = np.random.default_rng(3)
        bits = (rng.random((2, 256)) > 0.5).astype(np.uint8)
        assert np.array_equal(np.asarray(ops.unpack_bits(ops.pack_bits(bits))), bits)


class TestCompact:
    @pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
    def test_matches_numpy(self, dtype):
        rng = np.random.default_rng(4)
        vals = rng.integers(0, 4096, size=(3, 500)).astype(dtype)
        mask = rng.random((3, 500)) > 0.8
        out, counts = ops.stream_compact(vals, mask, out_size=200)
        assert out.dtype == dtype
        out, counts = np.asarray(out), np.asarray(counts)
        for i in range(3):
            expected = vals[i][mask[i]]
            assert counts[i] == expected.size
            assert np.array_equal(out[i][: expected.size], expected)
            assert not out[i][expected.size:].any()

    @pytest.mark.parametrize("batch_shape", [(1,), (2, 3)])
    def test_overflow_drops_tail(self, batch_shape):
        vals = np.broadcast_to(np.arange(1, 101, dtype=np.uint16), (*batch_shape, 100))
        mask = np.ones((*batch_shape, 100), dtype=bool)
        out, counts = ops.stream_compact(vals, mask, out_size=10)
        assert counts.shape == batch_shape
        assert (np.asarray(counts) == 100).all()  # true count still reported
        assert np.array_equal(np.asarray(out),
                              np.broadcast_to(np.arange(1, 11, dtype=np.uint16), (*batch_shape, 10)))


class TestCCLabel:
    def test_matches_scipy_on_random(self):
        rng = np.random.default_rng(5)
        mask = rng.random((4, 48, 48)) > 0.85
        labels, counts = ops.label_components(mask)
        labels, counts = np.asarray(labels), np.asarray(counts)
        for i in range(4):
            ref_labels, ref_num = oracle.label_components(mask[i])
            assert counts[i] == ref_num
            assert np.array_equal(labels[i], ref_labels)

    def test_snake_component(self):
        # a long snake exercises many propagation iterations
        mask = np.zeros((1, 16, 16), dtype=bool)
        r = 0
        for c in range(16):
            mask[0, :, c] = False
        # serpentine path
        path = []
        for c in range(16):
            rows = range(16) if c % 2 == 0 else range(15, -1, -1)
            path.extend((rr, c) for rr in rows)
        for rr, cc in path:
            mask[0, rr, cc] = (rr + cc) % 1 == 0  # all True -> single component
        labels, counts = ops.label_components(mask)
        assert int(counts[0]) == 1
        assert np.asarray(labels)[0][mask[0]].max() == 1

    def test_empty(self):
        mask = np.zeros((2, 8, 8), dtype=bool)
        labels, counts = ops.label_components(mask)
        assert not np.asarray(labels).any()
        assert np.array_equal(np.asarray(counts), [0, 0])


class TestSegment:
    def _fixture(self):
        frames = _sparse_frames(batch=3, shape=(48, 48), seed=6)
        mask = frames > 0
        labels, counts = ops.label_components(mask)
        return frames, np.asarray(labels), np.asarray(counts), labels

    @pytest.mark.parametrize("stat", ["max", "sum"])
    def test_l2_stats_match_oracle(self, stat):
        frames, labels_np, counts, labels = self._fixture()
        stats = np.asarray(ops.l2_summary_stats(labels, frames, max_puddles=512, statistic=stat, bit_depth=16))
        for i in range(frames.shape[0]):
            ref_labels, ref_num = oracle.label_components(frames[i] > 0)
            expected = oracle.l2_summary_stats(ref_labels, frames[i], ref_num, stat)
            assert np.array_equal(stats[i][: ref_num], expected.astype(np.uint32))

    @pytest.mark.parametrize("scheme", ["weighted_average", "unweighted", "max"])
    def test_l4_centroids_match_oracle(self, scheme):
        frames, labels_np, counts, labels = self._fixture()
        cents = np.asarray(ops.l4_centroids(labels, frames, max_puddles=512, scheme=scheme))
        for i in range(frames.shape[0]):
            ref_labels, ref_num = oracle.label_components(frames[i] > 0)
            expected = oracle.l4_centroids(ref_labels, frames[i], ref_num, scheme)
            np.testing.assert_allclose(cents[i][: ref_num], expected, rtol=1e-5, atol=1e-5)


class TestEncodeDecode:
    @pytest.mark.parametrize("bit_depth", [12, 16])
    def test_l1_matches_oracle(self, bit_depth):
        frames = _sparse_frames(batch=4, seed=7)
        thr = np.zeros(frames.shape[1:], dtype=np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=1, bit_depth=bit_depth, max_values=2048)
        bitmap = np.asarray(res.bitmap)
        packed = np.asarray(res.packed)
        counts = np.asarray(res.counts)
        packed_len = np.asarray(res.packed_len)
        assert not np.asarray(res.overflow).any()
        for i in range(frames.shape[0]):
            enc = oracle.reduce_frame(frames[i], thr, 1, bit_depth)
            assert bitmap[i].tobytes() == enc["packed_binary_map"]
            assert counts[i] == enc["n_foreground"]
            assert packed_len[i] == len(enc["packed_pixvals"])
            assert packed[i][: packed_len[i]].tobytes() == enc["packed_pixvals"]

    def test_l1_nonzero_threshold(self):
        frames = _sparse_frames(batch=2, seed=8)
        rng = np.random.default_rng(9)
        thr = rng.integers(0, 64, size=frames.shape[1:]).astype(np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=1, bit_depth=12, max_values=2048)
        for i in range(frames.shape[0]):
            enc = oracle.reduce_frame(frames[i], thr, 1, 12)
            assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"]
            plen = int(np.asarray(res.packed_len)[i])
            assert np.asarray(res.packed)[i][:plen].tobytes() == enc["packed_pixvals"]

    def test_l3_matches_oracle(self):
        frames = _sparse_frames(batch=2, seed=10)
        thr = np.zeros(frames.shape[1:], dtype=np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=3, bit_depth=12, max_values=1)
        assert res.packed is None
        for i in range(frames.shape[0]):
            enc = oracle.reduce_frame(frames[i], thr, 3, 12)
            assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"]

    @pytest.mark.parametrize("stat", ["max", "sum"])
    def test_l2_matches_oracle(self, stat):
        frames = _sparse_frames(batch=2, shape=(48, 48), seed=11)
        thr = np.zeros(frames.shape[1:], dtype=np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=2, bit_depth=12,
                                max_values=512, l2_statistic=stat)
        for i in range(frames.shape[0]):
            enc = oracle.reduce_frame(frames[i], thr, 2, 12, l2_statistic=stat)
            assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"]
            plen = int(np.asarray(res.packed_len)[i])
            assert np.asarray(res.packed)[i][:plen].tobytes() == enc["packed_pixvals"]

    @pytest.mark.parametrize("scheme", ["weighted_average", "unweighted", "max"])
    def test_l4_matches_oracle(self, scheme):
        frames = _sparse_frames(batch=2, shape=(48, 48), seed=12)
        thr = np.zeros(frames.shape[1:], dtype=np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=4, bit_depth=12,
                                max_values=512, l4_scheme=scheme)
        for i in range(frames.shape[0]):
            enc = oracle.reduce_frame(frames[i], thr, 4, 12, l4_scheme=scheme)
            assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"]

    def test_l1_device_decode_roundtrip(self):
        frames = _sparse_frames(batch=3, seed=13)
        thr = np.zeros(frames.shape[1:], dtype=np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=1, bit_depth=12, max_values=2048)
        dense = np.asarray(ops.decode_l1_frames(res.bitmap, res.packed, 64, 64, 12))
        assert np.array_equal(dense, frames)

    def test_bitmap_decode(self):
        frames = _sparse_frames(batch=2, seed=14)
        thr = np.zeros(frames.shape[1:], dtype=np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=3, bit_depth=12, max_values=1)
        dense = np.asarray(ops.decode_bitmap_frames(res.bitmap, 64, 64))
        assert np.array_equal(dense.astype(bool), frames > 0)

    def test_overflow_flag(self):
        frames = np.full((1, 32, 32), 100, dtype=np.uint16)  # all foreground
        thr = np.zeros((32, 32), dtype=np.uint16)
        res = ops.encode_frames(frames, thr, reduction_level=1, bit_depth=12, max_values=16)
        assert bool(np.asarray(res.overflow)[0])


def test_bitpack_word_fastpath_matches_byte_path():
    """bitpack_values auto-routes word-group-aligned sizes through the
    word-stack formulation; both must emit identical bytes for every
    supported depth."""
    import numpy as np
    from pyrecode_tpu.ops import bitpack

    rng = np.random.default_rng(11)
    for b in (4, 7, 10, 12, 16):
        gv, _ = bitpack.packed_word_group_shape(b)
        n = gv * 37
        v = rng.integers(0, 1 << b, (2, n)).astype(np.uint32)
        got = np.asarray(bitpack.bitpack_values(v, b))
        ref = np.asarray(bitpack.bitpack_values_words(v, b))
        assert np.array_equal(got, ref), b
        # decode side agrees
        back = np.asarray(bitpack.bitunpack_values(got, b))
        assert np.array_equal(back[:, :n], v), b
