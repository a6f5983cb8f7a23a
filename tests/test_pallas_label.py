"""L2/L4 batch encode (XLA labelling + segment stats) vs the numpy oracle.

The file name is that of the cases' first subject, a fused labelling
kernel; the same cases now hold :func:`ops.encode_frames` at L2 and L4 to
the oracle byte for byte.
"""

import numpy as np
import pytest

from pyrecode_tpu import oracle
from pyrecode_tpu.ops import encode_frames


def _frames(batch=2, shape=(128, 128), density=0.03, seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((batch, *shape)) < density,
                    rng.integers(1, 4096, (batch, *shape)), 0).astype(np.uint16)


def _encode(frames, thr, level, max_values=1024, statistic="max",
            scheme="weighted_average"):
    return encode_frames(frames, thr, reduction_level=level, bit_depth=12,
                         max_values=max_values, l2_statistic=statistic,
                         l4_scheme=scheme)


def _check_l2(frames, thr, res, statistic):
    bitmap, packed = np.asarray(res.bitmap), np.asarray(res.packed)
    counts, packed_len = np.asarray(res.counts), np.asarray(res.packed_len)
    for i in range(frames.shape[0]):
        enc = oracle.reduce_frame(frames[i], thr, 2, 12, l2_statistic=statistic)
        assert bitmap[i].tobytes() == enc["packed_binary_map"], i
        _, num = oracle.label_components(frames[i] > thr)
        assert int(counts[i]) == num, (i, int(counts[i]), num)
        # stats are over RAW frame values, not residuals (reference
        # recode_writer.py:446 passes `frame`), saturated at the bit depth
        assert packed[i][:int(packed_len[i])].tobytes() == enc["packed_pixvals"], i


def _check_l4(frames, thr, res, scheme):
    for i in range(frames.shape[0]):
        enc = oracle.reduce_frame(frames[i], thr, 4, 12, l4_scheme=scheme)
        assert np.asarray(res.bitmap)[i].tobytes() == enc["packed_binary_map"], (scheme, i)


@pytest.mark.parametrize("statistic", ["max", "sum"])
def test_l2_matches_oracle(statistic):
    frames = _frames()
    thr = np.zeros(frames.shape[1:], np.uint16)
    res = _encode(frames, thr, 2, statistic=statistic)
    assert not np.asarray(res.overflow).any()
    _check_l2(frames, thr, res, statistic)


def test_l2_nonzero_threshold_quick():
    """Nonzero per-pixel threshold at 1% occupancy."""
    frames = _frames(seed=5, density=0.01)
    rng = np.random.default_rng(6)
    thr = rng.integers(0, 64, size=frames.shape[1:]).astype(np.uint16)
    res = _encode(frames, thr, 2, statistic="sum")
    assert not np.asarray(res.overflow).any()
    _check_l2(frames, thr, res, "sum")


def test_l2_nonzero_threshold():
    """5% density grows accidental chains of touching pixels."""
    frames = _frames(seed=3, density=0.05)
    rng = np.random.default_rng(4)
    thr = rng.integers(0, 64, size=frames.shape[1:]).astype(np.uint16)
    res = _encode(frames, thr, 2, max_values=2048, statistic="sum")
    assert not np.asarray(res.overflow).any()
    _check_l2(frames, thr, res, "sum")


@pytest.mark.parametrize("scheme,shape,seed", [
    ("weighted_average", (128, 128), 5),
    ("unweighted", (128, 128), 5),
    ("max", (128, 128), 5),
    ("weighted_average", (64, 128), 7),
])
def test_l4_matches_oracle(scheme, shape, seed):
    frames = _frames(seed=seed, shape=shape)
    thr = np.zeros(frames.shape[1:], np.uint16)
    res = _encode(frames, thr, 4, scheme=scheme)
    assert res.packed is None
    assert not np.asarray(res.overflow).any()
    _check_l4(frames, thr, res, scheme)


def test_big_puddle_labels_across_rows():
    """A 24-row puddle: labels must propagate across the whole component."""
    frames = np.zeros((1, 32, 128), np.uint16)
    frames[0, 4:28, 20:25] = 100
    thr = np.zeros((32, 128), np.uint16)
    res = _encode(frames, thr, 2)
    _check_l2(frames, thr, res, "max")


@pytest.mark.parametrize("length", [6, 12])
@pytest.mark.parametrize("lvl,stat,scheme", [
    (2, "sum", "weighted_average"),
    (2, "max", "weighted_average"),
    (4, "max", "weighted_average"),
    (4, "max", "unweighted"),
])
def test_line_puddle_is_one_component(length, lvl, stat, scheme):
    """A straight-line puddle (long geodesic radius, one component) encodes
    exactly at both levels."""
    frames = np.zeros((1, 64, 128), np.uint16)
    frames[0, 10, 10:10 + length] = np.arange(5, 5 + length, dtype=np.uint16)
    thr = np.zeros((64, 128), np.uint16)
    res = _encode(frames, thr, lvl, statistic=stat, scheme=scheme)
    assert int(np.asarray(res.counts)[0]) == 1
    if lvl == 2:
        _check_l2(frames, thr, res, stat)
    else:
        _check_l4(frames, thr, res, scheme)
