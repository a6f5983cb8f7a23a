"""End-to-end container round-trip: writer -> part files -> merge -> reader.

Mirrors the reference's canonical test (tests/minimal_read_write_test.py):
(9, 512, 512) uint16 sparse fixture, L1 + zlib + mode 1, 3 nodes, bit-exact
dense comparison on both intermediate and merged files.
"""

import numpy as np
import pytest

from pyrecode_tpu import InputParams
from pyrecode_tpu.reader import ReCoDeReader, merge_parts
from pyrecode_tpu.writer import ReCoDeWriter


def _fixture(shape=(9, 128, 128), seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4096, size=shape).astype(np.int64) - 3500
    data[data < 0] = 0
    return data.astype(np.uint16)


def _params(shape, num_threads=3, **overrides):
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[2], num_rows=shape[1],
        num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=num_threads,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=0, target_data_type=0,
    )
    values.update(overrides)
    p = InputParams(values)
    assert p.validate()
    return p


def _write_parts(tmp_path, data, dark, input_params, use_device=True, name="test_data",
                 validation_frame_gap=-1):
    nt = input_params.num_threads
    for node_id in range(nt):
        writer = ReCoDeWriter(
            name, dark_data=dark, output_directory=str(tmp_path),
            input_params=input_params, mode="batch", node_id=node_id,
            use_device=use_device, validation_frame_gap=validation_frame_gap)
        writer.start()
        writer.run(data)
        writer.close()


@pytest.mark.parametrize("use_device", [True, False])
def test_minimal_read_write(tmp_path, use_device):
    """The canonical L1+zlib multi-part round-trip."""
    data = _fixture()
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape)
    _write_parts(tmp_path, data, dark, params, use_device=use_device)

    # intermediate part 0 holds frames 0..2
    reader = ReCoDeReader(str(tmp_path / "test_data.rc1_part000"), is_intermediate=True)
    reader.open()
    header = reader.get_header().as_dict()
    for _ in range(3):
        frame_data = reader.get_next_frame()
        assert frame_data is not None
        frame_id = next(iter(frame_data.keys()))
        dense = frame_data[frame_id]["data"].todense()
        assert np.array_equal(dense, data[frame_id]), frame_id
    assert reader.get_next_frame() is None
    reader.close()
    assert header["nz"] == 3  # patched at close to true per-part count

    merged = merge_parts(str(tmp_path), "test_data.rc1", 3)

    reader = ReCoDeReader(merged, is_intermediate=False)
    reader.open()
    assert reader.get_shape() == data.shape
    for i in range(data.shape[0]):
        frame_data = reader.get_next_frame()
        assert np.array_equal(frame_data[i]["data"].todense(), data[i]), i
    reader.close()


def test_random_access_and_dense_batch(tmp_path):
    data = _fixture(shape=(6, 96, 96), seed=3)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=2)
    _write_parts(tmp_path, data, dark, params)
    merged = merge_parts(str(tmp_path), "test_data.rc1", 2)

    reader = ReCoDeReader(merged)
    reader.open()
    # random access out of order
    for z in (4, 1, 5, 0):
        fd = reader.get_frame(z)
        assert np.array_equal(fd[z]["data"].todense(), data[z]), z
    # batched dense decode (device path)
    dense = reader.read_frames_dense(1, 4)
    assert np.array_equal(dense, data[1:5])
    dense_np = reader.read_frames_dense(0, 6, use_device=False)
    assert np.array_equal(dense_np, data)
    # the older keyword still selects the oracle decode
    assert np.array_equal(reader.read_frames_dense(0, 6, use_tpu=False), data)
    reader.close()


def test_mode0_reduce_only(tmp_path):
    data = _fixture(shape=(4, 64, 64), seed=4)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=2, rc_operation_mode=0)
    _write_parts(tmp_path, data, dark, params)
    merged = merge_parts(str(tmp_path), "test_data.rc1", 2)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(data.shape[0]):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i]), i
    reader.close()


def test_nonzero_dark_and_epsilon(tmp_path):
    data = _fixture(shape=(4, 64, 64), seed=5)
    rng = np.random.default_rng(6)
    dark = rng.integers(0, 50, size=data.shape[1:]).astype(np.uint16)
    params = _params(data.shape, num_threads=1, calibration_threshold_epsilon=10)
    _write_parts(tmp_path, data, dark, params)
    merged = merge_parts(str(tmp_path), "test_data.rc1", 1)
    reader = ReCoDeReader(merged)
    reader.open()
    thr = (dark.astype(np.int64) + 10).astype(np.uint16)
    for i in range(data.shape[0]):
        fd = reader.get_next_frame()
        mask = data[i] > thr
        expected = np.where(mask, data[i] - thr, 0)
        assert np.array_equal(fd[i]["data"].todense(), expected), i
    reader.close()


def test_l3_roundtrip(tmp_path):
    data = _fixture(shape=(4, 64, 64), seed=7)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=2, reduction_level=3)
    _write_parts(tmp_path, data, dark, params, name="test_data")
    merged = merge_parts(str(tmp_path), "test_data.rc3", 2)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(data.shape[0]):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense().astype(bool), data[i] > 0), i
    reader.close()


def test_l2_roundtrip(tmp_path):
    from pyrecode_tpu import oracle

    data = _fixture(shape=(3, 64, 64), seed=8)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=1, reduction_level=2, l2_statistics=2)
    _write_parts(tmp_path, data, dark, params)
    merged = merge_parts(str(tmp_path), "test_data.rc2", 1)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(data.shape[0]):
        fd = reader.get_next_frame()
        # binary map = thresholded mask
        assert np.array_equal(fd[i]["data"].todense().astype(bool), data[i] > 0)
        # summary stats = per-puddle sums (clipped to 12 bits by the writer)
        labels, num = oracle.label_components(data[i] > 0)
        expected = oracle.l2_summary_stats(labels, data[i], num, "sum")
        expected = np.minimum(expected, (1 << 12) - 1)
        got = fd[i]["summary_stats"]
        assert np.array_equal(got[:num], expected.astype(got.dtype))
    reader.close()


def test_l4_roundtrip(tmp_path):
    from pyrecode_tpu import oracle

    data = _fixture(shape=(3, 64, 64), seed=9)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=1, reduction_level=4)
    _write_parts(tmp_path, data, dark, params)
    merged = merge_parts(str(tmp_path), "test_data.rc4", 1)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(data.shape[0]):
        fd = reader.get_next_frame()
        enc = oracle.reduce_frame(data[i], dark, 4, 12)
        expected = oracle.unpack_binary_frame(
            np.frombuffer(enc["packed_binary_map"], dtype=np.uint8), 64 * 64).reshape(64, 64)
        assert np.array_equal(fd[i]["data"].todense().astype(bool), expected.astype(bool))
    reader.close()


def test_zstd_scheme(tmp_path):
    data = _fixture(shape=(4, 64, 64), seed=10)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=1, compression_scheme=1, compression_level=3)
    _write_parts(tmp_path, data, dark, params)
    merged = merge_parts(str(tmp_path), "test_data.rc1", 1)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(data.shape[0]):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i]), i
    reader.close()


def test_validation_frames_written(tmp_path):
    data = _fixture(shape=(6, 64, 64), seed=11)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=1)
    _write_parts(tmp_path, data, dark, params, validation_frame_gap=2)
    vfile = tmp_path / "test_data_part000_validation_frames.bin"
    assert vfile.exists()
    raw = np.frombuffer(vfile.read_bytes(), dtype=np.uint16)
    frames = raw.reshape(-1, 64, 64)
    assert frames.shape[0] == 3  # frames 0, 2, 4
    assert np.array_equal(frames[0], data[0])
    assert np.array_equal(frames[1], data[2])


def test_uneven_split(tmp_path):
    """7 frames over 3 nodes -> 3+3+1."""
    data = _fixture(shape=(7, 64, 64), seed=12)
    dark = np.zeros(data.shape[1:], dtype=np.uint16)
    params = _params(data.shape, num_threads=3)
    _write_parts(tmp_path, data, dark, params)
    merged = merge_parts(str(tmp_path), "test_data.rc1", 3)
    reader = ReCoDeReader(merged)
    reader.open()
    assert reader.get_shape()[0] == 7
    for i in range(7):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i]), i
    reader.close()


def test_threshold_saturates_instead_of_wrapping(tmp_path):
    """dark + epsilon past the dtype max must saturate (pixel permanently
    background), not wrap to ~0 (pixel permanently foreground)."""
    dark = np.full((16, 16), 65530, dtype=np.uint16)
    params = _params((2, 16, 16), num_threads=1, calibration_threshold_epsilon=10)
    writer = ReCoDeWriter("sat", dark_data=dark, output_directory=str(tmp_path),
                          input_params=params, use_device=False)
    assert writer._threshold.dtype == np.uint16
    assert np.all(writer._threshold == 65535)  # saturated, not 65530+10-65536=4


def test_l2_no_spurious_pad_puddles(tmp_path):
    """For bit_depth < 8 the packed summary-stat stream's pad bits must not
    decode as extra zero-valued puddles (puddle count comes from the label
    pass, not the padded byte length)."""
    from pyrecode_tpu import oracle

    # exactly 3 puddles: 3 values * 4 bits = 12 bits -> 2 bytes; a byte-length
    # derived count would report 4 puddles
    data = np.zeros((1, 32, 32), dtype=np.uint16)
    data[0, 2, 2] = 9
    data[0, 10, 10] = 13
    data[0, 20, 20] = 7
    dark = np.zeros((32, 32), dtype=np.uint16)
    params = _params(data.shape, num_threads=1, reduction_level=2,
                     l2_statistics=1, target_bit_depth=4, source_bit_depth=4)
    _write_parts(tmp_path, data, dark, params, use_device=False)
    merged = merge_parts(str(tmp_path), "test_data.rc2", 1)
    reader = ReCoDeReader(merged)
    reader.open()
    fd = reader.get_next_frame()
    stats = fd[0]["summary_stats"]
    assert len(stats) == 3
    assert np.array_equal(np.sort(stats), [7, 9, 13])
    reader.close()


def test_scheme12_dense_reader_symbol_chain(tmp_path):
    """Dense frames make the writer pick byte/symbol-mode bitmaps (gaps
    lose the size comparison); the reader's host rANS decode plus device
    L1 decode must still rebuild them bit-exactly."""
    from pyrecode_tpu import oracle

    data = oracle.synthetic_frames(4, 128, 512, 0.10, 12, "peaked", rng=21)
    dark = np.zeros(data.shape[1:], np.uint16)
    params = _params(data.shape, num_threads=1, compression_scheme=12)
    _write_parts(tmp_path, data, dark, params, use_device=False)
    merged = merge_parts(str(tmp_path), "test_data.rc1", 1)
    r = ReCoDeReader(merged)
    r.open()
    dense = r.read_frames_dense(0, 4)
    assert np.array_equal(dense, data)
    assert np.array_equal(r.read_frames_dense(0, 4, use_device=False), data)
    r.close()
