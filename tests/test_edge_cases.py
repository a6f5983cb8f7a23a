"""Edge cases: empty slices, odd dtypes/bit depths, degenerate frames."""

import numpy as np
import pytest

from pyrecode_tpu import InputParams, oracle
from pyrecode_tpu.reader import ReCoDeReader, merge_parts
from pyrecode_tpu.writer import ReCoDeWriter


def _params(shape, num_threads=1, **overrides):
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


def _write_and_merge(tmp_path, data, params, name="edge_data", **writer_kw):
    for node_id in range(params.num_threads):
        w = ReCoDeWriter(name, dark_data=np.zeros(data.shape[1:], data.dtype),
                         output_directory=str(tmp_path), input_params=params,
                         node_id=node_id, **writer_kw)
        w.start()
        w.run(data)
        w.close()
    return merge_parts(str(tmp_path), f"{name}.rc{params.reduction_level}",
                       params.num_threads)


def test_more_nodes_than_frames(tmp_path):
    """2 frames over 3 nodes: node 2 writes an empty part; merge survives."""
    rng = np.random.default_rng(0)
    data = np.where(rng.random((2, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (2, 64, 64)), 0).astype(np.uint16)
    params = _params(data.shape, num_threads=3)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    assert reader.get_shape()[0] == 2
    for i in range(2):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i])
    reader.close()


def test_all_zero_frames(tmp_path):
    """Frames with no foreground at all produce valid (tiny) records."""
    data = np.zeros((3, 64, 64), dtype=np.uint16)
    params = _params(data.shape)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(3):
        fd = reader.get_next_frame()
        assert fd[i]["data"].nnz == 0
    reader.close()


def test_fully_saturated_frames(tmp_path):
    """Every pixel foreground (capacity escalation to the densest bucket)."""
    data = np.full((2, 64, 128), 4095, dtype=np.uint16)
    params = _params(data.shape)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(2):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i])
    reader.close()


def test_uint8_source_bit_depth_8(tmp_path):
    """8-bit source: intensities stored as raw bytes (depth % 8 == 0)."""
    rng = np.random.default_rng(1)
    data = np.where(rng.random((3, 64, 64)) < 0.1,
                    rng.integers(1, 255, (3, 64, 64)), 0).astype(np.uint8)
    params = _params(data.shape, source_bit_depth=8, target_bit_depth=8)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(3):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i])
    reader.close()


def test_bit_depth_16(tmp_path):
    """16-bit depth: tobytes() fast path on both ends."""
    rng = np.random.default_rng(2)
    data = np.where(rng.random((3, 64, 64)) < 0.05,
                    rng.integers(1, 65535, (3, 64, 64)), 0).astype(np.uint16)
    params = _params(data.shape, source_bit_depth=16, target_bit_depth=16)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(3):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i])
    reader.close()


def test_non_square_frames(tmp_path):
    rng = np.random.default_rng(3)
    data = np.where(rng.random((2, 48, 160)) < 0.05,
                    rng.integers(1, 4096, (2, 48, 160)), 0).astype(np.uint16)
    params = _params(data.shape, num_threads=2)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    assert reader.get_shape() == (2, 48, 160)
    for i in range(2):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i])
    reader.close()


def test_width_not_multiple_of_8(tmp_path):
    """nx % 8 != 0: bitmap bytes carry a ragged tail bit block."""
    rng = np.random.default_rng(4)
    data = np.where(rng.random((2, 32, 36)) < 0.1,
                    rng.integers(1, 4096, (2, 32, 36)), 0).astype(np.uint16)
    params = _params(data.shape)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(2):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i])
    reader.close()


def test_l2_through_writer_batched(tmp_path):
    """L2 via the full writer/reader path with the label kernel active."""
    rng = np.random.default_rng(5)
    data = np.where(rng.random((3, 128, 128)) < 0.03,
                    rng.integers(1, 4096, (3, 128, 128)), 0).astype(np.uint16)
    params = _params(data.shape, reduction_level=2, l2_statistics=2)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(3):
        fd = reader.get_next_frame()
        labels, num = oracle.label_components(data[i] > 0)
        expected = np.minimum(oracle.l2_summary_stats(labels, data[i], num, "sum"),
                              (1 << 12) - 1)
        got = fd[i]["summary_stats"]
        assert np.array_equal(got[:num], expected.astype(got.dtype)), i
    reader.close()


def test_single_frame_single_node(tmp_path):
    rng = np.random.default_rng(6)
    data = np.where(rng.random((1, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (1, 64, 64)), 0).astype(np.uint16)
    params = _params(data.shape)
    merged = _write_and_merge(tmp_path, data, params)
    reader = ReCoDeReader(merged)
    reader.open()
    fd = reader.get_frame(0)
    assert np.array_equal(fd[0]["data"].todense(), data[0])
    reader.close()


def test_binary_file_source(tmp_path):
    """Writer reads frames from a raw binary source file (not in-memory)."""
    rng = np.random.default_rng(7)
    data = np.where(rng.random((5, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (5, 64, 64)), 0).astype(np.uint16)
    src = tmp_path / "source.bin"
    src.write_bytes(data.tobytes())
    params = _params(data.shape, num_threads=2)
    for node_id in range(2):
        w = ReCoDeWriter(str(src), dark_data=np.zeros((64, 64), np.uint16),
                         output_directory=str(tmp_path), input_params=params,
                         node_id=node_id)
        w.start()
        w.run()  # no in-memory data: reads its slice from the file
        w.close()
    merged = merge_parts(str(tmp_path), "source.rc1", 2)
    reader = ReCoDeReader(merged)
    reader.open()
    for i in range(5):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i])
    reader.close()


def test_review_regressions(tmp_path):
    """Regression coverage for review findings."""
    from pyrecode_tpu.header import ReCoDeHeader
    from pyrecode_tpu import InitParams
    from pyrecode_tpu.utils import calibration

    # non-ASCII filenames must not change the fixed header size
    init = InitParams("batch", str(tmp_path), image_filename="données_μ.bin")
    params = _params((2, 64, 64))
    h = ReCoDeHeader()
    h.create(init, params, is_intermediate=True)
    assert len(h.to_bytes()) == 512
    path = tmp_path / "utf8.hdr"
    h.serialize(str(path))
    h2 = ReCoDeHeader()
    h2.load(str(path))
    assert h2.as_dict()["nz"] == 2  # fields after the name are not shifted

    # accurate thresholds with expected events >= nFrames must not crash
    rng = np.random.default_rng(0)
    frames = rng.normal(100, 4, (5, 8, 8)).astype(np.float32)
    base = np.median(frames, axis=0).astype(np.float32)
    out = calibration.accurate_pixel_thresholds(frames, base, expected_n_events=50)
    assert out.shape == (8, 8)

    # read_frames_dense past the end raises cleanly
    data = _fixture_small = np.zeros((2, 64, 64), np.uint16)
    data[0, 1, 1] = 5
    merged = _write_and_merge(tmp_path, data, _params(data.shape), name="rr")
    reader = ReCoDeReader(merged)
    reader.open()
    with pytest.raises(ValueError):
        reader.read_frames_dense(2, 4)
    reader.close()
