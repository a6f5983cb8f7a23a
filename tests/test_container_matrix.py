"""Writer -> part files -> merge -> reader across schemes and levels.

Every container written on the device path must be byte-identical to the
oracle path's, and read back exactly; scheme-12 containers are read through
each stream flavour the writer picks (gap, symbol, byte, stored).
"""

import numpy as np
import pytest

from pyrecode_tpu import InputParams, oracle
from pyrecode_tpu.reader import ReCoDeReader, merge_parts
from pyrecode_tpu.writer import ReCoDeWriter

SHAPE = (5, 48, 80)


def _params(shape, level, scheme, num_threads=2):
    p = InputParams(dict(
        reduction_level=level, rc_operation_mode=1, calibration_threshold_epsilon=3,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[2],
        num_rows=shape[1], num_frames=shape[0], frame_offset=0,
        num_calibration_frames=1, calibration_frame_offset=0, keep_part_files=1,
        num_threads=num_threads, l2_statistics=2, l4_centroiding=0,
        compression_scheme=scheme, compression_level=1, source_file_type=0,
        source_header_length=0, keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0))
    assert p.validate()
    return p


def _write(tmp_path, sub, data, dark, params, use_device):
    out = tmp_path / sub
    out.mkdir()
    for node_id in range(params.num_threads):
        w = ReCoDeWriter("m", dark_data=dark, output_directory=str(out),
                         input_params=params, node_id=node_id, use_device=use_device)
        w.start()
        w.run(data)
        w.close()
    return merge_parts(str(out), f"m.rc{params.reduction_level}", params.num_threads)


@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("scheme", [0, 12])
def test_device_container_matches_oracle_path(tmp_path, scheme, level):
    rng = np.random.default_rng(10 * scheme + level)
    dark = rng.integers(0, 6, SHAPE[1:]).astype(np.uint16)
    data = oracle.synthetic_frames(*SHAPE, occupancy=0.04, rng=rng) + dark
    thr = dark + 3
    params = _params(SHAPE, level, scheme)
    merged = _write(tmp_path, "dev", data, dark, params, True)
    with open(merged, "rb") as f, open(_write(tmp_path, "host", data, dark, params,
                                              False), "rb") as g:
        assert f.read() == g.read()

    reader = ReCoDeReader(merged)
    reader.open()
    h, w = SHAPE[1:]
    for i in range(SHAPE[0]):
        got = reader.get_next_frame()[i]
        enc = oracle.reduce_frame(data[i], thr, level, 12, l2_statistic="sum")
        bits = oracle.unpack_binary_frame(
            np.frombuffer(enc["packed_binary_map"], np.uint8), h * w).reshape(h, w)
        dense = np.asarray(got["data"].todense())
        if level == 1:
            assert np.array_equal(dense, np.where(data[i] > thr, data[i] - thr, 0)), i
        else:
            assert np.array_equal(dense.astype(bool), bits.astype(bool)), i
        if level == 2:
            labels, num = oracle.label_components(data[i] > thr)
            stats = np.minimum(oracle.l2_summary_stats(labels, data[i], num, "sum"), 4095)
            assert np.array_equal(got["summary_stats"][:num], stats), i
    if level == 1:
        assert np.array_equal(reader.read_frames_dense(0, SHAPE[0]),
                              np.where(data > thr, data - thr, 0))
    reader.close()


@pytest.mark.parametrize("flavour,occupancy,flag", [
    ("gap", 0.002, 6),
    ("symbol", 0.05, 2),
    ("byte", 0.0, 0),
    ("stored", 0.3, 1),
])
def test_scheme12_flavours_read_dense(tmp_path, flavour, occupancy, flag):
    """The writer picks each bitmap-stream flavour by size; the reader's
    host rANS decode plus device L1 decode rebuilds every one exactly."""
    shape = (3, 128, 128)
    data = oracle.synthetic_frames(*shape, occupancy=occupancy, rng=3)
    dark = np.zeros(shape[1:], np.uint16)
    params = _params(shape, 1, 12, num_threads=1)
    params.calibration_threshold_epsilon = 0
    merged = _write(tmp_path, flavour, data, dark, params, True)
    reader = ReCoDeReader(merged)
    reader.open()
    raw = reader.get_next_frame_raw()[0]["data"]
    assert raw["binary_map"][3] == flag, flavour
    assert np.array_equal(reader.read_frames_dense(0, shape[0]), data)
    assert np.array_equal(reader.read_frames_dense(0, shape[0], use_device=False), data)
    reader.close()
