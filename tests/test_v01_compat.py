"""Backward compatibility: reading ReCoDe v0.1 containers.

The reference keeps a v0.1 read path for legacy 321-byte-header files
(recode_header.py:27-56, tests/recode_v1_read_test.py).  We synthesize a
v0.1 merged file (via the reference's own header serializer where importable)
and decode it with our reader.
"""

import zlib

import numpy as np

from pyrecode_tpu import InitParams, InputParams, oracle
from pyrecode_tpu.reader import ReCoDeReader


def _build_v01_file(tmp_path, frames, use_reference_header=True):
    """Write a merged v0.1 L1/mode-1/zlib file for the given frames."""
    ny, nx = frames.shape[1:]
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=nx, num_rows=ny,
        num_frames=frames.shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=1,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
        target_data_type=0)
    input_params = InputParams(values)
    assert input_params.validate()
    init_params = InitParams("batch", str(tmp_path), image_filename="legacy")

    if use_reference_header:
        from pyrecode.recode_header import ReCoDeHeader as RefHeader

        header = RefHeader(version=0.1)
        header.create(init_params, input_params, True)
    else:
        from pyrecode_tpu.header import ReCoDeHeader

        header = ReCoDeHeader(version=0.1)
        header.create(init_params, input_params, True)

    # encode payloads with the oracle
    thr = np.zeros((ny, nx), dtype=np.uint16)
    blobs = []
    metadata = []
    for frame in frames:
        enc = oracle.reduce_frame(frame, thr, 1, 12)
        cbm = zlib.compress(enc["packed_binary_map"], 1)
        cpx = zlib.compress(enc["packed_pixvals"], 1)
        blobs.append(cbm + cpx)
        metadata.append((len(cbm), len(cpx), len(enc["packed_pixvals"])))

    path = tmp_path / "legacy.rc1"
    with open(path, "wb") as fp:
        if use_reference_header:
            header.serialize_to(fp)
        else:
            header.serialize_to(fp)
        for md in metadata:  # merged layout: metadata table then frame data
            for value in md:
                fp.write(int(value).to_bytes(4, "little"))
        for blob in blobs:
            fp.write(blob)
    return path


def test_read_v01_file_reference_header(tmp_path, reference_tree):
    rng = np.random.default_rng(0)
    frames = np.where(rng.random((3, 64, 64)) < 0.05,
                      rng.integers(1, 4096, (3, 64, 64)), 0).astype(np.uint16)
    path = _build_v01_file(tmp_path, frames, use_reference_header=True)

    reader = ReCoDeReader(str(path))
    reader.open()
    header = reader.get_header().as_dict()
    assert header["version_minor"] == 1
    assert reader.get_header().recode_header_length == 321
    assert reader.get_shape() == (3, 64, 64)
    for i in range(3):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), frames[i]), i
    # random access also works on v0.1
    fd = reader.get_frame(1)
    assert np.array_equal(fd[1]["data"].todense(), frames[1])
    reader.close()


def test_read_v01_file_our_header(tmp_path):
    rng = np.random.default_rng(1)
    frames = np.where(rng.random((2, 32, 32)) < 0.1,
                      rng.integers(1, 4096, (2, 32, 32)), 0).astype(np.uint16)
    path = _build_v01_file(tmp_path, frames, use_reference_header=False)
    reader = ReCoDeReader(str(path))
    reader.open()
    for i in range(2):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), frames[i]), i
    reader.close()
