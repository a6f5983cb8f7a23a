"""InitParams / InputParams tests."""

import numpy as np
import pytest

from pyrecode_tpu import InitParams, InputParams


_VALID = dict(
    reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
    target_bit_depth=12, source_bit_depth=12, num_cols=512, num_rows=512,
    num_frames=9, frame_offset=0, num_calibration_frames=1,
    calibration_frame_offset=0, keep_part_files=0, num_threads=3,
    l2_statistics=0, l4_centroiding=0, compression_scheme=0,
    compression_level=1, source_file_type=0, source_header_length=0,
    keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
    target_data_type=0,
)


def test_load_reference_config_file(reference_tree):
    p = InputParams()
    p.load(reference_tree / "config" / "recode_params_minimal_read_write_test.txt")
    assert p.reduction_level == 1
    assert p.rc_operation_mode == 1
    assert p.compression_scheme == 0
    assert p.num_threads == 3
    assert p.source_bit_depth == 12
    # mirrors reference tests/minimal_read_write_test.py:39-40
    p.source_data_type = 0
    p.target_data_type = 0
    assert p.validate()
    assert p.source_numpy_dtype == np.uint16


def test_unknown_key_rejected(tmp_path):
    f = tmp_path / "bad.txt"
    f.write_text("bogus_key = 3\n")
    with pytest.raises(ValueError, match="Unknown parameter"):
        InputParams().load(str(f))


def test_serialize_roundtrip(tmp_path):
    p = InputParams(_VALID)
    assert p.validate()
    f = tmp_path / "params.txt"
    p.serialize(str(f))
    p2 = InputParams()
    p2.load(str(f))
    assert p2.validate()
    for key, value in _VALID.items():
        assert p2.as_dict()[key] == value, key


def test_validation_failures():
    bad = dict(_VALID, reduction_level=7)
    assert not InputParams(bad).validate()
    bad = dict(_VALID, compression_scheme=99)
    assert not InputParams(bad).validate()
    bad = dict(_VALID, rc_operation_mode=5)
    assert not InputParams(bad).validate()


def test_validation_mutations():
    p = InputParams(dict(_VALID, frame_offset=-5, num_threads=0, target_bit_depth=-1))
    assert p.validate()
    assert p.frame_offset == 0
    assert p.num_threads == 1
    assert p.target_bit_depth == p.source_bit_depth


def test_nx_ny_nz_aliases():
    p = InputParams(_VALID)
    p.nx = 1024
    p.ny = 2048
    p.nz = 7
    assert p.num_cols == 1024 and p.num_rows == 2048 and p.num_frames == 7


def test_init_params_validation(tmp_path):
    with pytest.raises(ValueError):
        InitParams("bogus", str(tmp_path), image_filename="x")
    with pytest.raises(ValueError):
        InitParams("batch", "", image_filename="x")
    with pytest.raises(ValueError):
        InitParams("batch", str(tmp_path))  # batch needs image_filename
    p = InitParams("stream", str(tmp_path), verbosity=9)
    assert p.verbosity == 2
    assert p.use_device and p.use_tpu
    # use_tpu is an older alias of use_device and wins when given
    assert not InitParams("stream", str(tmp_path), use_device=False).use_device
    assert not InitParams("stream", str(tmp_path), use_tpu=False).use_device
