"""Header codec tests, including golden-byte parity with the reference.

The reference's header/params/structures modules are pure numpy and are
imported directly from the reference tree (``reference_tree`` fixture,
conftest.py) to produce golden bytes.
"""

import numpy as np
import pytest

from pyrecode_tpu import InitParams, InputParams, ReCoDeHeader


def _make_params(tmp_path, **overrides):
    init_params = InitParams(
        "batch", str(tmp_path), image_filename="test_data",
        validation_frame_gap=2, log_filename=str(tmp_path / "recode.log"),
        run_name="hdr_test", verbosity=0,
    )
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=512, num_rows=512,
        num_frames=9, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=3,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
        target_data_type=0,
    )
    values.update(overrides)
    input_params = InputParams(values)
    assert input_params.validate()
    return init_params, input_params


def test_v02_header_is_512_bytes(tmp_path):
    init_params, input_params = _make_params(tmp_path)
    h = ReCoDeHeader()
    h.create(init_params, input_params, is_intermediate=True)
    assert h.recode_header_length == 512
    assert len(h.to_bytes()) == 512


def test_v01_header_is_321_bytes():
    h = ReCoDeHeader(version=0.1)
    assert h.recode_header_length == 321


def test_golden_bytes_vs_reference(tmp_path, reference_tree):
    """Byte-for-byte identical v0.2 header vs the reference implementation."""
    from pyrecode.recode_header import ReCoDeHeader as RefHeader

    init_params, input_params = _make_params(tmp_path)

    ours = ReCoDeHeader()
    ours.create(init_params, input_params, is_intermediate=True)

    ref = RefHeader()
    ref.create(init_params, input_params, True)
    ref_path = tmp_path / "ref_header.bin"
    ref.serialize(str(ref_path))
    ref_bytes = ref_path.read_bytes()

    assert ours.to_bytes() == ref_bytes


def test_roundtrip_serialize_load(tmp_path):
    init_params, input_params = _make_params(tmp_path, compression_scheme=1, num_frames=77)
    h = ReCoDeHeader()
    h.create(init_params, input_params, is_intermediate=False)
    path = tmp_path / "hdr.bin"
    h.serialize(str(path))

    h2 = ReCoDeHeader()
    h2.load(str(path))
    d = h2.as_dict()
    assert d["uid"] == 158966344846346
    assert d["version_major"] == 0 and d["version_minor"] == 2
    assert d["nx"] == 512 and d["ny"] == 512 and d["nz"] == 77
    assert d["compression_scheme"] == 1
    assert d["reduction_level"] == 1
    assert d["is_intermediate"] == 0
    assert d["source_file_name"] == "test_data"


def test_load_reference_written_header(tmp_path, reference_tree):
    """We can load headers written by the reference implementation."""
    from pyrecode.recode_header import ReCoDeHeader as RefHeader

    init_params, input_params = _make_params(tmp_path, reduction_level=3, num_frames=5)
    ref = RefHeader()
    ref.create(init_params, input_params, True)
    ref_path = tmp_path / "ref_header2.bin"
    ref.serialize(str(ref_path))

    h = ReCoDeHeader()
    h.load(str(ref_path))
    d = h.as_dict()
    assert d["reduction_level"] == 3
    assert d["nz"] == 5
    assert d["is_intermediate"] == 1


def test_nz_patch_position(tmp_path):
    """The nz field can be patched in place (writer close / merge behavior)."""
    init_params, input_params = _make_params(tmp_path)
    h = ReCoDeHeader()
    h.create(init_params, input_params, is_intermediate=True)
    path = tmp_path / "hdr.bin"
    h.serialize(str(path))

    pos = h.get_field_position_in_bytes("nz")
    nbytes = h.get_definition("nz")["bytes"]
    with open(path, "r+b") as fp:
        fp.seek(pos)
        fp.write(int(1234).to_bytes(nbytes, "little"))

    h2 = ReCoDeHeader()
    h2.load(str(path))
    assert h2.as_dict()["nz"] == 1234


def test_frame_data_offset(tmp_path):
    init_params, input_params = _make_params(tmp_path, source_header_length=0)
    h = ReCoDeHeader()
    h.create(init_params, input_params, is_intermediate=True)
    path = tmp_path / "hdr.bin"
    h.serialize(str(path))
    h2 = ReCoDeHeader()
    h2.load(str(path))
    assert h2.get_frame_data_offset(True, 12) == 512
    # merged file: metadata table sits before frame data
    assert h2.get_frame_data_offset(False, 12) == 512 + 9 * 12


def test_bad_uid_rejected(tmp_path):
    path = tmp_path / "bad.bin"
    path.write_bytes(b"\x00" * 600)
    h = ReCoDeHeader()
    with pytest.raises(ValueError, match="uid"):
        h.load(str(path))
