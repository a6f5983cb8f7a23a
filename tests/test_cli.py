"""CLI smoke tests (in-process via cli.main)."""

import numpy as np
import pytest

from pyrecode_tpu import InputParams, cli
from pyrecode_tpu.writer import ReCoDeWriter
from pyrecode_tpu.reader import merge_parts


def _make_container(tmp_path):
    rng = np.random.default_rng(0)
    data = np.where(rng.random((3, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (3, 64, 64)), 0).astype(np.uint16)
    params = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64,
        num_frames=3, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=2,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
        target_data_type=0))
    assert params.validate()
    for node in range(2):
        w = ReCoDeWriter("clidata", dark_data=np.zeros((64, 64), np.uint16),
                         output_directory=str(tmp_path), input_params=params,
                         node_id=node)
        w.start()
        w.run(data)
        w.close()
    return data


def test_cli_merge_and_read(tmp_path, capsys):
    _make_container(tmp_path)
    assert cli.main(["merge", "--folder", str(tmp_path), "--base", "clidata.rc1",
                     "--num_parts", "2"]) == 0
    out = capsys.readouterr().out
    assert "clidata.rc1" in out

    assert cli.main(["read", "--file", str(tmp_path / "clidata.rc1")]) == 0
    out = capsys.readouterr().out
    assert "3 frames of 64x64" in out

    assert cli.main(["read", "--file", str(tmp_path / "clidata.rc1"),
                     "--frame", "1"]) == 0
    out = capsys.readouterr().out
    assert "frame 1:" in out


def test_cli_write_from_file(tmp_path, capsys):
    rng = np.random.default_rng(1)
    data = np.where(rng.random((2, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (2, 64, 64)), 0).astype(np.uint16)
    src = tmp_path / "src.bin"
    src.write_bytes(data.tobytes())
    dark = tmp_path / "dark.bin"
    dark.write_bytes(np.zeros((64, 64), np.uint16).tobytes())
    params_file = tmp_path / "params.txt"
    params_file.write_text("\n".join([
        "reduction_level = 1", "rc_operation_mode = 1",
        "calibration_threshold_epsilon = 0", "target_bit_depth = 12",
        "source_bit_depth = 12", "num_cols = 64", "num_rows = 64",
        "num_frames = 2", "frame_offset = 0", "num_calibration_frames = 1",
        "calibration_frame_offset = 0", "keep_part_files = 0",
        "num_threads = 1", "l2_statistics = 0", "l4_centroiding = 0",
        "compression_scheme = 0", "compression_level = 1",
        "source_file_type = 0", "source_header_length = 0",
        "keep_calibration_data = 1", "calibration_file_type = 0",
        "source_data_type = 0", "target_data_type = 0"]))
    assert cli.main(["write", "--image_filename", str(src),
                     "--calibration_file", str(dark),
                     "--out_dir", str(tmp_path),
                     "--params_file", str(params_file)]) == 0
    assert (tmp_path / "src.rc1_part000").exists()


@pytest.mark.parametrize("flag,use_device", [
    ([], True), (["--no_device"], False), (["--no_tpu"], False)])
def test_cli_device_flag_and_its_older_alias(tmp_path, flag, use_device):
    args = cli.build_parser().parse_args(
        ["server", "--out_dir", str(tmp_path), "--image_filename", "run", *flag])
    assert cli._init_params_from(args).use_device is use_device
