"""Cross-implementation interop: the REFERENCE decodes our containers.

The reference reader needs only its C extension (`c_recode`) — not numba —
so we compile it from the read-only reference tree into a temp dir and run
the actual reference ``ReCoDeReader`` against files written by this
framework.  Skipped when the reference tree or a compiler is unavailable.
"""

import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

import numpy as np
import pytest
from conftest import REFERENCE_TREE, require_reference_tree

from pyrecode_tpu import InputParams
from pyrecode_tpu.reader import merge_parts
from pyrecode_tpu.writer import ReCoDeWriter

_REF = REFERENCE_TREE  # conftest.py: the tree PYRECODE_REFERENCE names, or None


def _build_reference_extension():
    require_reference_tree()
    build_dir = Path(tempfile.gettempdir()) / "pyrecode_ref_ext"
    so = build_dir / "c_recode.so"
    if not so.exists():
        build_dir.mkdir(exist_ok=True)
        shutil.copy(_REF / "pyrecode" / "pyrecode.cpp", build_dir)
        shutil.copy(_REF / "pyrecode" / "c_extensions" / "reader.h", build_dir)
        inc = sysconfig.get_paths()["include"]
        result = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", f"-I{inc}", f"-I{build_dir}",
             str(build_dir / "pyrecode.cpp"), "-o", str(so)],
            capture_output=True)
        if result.returncode != 0:
            pytest.skip(f"cannot build reference extension: {result.stderr[-300:]}")
    return str(build_dir)


@pytest.fixture(scope="module")
def reference_reader():
    ext_dir = _build_reference_extension()
    sys.path.insert(0, ext_dir)
    sys.path.insert(0, str(_REF))
    try:
        from pyrecode.recode_reader import ReCoDeReader as RefReader
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference reader unimportable: {e}")
    return RefReader


@pytest.mark.parametrize("fast_deflate", [False, True])
def test_reference_decodes_our_container(tmp_path, reference_reader, fast_deflate):
    rng = np.random.default_rng(0)
    data = np.where(rng.random((4, 128, 128)) < 0.02,
                    rng.integers(1, 4096, (4, 128, 128)), 0).astype(np.uint16)
    dark = np.zeros((128, 128), np.uint16)
    params = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=128, num_rows=128,
        num_frames=4, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=2,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
        target_data_type=0))
    assert params.validate()

    for node_id in range(2):
        w = ReCoDeWriter("interop", dark_data=dark, output_directory=str(tmp_path),
                         input_params=params, node_id=node_id,
                         fast_deflate=fast_deflate)
        w.start()
        w.run(data)
        w.close()
    merged = merge_parts(str(tmp_path), "interop.rc1", 2)

    reader = reference_reader(merged, is_intermediate=False)
    reader.open(print_header=False)
    for _ in range(4):
        fd = reader.get_next_frame()
        frame_id = next(iter(fd.keys()))
        assert np.array_equal(np.asarray(fd[frame_id]["data"].todense()),
                              data[frame_id]), frame_id
    reader.close()


def test_reference_reads_our_intermediate_part(tmp_path, reference_reader):
    rng = np.random.default_rng(1)
    data = np.where(rng.random((3, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (3, 64, 64)), 0).astype(np.uint16)
    dark = np.zeros((64, 64), np.uint16)
    params = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64,
        num_frames=3, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=1,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
        target_data_type=0))
    assert params.validate()
    w = ReCoDeWriter("partio", dark_data=dark, output_directory=str(tmp_path),
                     input_params=params)
    w.start()
    w.run(data)
    w.close()

    reader = reference_reader(str(tmp_path / "partio.rc1_part000"), is_intermediate=True)
    reader.open(print_header=False)
    for i in range(3):
        fd = reader.get_next_frame()
        frame_id = next(iter(fd.keys()))
        assert frame_id == i
        assert np.array_equal(np.asarray(fd[frame_id]["data"].todense()), data[i])
    reader.close()
