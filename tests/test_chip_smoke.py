"""chip_smoke.py: refuses to run without a GPU, and its phases, rehearsed
here at 64^2 on the CPU, hold the served path to the oracle."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_inputs_are_seeded_and_thresholded():
    frames, dark = chip_smoke.make_inputs(9, 64, seed=4)
    again, dark2 = chip_smoke.make_inputs(9, 64, seed=4)
    assert np.array_equal(frames, again) and np.array_equal(dark, dark2)
    assert dark.any() and (frames >= dark).all()
    thr = chip_smoke.threshold_of(dark)
    fg = frames > thr
    assert 0.002 < fg.mean() < 0.01     # 1% occupancy, values <= epsilon drop
    assert np.array_equal(chip_smoke.expected_dense(frames, thr)[fg],
                          (frames - thr)[fg])


@pytest.mark.parametrize("label,kw", [
    ("L1 scheme 0", {}),
    ("L1 scheme 12", {"scheme": 12}),
    ("L2 sum", {"level": 2, "l2_statistics": 2}),
    ("L4 weighted", {"level": 4, "l4_centroiding": 0}),
])
def test_served_phase(tmp_path, label, kw):
    frames, dark = chip_smoke.make_inputs(7, 64, seed=1)
    compiled = chip_smoke.phase_served(frames, dark, tmp_path, label, **kw)
    assert compiled.memory_analysis() is not None


def test_served_phase_catches_a_wrong_container(tmp_path, monkeypatch):
    """A device path that drifts from the oracle must fail the phase."""
    from pyrecode_tpu.writer import ReCoDeWriter

    real = ReCoDeWriter._materialize_streams

    def corrupt(self, dispatched):
        streams = real(self, dispatched)
        if dispatched[0] == "device":
            bitmap, pixvals = streams[0]
            streams[0] = (bytes([bitmap[0] ^ 1]) + bitmap[1:], pixvals)
        return streams

    monkeypatch.setattr(ReCoDeWriter, "_materialize_streams", corrupt)
    frames, dark = chip_smoke.make_inputs(6, 64, seed=2)
    with pytest.raises(AssertionError, match="differs from the oracle path"):
        chip_smoke.phase_served(frames, dark, tmp_path, "L1 scheme 0")


def test_ops_phase(capsys):
    frames, dark = chip_smoke.make_inputs(chip_smoke.BATCH, 64, seed=3)
    chip_smoke.phase_ops(frames, dark, peak=3.35e12)
    out = capsys.readouterr().out
    for op in ("encode_frames L1", "encode_frames L2", "encode_frames L4",
               "decode_l1_frames", "bitpack_values", "bitunpack_values"):
        assert f"[op {op}" in out, op


def test_four_cards_phase(capsys):
    """The sharded phase on four of the eight virtual CPU devices."""
    frames, dark = chip_smoke.make_inputs(32, 64, seed=5)
    chip_smoke.phase_four_cards(frames, dark, n_devices=4)
    assert "byte-identical to the one-device encode" in capsys.readouterr().out

