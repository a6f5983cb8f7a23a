"""Container-surface fuzzing: corrupt/truncated files must fail CLEAN.

The reference reader trusts header bytes and u32 metadata arithmetic and
crashes (or allocates unboundedly) on corrupt input
(recode_reader.py:39-168).  Our reader validates untrusted bytes before
they size any buffer or drive any loop: every test here asserts that a
hostile container raises an ordinary exception — never hangs, never
OOMs, never returns silently wrong region sizes.

"Clean" failure = one of the exception types in _CLEAN below.  A decode
that *succeeds* is also acceptable when the corrupted byte lands in a
region that does not affect the frames being read (e.g. padding,
compressed payload of a later frame).
"""

import struct
import zlib

import numpy as np
import pytest

from pyrecode_tpu.header import ReCoDeHeader
from pyrecode_tpu.reader import ReCoDeReader, merge_parts

from test_roundtrip import _fixture, _params, _write_parts

# exception types a hostile container is allowed to surface.  lzma/bz2
# style codecs raise their own error types but this fixture is zlib.
_CLEAN = (ValueError, OSError, EOFError, KeyError, ImportError,
          IndexError, struct.error, zlib.error, OverflowError)


@pytest.fixture(scope="module")
def container(tmp_path_factory):
    """One small merged L1+zlib container; returns (path, pristine bytes)."""
    tmp = tmp_path_factory.mktemp("fuzz")
    data = _fixture(shape=(6, 64, 64), seed=7)
    dark = np.zeros(data.shape[1:], np.uint16)
    params = _params(data.shape, num_threads=2)
    _write_parts(tmp, data, dark, params, use_device=False)
    merged = merge_parts(str(tmp), "test_data.rc1", 2)
    with open(merged, "rb") as f:
        return merged, f.read(), data


def _try_read(path):
    """Open + full sequential read.  Returns frames or raises."""
    reader = ReCoDeReader(str(path), is_intermediate=False)
    reader.open()
    try:
        out = []
        nz = reader.get_shape()[0]
        for z in range(nz):
            out.append(reader.get_frame(z))
        return out
    finally:
        reader.close()


def _expect_clean(tmp_path, blob, name="corrupt.rc1"):
    """Write blob, read it; success or a _CLEAN exception both pass."""
    p = tmp_path / name
    p.write_bytes(blob)
    try:
        _try_read(p)
    except _CLEAN:
        pass
    return p


def _field_pos(pristine, name):
    hdr = ReCoDeHeader()
    import io

    hdr.load_from(io.BytesIO(pristine))
    return hdr.get_field_position_in_bytes(name), hdr


def test_pristine_fixture_reads(container):
    path, blob, data = container
    frames = _try_read(path)
    assert len(frames) == data.shape[0]


def test_truncation_everywhere(container, tmp_path):
    """Truncate at every region boundary and a sweep of interior points."""
    _, blob, _ = container
    n = len(blob)
    boundaries = {0, 1, 9, 10, 321, 511, 512, n - 1}
    # metadata table spans [512, 512 + nz*12) for L1 mode 1 (3 u32/frame)
    boundaries |= {512 + 12 * k for k in range(7)}
    # interior sweep
    boundaries |= {int(n * f) for f in np.linspace(0.05, 0.99, 16)}
    for cut in sorted(b for b in boundaries if 0 <= b < n):
        _expect_clean(tmp_path, blob[:cut], name=f"trunc_{cut}.rc1")


def test_corrupt_every_u32_length_field(container, tmp_path):
    """Each per-frame u32 length field, set to huge and to junk values."""
    _, blob, _ = container
    meta_start = 512  # no source header, no non-standard metadata
    nz = 6
    for frame in range(nz):
        for field in range(3):  # len_cbm, len_cpx, len_packed
            off = meta_start + frame * 12 + field * 4
            for val in (0xFFFFFFFF, 0x7FFFFFFF, 1, 0):
                b = bytearray(blob)
                b[off: off + 4] = val.to_bytes(4, "little")
                _expect_clean(tmp_path, bytes(b),
                              name=f"meta_{frame}_{field}_{val}.rc1")


def test_oversized_nz_fails_fast(container, tmp_path):
    """nz = 4e9 must raise before sizing the seek table / metadata loop."""
    _, blob, _ = container
    pos, _ = _field_pos(blob, "nz")
    b = bytearray(blob)
    b[pos: pos + 4] = (0xFFFFFFFF).to_bytes(4, "little")
    p = tmp_path / "huge_nz.rc1"
    p.write_bytes(bytes(b))
    with pytest.raises(_CLEAN):
        _try_read(p)


def test_header_byte_flips(container, tmp_path):
    """Flip scheme/level/mode/dtype/depth header bytes to hostile values."""
    _, blob, _ = container
    cases = [
        ("compression_scheme", 200), ("compression_scheme", 13),
        ("reduction_level", 0), ("reduction_level", 9),
        ("rc_operation_mode", 7),
        ("target_dtype", 250), ("source_dtype", 251),
        ("target_bit_depth", 0), ("target_bit_depth", 255),
        ("ny", 0), ("nx", 0),
        ("source_header_length", 0xFFFF),
        ("num_non_standard_frame_metadata", 0xFFFFFFFF),
    ]
    for name, val in cases:
        pos, hdr = _field_pos(blob, name)
        nbytes = hdr.get_definition(name)["bytes"]
        b = bytearray(blob)
        val &= (1 << (8 * nbytes)) - 1   # clamp to the field's width
        b[pos: pos + nbytes] = int(val).to_bytes(nbytes, "little")
        _expect_clean(tmp_path, bytes(b), name=f"hdr_{name}_{val}.rc1")


def test_version_garbage(container, tmp_path):
    """Unknown container versions are rejected, not mis-parsed."""
    _, blob, _ = container
    for major, minor in ((7, 3), (0, 0), (255, 255)):
        b = bytearray(blob)
        b[8], b[9] = major, minor
        p = tmp_path / f"ver_{major}_{minor}.rc1"
        p.write_bytes(bytes(b))
        with pytest.raises(_CLEAN):
            _try_read(p)


def test_not_a_recode_file(tmp_path):
    for blob in (b"", b"\x00" * 4, b"MZ" + b"\x90" * 600,
                 b"\xff" * 512):
        p = tmp_path / "junk.rc1"
        p.write_bytes(blob)
        with pytest.raises(_CLEAN):
            _try_read(p)


def test_random_single_byte_flips(container, tmp_path):
    """Seeded random single-byte corruption over the whole file: 200
    trials, every one either reads or raises clean (bounded time comes
    from the validation guards — a hang here fails the suite timeout)."""
    _, blob, _ = container
    rng = np.random.default_rng(42)
    n = len(blob)
    for t in range(200):
        off = int(rng.integers(0, n))
        b = bytearray(blob)
        b[off] ^= int(rng.integers(1, 256))
        _expect_clean(tmp_path, bytes(b), name="flip.rc1")


def test_intermediate_flag_mismatch(container, tmp_path):
    """Opening a merged file as intermediate and vice versa fails clean."""
    path, blob, _ = container
    r = ReCoDeReader(str(path), is_intermediate=True)
    try:
        r.open()
        # sequential reads on a mis-flagged file may return garbage ids or
        # None; they must not hang or crash uncleanly
        r.get_next_frame()
    except _CLEAN:
        pass
    finally:
        r.close()
