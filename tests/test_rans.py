"""rANS codec (scheme 12): numpy reference vs native, container use.

The interleaved-rANS entropy backend is the zstd-class member of the
entropy matrix (SURVEY.md §7 step 5); the numpy coder is the reference for
the native one (native/recode_host.cpp), and both decode every flavour.
"""

import numpy as np
import pytest

from pyrecode_tpu import native
from pyrecode_tpu.codecs import rans


def _stream(n, density, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, n)
            * (rng.random(n) < density)).astype(np.uint8).tobytes()


def test_numpy_roundtrip_and_edges():
    cases = [b"", b"\x00" * 10000, b"A" + b"\x00" * 520 + b"B",
             _stream(30000, 0.02), _stream(30000, 0.5),
             bytes(np.random.default_rng(1).integers(0, 256, 9000,
                                                     ).astype(np.uint8))]
    for i, raw in enumerate(cases):
        assert rans.decompress(rans.compress(raw)) == raw, i


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_byte_identical_and_cross_decode():
    rng = np.random.default_rng(3)
    for t in range(12):
        n = int(rng.integers(0, 50000))
        dens = float(rng.choice([0.0, 0.01, 0.2, 0.9]))
        raw = (rng.integers(0, 256, n)
               * (rng.random(n) < dens)).astype(np.uint8).tobytes()
        c_np = rans.compress(raw)
        c_cc = native.rans_compress(raw)
        assert c_np == c_cc, t
        assert native.rans_decompress(c_np) == raw
        assert rans.decompress(c_cc) == raw


def test_beats_zlib1_on_representative_streams():
    """Size sanity on the codec's target workloads (cf. the BASELINE
    compressed-size requirement for the default scheme)."""
    import zlib

    rng = np.random.default_rng(7)
    n = 1 << 18
    dense_tokens = bytes(rng.integers(0, 4, n).astype(np.uint8))
    mixed = (rng.integers(0, 256, n)
             * (rng.random(n) < 0.3)).astype(np.uint8).tobytes()
    for raw in (dense_tokens, mixed):
        assert len(rans.compress(raw)) < len(zlib.compress(raw, 1))


def test_container_roundtrip_scheme12(tmp_path):
    """Writer -> merge -> reader with compression_scheme=12."""
    from pyrecode_tpu import InputParams
    from pyrecode_tpu.reader import ReCoDeReader, merge_parts
    from pyrecode_tpu.writer import ReCoDeWriter

    rng = np.random.default_rng(5)
    data = np.where(rng.random((4, 128, 128)) < 0.03,
                    rng.integers(1, 4096, (4, 128, 128)), 0).astype(np.uint16)
    dark = np.zeros((128, 128), np.uint16)
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=128, num_rows=128,
        num_frames=4, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=1,
        l2_statistics=0, l4_centroiding=0, compression_scheme=12,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0)
    p = InputParams(values)
    assert p.validate()
    w = ReCoDeWriter("r12", dark_data=dark, output_directory=str(tmp_path),
                     input_params=p, mode="batch", node_id=0, use_device=False)
    w.start()
    w.run(data)
    w.close()
    merged = merge_parts(str(tmp_path), "r12.rc1", 1)
    r = ReCoDeReader(merged)
    r.open()
    for i in range(4):
        fd = r.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i]), i
    r.close()
    # bulk path too (pooled decode excludes scheme 12's... include check)
    r = ReCoDeReader(merged)
    r.open()
    dense = r.read_frames_dense(0, 4, use_device=False)
    assert np.array_equal(dense, data)
    r.close()


def test_writer_device_entropy_scheme12(tmp_path):
    """The device-encode writer with scheme 12 produces containers
    byte-identical to the oracle-path writer, and they decode bit-exactly."""
    from pyrecode_tpu import InputParams
    from pyrecode_tpu.reader import ReCoDeReader, merge_parts
    from pyrecode_tpu.writer import ReCoDeWriter

    rng = np.random.default_rng(6)
    data = np.where(rng.random((3, 64, 64)) < 0.04,
                    rng.integers(1, 4096, (3, 64, 64)), 0).astype(np.uint16)
    dark = np.zeros((64, 64), np.uint16)
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64,
        num_frames=3, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=1,
        l2_statistics=0, l4_centroiding=0, compression_scheme=12,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0)
    p = InputParams(values)
    assert p.validate()
    outs = {}
    for sub, use_device in (("dev", True), ("host", False)):
        d = tmp_path / sub
        d.mkdir()
        w = ReCoDeWriter("r12", dark_data=dark, output_directory=str(d),
                         input_params=p, mode="batch", node_id=0,
                         use_device=use_device)
        w.start()
        w.run(data)
        w.close()
        outs[sub] = merge_parts(str(d), "r12.rc1", 1)
    with open(outs["dev"], "rb") as a, open(outs["host"], "rb") as b:
        assert a.read() == b.read()
    r = ReCoDeReader(outs["dev"])
    r.open()
    for i in range(3):
        fd = r.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i]), i
    r.close()


def test_reader_bulk_device_decode_scheme12(tmp_path):
    """read_frames_dense decodes scheme-12 streams with the host rANS coder
    and rebuilds the dense frames with the device L1 decode."""
    from pyrecode_tpu import InputParams
    from pyrecode_tpu.reader import ReCoDeReader, merge_parts
    from pyrecode_tpu.writer import ReCoDeWriter

    rng = np.random.default_rng(8)
    data = np.where(rng.random((5, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (5, 64, 64)), 0).astype(np.uint16)
    dark = np.zeros((64, 64), np.uint16)
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64,
        num_frames=5, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=1,
        l2_statistics=0, l4_centroiding=0, compression_scheme=12,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0)
    p = InputParams(values)
    assert p.validate()
    w = ReCoDeWriter("r12", dark_data=dark, output_directory=str(tmp_path),
                     input_params=p, mode="batch", node_id=0, use_device=False)
    w.start()
    w.run(data)
    w.close()
    merged = merge_parts(str(tmp_path), "r12.rc1", 1)
    r = ReCoDeReader(merged)
    r.open()
    dense = r.read_frames_dense(0, 5, use_device=True)
    assert np.array_equal(dense, data)
    r.close()


def test_corrupt_streams_rejected():
    """Truncated or bit-flipped streams must raise/fail in every decoder —
    never read out of bounds or return silently-wrong bytes."""
    rng = np.random.default_rng(10)
    raw = (rng.integers(0, 256, 20000)
           * (rng.random(20000) < 0.05)).astype(np.uint8).tobytes()
    good = rans.compress(raw)

    def native_fails(blob):
        if not native.available():
            return True
        try:
            return native.rans_decompress(blob) != raw
        except ValueError:
            return True

    def numpy_fails(blob):
        try:
            return rans.decompress(blob) != raw
        except ValueError:
            return True

    cases = [
        good[:10],                        # truncated header
        good[:40],                        # truncated freq table
        good[: len(good) // 2],           # truncated body
        bytes([good[0], good[1], 31]) + good[3:],   # absurd lane count
    ]
    # bit flips through header/table/body/xbits
    for off in (2, 5, 9, 25, 60, len(good) // 2, len(good) - 6):
        cases.append(good[:off] + bytes([good[off] ^ 0x40])
                     + good[off + 1:])
    for i, blob in enumerate(cases):
        assert numpy_fails(blob), ("numpy accepted corrupt stream", i)
        assert native_fails(blob), ("native accepted corrupt stream", i)
    # and the good stream still decodes everywhere
    assert rans.decompress(good) == raw
    if native.available():
        assert native.rans_decompress(good) == raw


def test_stored_fallback_never_inflates():
    """The coded stream is only kept when strictly smaller than the stored
    encoding (n + 24 bytes)."""
    rng = np.random.default_rng(11)
    for n in (0, 1, 10, 300, 5000):
        raw = bytes(rng.integers(0, 256, n).astype(np.uint8))
        enc = rans.compress(raw)
        assert len(enc) <= n + 24, (n, len(enc))
        if native.available():
            assert native.rans_compress(raw) == enc, n


class TestSymbolMode:
    """Direct-symbol rANS (flags bit1): pixel values coded as bit_depth-wide
    symbols instead of bytes of the packed stream (VERDICT r2 missing #4)."""

    def test_roundtrip_distributions(self):
        from pyrecode_tpu import oracle
        from pyrecode_tpu.codecs import rans

        rng = np.random.default_rng(0)
        cases = [
            (np.minimum(1 + np.floor(rng.exponential(4.0, 3000)), 4095), 12),
            (np.minimum(1 + np.floor(rng.exponential(30.0, 500)), 4095), 12),
            (rng.integers(0, 1 << 10, 2000), 10),
            (rng.integers(0, 1 << 16, 1000), 16),
            (np.zeros(100), 12),
            (np.array([5]), 12),
            (np.zeros(0), 12),
        ]
        for vals, bits in cases:
            raw = oracle.bit_pack(vals.astype(np.uint64), bits).tobytes()
            s = rans.compress_symbols(raw, bits)
            assert rans.decompress(s) == raw, (bits, len(vals))

    def test_beats_byte_mode_on_peaked(self):
        from pyrecode_tpu import oracle
        from pyrecode_tpu.codecs import rans

        rng = np.random.default_rng(1)
        vals = np.minimum(1 + np.floor(rng.exponential(6.0, 20000)), 4095)
        raw = oracle.bit_pack(vals.astype(np.uint64), 12).tobytes()
        sym = rans.compress_symbols(raw, 12)
        byte = rans.compress(raw)
        assert sym[3] & 2, "symbol mode should engage on peaked residuals"
        assert len(sym) < 0.8 * len(byte)
        import zlib

        assert len(sym) < len(zlib.compress(raw, 6))

    def test_native_shim_routes_symbol_streams(self):
        from pyrecode_tpu import native, oracle
        from pyrecode_tpu.codecs import rans

        rng = np.random.default_rng(2)
        vals = np.minimum(1 + np.floor(rng.exponential(5.0, 4000)), 4095)
        raw = oracle.bit_pack(vals.astype(np.uint64), 12).tobytes()
        s = rans.compress_symbols(raw, 12)
        assert s[3] & 2
        assert native.rans_decompress(s) == raw

    def test_corrupt_symbol_streams_raise(self):
        from pyrecode_tpu import oracle
        from pyrecode_tpu.codecs import rans

        rng = np.random.default_rng(3)
        vals = np.minimum(1 + np.floor(rng.exponential(5.0, 2000)), 4095)
        raw = oracle.bit_pack(vals.astype(np.uint64), 12).tobytes()
        s = bytearray(rans.compress_symbols(raw, 12))
        assert s[3] & 2
        for mut in (len(s) // 2, len(s) - 2, 25):
            bad = bytearray(s)
            bad[mut] ^= 0x40
            with pytest.raises(ValueError):
                rans.decompress(bytes(bad))
        with pytest.raises(ValueError):
            rans.decompress(bytes(s[: len(s) // 2]))

    def test_writer_scheme12_codes_pixvals_as_symbols(self, tmp_path):
        """The scheme-12 host path codes the pixval stream in symbol mode on
        peaked residuals and the container round-trips bit-exactly."""
        from pyrecode_tpu import InputParams, oracle
        from pyrecode_tpu.reader import ReCoDeReader, merge_parts
        from pyrecode_tpu.writer import ReCoDeWriter

        data = oracle.synthetic_frames(3, 64, 64, 0.05, 12, "peaked", rng=9)
        values = dict(
            reduction_level=1, rc_operation_mode=1,
            calibration_threshold_epsilon=0, target_bit_depth=12,
            source_bit_depth=12, num_cols=64, num_rows=64, num_frames=3,
            frame_offset=0, num_calibration_frames=1,
            calibration_frame_offset=0, keep_part_files=1, num_threads=1,
            l2_statistics=0, l4_centroiding=0, compression_scheme=12,
            compression_level=1, source_file_type=0, source_header_length=0,
            keep_calibration_data=1, calibration_file_type=0,
            source_data_type=0, target_data_type=0)
        p = InputParams(values)
        assert p.validate()
        w = ReCoDeWriter("sym", dark_data=np.zeros((64, 64), np.uint16),
                         output_directory=str(tmp_path), input_params=p)
        w.start()
        w.run(data)
        w.close()
        merge_parts(str(tmp_path), "sym.rc1", 1)
        r = ReCoDeReader(str(tmp_path / "sym.rc1"))
        r.open()
        for i in range(3):
            fd = r.get_next_frame()
            assert np.array_equal(fd[i]["data"].todense(), data[i]), i
        r.close()


# ------------------------------------------------------------- gap mode


def test_gap_transform_roundtrip():
    rng = np.random.default_rng(11)
    for occ in (0.0, 0.001, 0.01, 0.3, 1.0):
        bits = rng.random(64 * 1024) < occ
        bm = np.packbits(bits, bitorder="little")
        syms = rans.bitmap_to_gaps(bm)
        assert rans.gaps_to_bitmap(syms, bm.size) == bm.tobytes()
        # every literal < escape, escapes only where runs >= 4095
        lits = syms[syms != rans.GAP_ESCAPE]
        assert (lits < rans.GAP_ESCAPE).all()
        assert syms.size == int(bits.sum()) + int(
            ((np.diff(np.concatenate([[-1], np.flatnonzero(bits)])) - 1)
             // rans.GAP_ESCAPE).sum())


def test_gap_escape_runs():
    # runs of exactly 4095, 4096 and ~3x escape length between set bits
    bits = np.zeros(32768, np.uint8)
    bits[[0, 4096, 8192 + 4095, 8192 + 4095 + 4096 + 12285 + 1]] = 1
    bm = np.packbits(bits, bitorder="little")
    syms = rans.bitmap_to_gaps(bm)
    assert rans.gaps_to_bitmap(syms, bm.size) == bm.tobytes()
    stream = rans.compress_gaps(bm.tobytes())
    assert rans.decompress(stream) == bm.tobytes()


def test_gap_stream_roundtrip_all_paths():
    rng = np.random.default_rng(12)
    bits = rng.random(256 * 1024) < 0.01
    bm = np.packbits(bits, bitorder="little").tobytes()
    stream = rans.compress_gaps(bm)
    assert stream[3] == 6          # flags: symbol | gap
    assert rans.decompress(stream) == bm
    if native.available():
        assert native.rans_decompress(stream) == bm
        # numpy and native encoders emit byte-identical streams
        avail = native.available
        try:
            native.available = lambda: False
            np_stream = rans.compress_gaps(bm)
        finally:
            native.available = avail
        assert np_stream == stream


def test_gap_fallbacks():
    # empty bitmap -> byte-symbol mode; dense random -> byte/stored mode
    s_empty = rans.compress_gaps(b"\x00" * 2048)
    assert s_empty[3] != 6 and rans.decompress(s_empty) == b"\x00" * 2048
    rng = np.random.default_rng(13)
    dense = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    s_dense = rans.compress_gaps(dense)
    assert rans.decompress(s_dense) == dense


def test_gap_corrupt_rejected():
    rng = np.random.default_rng(14)
    bits = rng.random(1024 * 1024) < 0.05
    bm = np.packbits(bits, bitorder="little").tobytes()
    stream = bytearray(rans.compress_gaps(bm))
    assert stream[3] == 6
    # flip a body byte: decoded positions must either overrun (ValueError)
    # or fail the adler check — never return wrong bytes silently
    stream[len(stream) - 20] ^= 0xFF
    with pytest.raises(ValueError):
        rans.decompress(bytes(stream))
    if native.available():
        with pytest.raises(ValueError):
            native.rans_decompress(bytes(stream))
