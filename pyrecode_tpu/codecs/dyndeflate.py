"""numpy reference of the native sparse-deflate encoder (scheme 0).

:func:`deflate_dyn_np` reproduces the native dynamic-Huffman encoder
(native/recode_host.cpp deflate_sparse_dyn) *byte for byte*: same repeat-run
tokenization, same canonical Huffman construction (tables come from the same
C code via :func:`pyrecode_tpu.native.dyn_tables`), same RFC 1951 dynamic
block header, same stored-block fallback rule, same adler32 trailer.  The
tokenizer is shared with the scheme-12 rANS codec (codecs/rans.py).

The tokenizer is written as per-byte data-parallel math: every input byte
emits AT MOST ONE token, decidable from
 * ``p``  — offset within its run (needs only a *backward* scan), and
 * ``d``  — distance to the run's end (needs only a *bounded, <=521-byte
   forward* window, because the C encoder's take-adjustment only perturbs the
   last two matches of a run).

Rules (mirroring deflate_sparse_dyn's tokenizer exactly):
 * run length < 4          -> every byte is a literal
 * p == 0                  -> literal (the run's leading literal)
 * p >= 1, run >= 4, q = p-1:
     q % 258 == 0 and d >= 261          -> match take=258
     q % 258 == 0 and d in {259, 260}   -> match take=255   (keep tail >= 3)
     q % 258 == 0 and 3 <= d <= 258     -> match take=d     (final take)
     q % 258 == 255 and d in {4, 5}     -> match take=d     (post-255 tail)
     otherwise                          -> no token (covered by a match)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# RFC 1951 length-code table: codes 257+c encode match lengths
# [LEN_BASE[c], LEN_BASE[c+1]) with LEN_EXTRA[c] extra bits
LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
                    dtype=np.int32)
LEN_EXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3,
                      3, 4, 4, 4, 4, 5, 5, 5, 5, 0], dtype=np.int32)

# LUT layout: idx 0..255 = literal byte, 256..511 = match take (3 + idx-256),
# 512 = no token.  (take 258 -> idx 511.)
LUT_SIZE = 513
NO_TOKEN = 512


# byte-wise bit-reversal LUT: rev16(x) = REV8[x & 255] << 8 | REV8[x >> 8]
_REV8 = np.zeros(256, dtype=np.uint32)
for _i in range(256):
    _REV8[_i] = int(f"{_i:08b}"[::-1], 2)


def bit_reverse(codes: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Reverse the low ``nbits`` bits of each code (Huffman codes are written
    MSB-first into an LSB-first stream).  Codes are <= 16 bits; a byte LUT
    reverses the full 16-bit word, then a shift drops the unused high bits.
    """
    codes = np.asarray(codes, dtype=np.uint32)
    nbits = np.asarray(nbits, dtype=np.uint32)
    rev16 = (_REV8[codes & 255] << 8) | _REV8[codes >> 8]
    return np.where(nbits > 0, rev16 >> (16 - nbits), 0).astype(np.uint32)


def length_code(take: np.ndarray) -> np.ndarray:
    """Length-code index c (0..28) for match length 3..258."""
    return (np.searchsorted(LEN_BASE, np.asarray(take, dtype=np.int32),
                            side="right") - 1).astype(np.int32)


def token_luts(llen: np.ndarray, lcode: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(value, bit-count) LUTs for every possible token, from Huffman tables.

    A literal's value is its bit-reversed code; a match's value packs
    rev(length code) | extra_value << len | 0 (the 1-bit distance code).
    """
    llen = np.asarray(llen, dtype=np.int64)
    lcode = np.asarray(lcode, dtype=np.int64)
    val = np.zeros(LUT_SIZE, dtype=np.uint32)
    bits = np.zeros(LUT_SIZE, dtype=np.int32)
    # literals
    val[:256] = bit_reverse(lcode[:256], llen[:256])
    bits[:256] = llen[:256]
    # matches: take in [3, 258]
    take = np.arange(3, 259, dtype=np.int32)
    c = length_code(take)
    sym = 257 + c
    eb = LEN_EXTRA[c]
    ev = take - LEN_BASE[c]
    rev = bit_reverse(lcode[sym], llen[sym])
    val[256:512] = rev | (ev.astype(np.uint32) << llen[sym].astype(np.uint32))
    bits[256:512] = llen[sym] + eb + 1  # + distance code (1 bit, value 0)
    return val, bits


# --------------------------------------------------------------- tokenization


def tokenize_bytes_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-byte token decision (see the rules in the module docstring).

    Returns (lut_idx i32[n], sym i32[n]): the token LUT index per byte
    (NO_TOKEN for covered bytes) and the literal/length symbol (0..285, or -1
    for covered bytes) for histogramming.
    """
    x = np.asarray(x, dtype=np.uint8)
    n = x.size
    if n == 0:
        return (np.zeros(0, np.int32),) * 2
    # int32 throughout: n < 2^31 by the container format, and the narrower
    # lanes roughly halve this oracle's wall time (it sits on every numpy
    # codec path and most entropy tests)
    idx = np.arange(n, dtype=np.int32)
    change = np.ones(n, dtype=bool)
    change[1:] = x[1:] != x[:-1]
    # s: index of this byte's run start (last change at or before i)
    s = np.maximum.accumulate(np.where(change, idx, -1).astype(np.int32))
    # e: run end (next change after i, or n)
    starts = np.flatnonzero(change).astype(np.int32)
    run_of = np.cumsum(change, dtype=np.int32)
    run_of -= 1                              # run ordinal per byte
    ends = np.append(starts[1:], np.int32(n))
    e = ends[run_of]
    p = idx - s
    d = e - idx
    run = e - s

    is_lit = (p == 0) | (run < 4)
    q = p - 1
    qm = q % np.int32(258)
    m0 = (qm == 0) & ~is_lit
    take = np.where(d >= 261, np.int32(258),
                    np.where(d >= 259, np.int32(255), d))
    is_match0 = m0 & (d >= 3)
    is_match255 = (qm == 255) & ~is_lit & ((d == 4) | (d == 5))
    take = np.where(is_match255, d, take)
    is_match = is_match0 | is_match255

    lut_idx = np.full(n, NO_TOKEN, dtype=np.int32)
    lut_idx[is_lit] = x[is_lit]
    lut_idx[is_match] = (256 + take[is_match] - 3).astype(np.int32)

    sym = np.full(n, -1, dtype=np.int32)
    sym[is_lit] = x[is_lit]
    sym[is_match] = 257 + length_code(take[is_match])
    return lut_idx, sym


def histogram_np(sym: np.ndarray) -> np.ndarray:
    """286-symbol literal/length frequency table (EOB included)."""
    freq = np.bincount(sym[sym >= 0], minlength=286).astype(np.uint32)
    freq[256] += 1  # end of block
    return freq


# ------------------------------------------------------------------- assembly


def assemble_bits_np(vals: np.ndarray, nbits: np.ndarray, phase: int = 0,
                     first_partial: int = 0) -> Tuple[np.ndarray, int]:
    """Pack variable-length LSB-first tokens into a byte stream.

    ``phase`` is the starting bit offset within the first byte (the tail of a
    preceding header) whose already-written bits are ``first_partial``.
    Returns (bytes, total_bits) with total_bits counted from the start of the
    first byte.
    """
    vals = np.asarray(vals, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    offs = phase + np.concatenate([[0], np.cumsum(nbits)[:-1]]) if nbits.size \
        else np.zeros(0, np.int64)
    total = int(phase + nbits.sum())
    nbytes = max((total + 7) // 8, 1 if phase else 0)
    out = np.zeros(max(nbytes, 1), dtype=np.uint8)
    if vals.size:
        sv = vals << (offs & 7).astype(np.uint64)
        tgt = offs >> 3
        for k in range(4):
            contrib = ((sv >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8)
            t = np.minimum(tgt + k, max(nbytes - 1, 0))
            np.add.at(out, t, contrib)
    out = out[:nbytes]
    if phase and nbytes:
        out[0] |= np.uint8(first_partial)
    return out, total


def stored_blocks(raw: bytes, n: int) -> bytes:
    """RFC 1951 stored (btype 00) blocks wrapping ``raw[:n]`` + zlib header."""
    pieces = [b"\x78\x01"]
    k = 0
    while True:
        take = min(n - k, 65535)
        final = 1 if k + take >= n else 0
        pieces.append(bytes([final, take & 0xFF, take >> 8,
                             (~take) & 0xFF, ((~take) >> 8) & 0xFF]))
        pieces.append(raw[k: k + take])
        k += take
        if k >= n:
            break
    return b"".join(pieces)


def finish_stream(hdr_bytes: np.ndarray, hdr_bits: int, body: np.ndarray,
                  body_bits: int, adler: int, n: int,
                  raw: Optional[bytes] = None) -> bytes:
    """Assemble the final zlib stream from header + packed body.

    ``body`` starts at the header's last partial byte (bit offset
    ``hdr_bits % 8`` within its first byte) and already contains the
    end-of-block code; ``body_bits`` counts from that byte's bit 0.  Applies
    the same stored-block fallback rule as the native encoder (raw bytes
    required for it) and appends the big-endian adler32.
    """
    full_hdr = hdr_bytes[: hdr_bits // 8].tobytes()
    stream = full_hdr + body[: (body_bits + 7) // 8].tobytes()
    stored_size = 2 + n + 5 * (n // 65535 + 1)
    if len(stream) > stored_size and raw is not None:
        stream = stored_blocks(raw, n)
    return stream + int(adler).to_bytes(4, "big")


def deflate_dyn_np(data: bytes) -> bytes:
    """Full numpy reference pipeline; byte-identical to
    ``native.deflate_sparse`` (the dynamic-Huffman encoder)."""
    import zlib

    from .. import native

    x = np.frombuffer(bytes(data), dtype=np.uint8)
    n = x.size
    lut_idx, sym = tokenize_bytes_np(x)
    lfreq = histogram_np(sym)
    llen, lcode = native.dyn_tables(lfreq)
    hdr_bytes, hdr_bits = native.dyn_header(llen)
    val_lut, bits_lut = token_luts(llen, lcode)

    tok = lut_idx[lut_idx != NO_TOKEN]
    vals = val_lut[tok].astype(np.uint64)
    nbits = bits_lut[tok].astype(np.int64)
    # end of block as a final token
    vals = np.append(vals, int(bit_reverse(lcode[256:257], llen[256:257])[0]))
    nbits = np.append(nbits, int(llen[256]))

    phase = hdr_bits % 8
    partial = int(hdr_bytes[-1]) if phase else 0
    body, body_bits = assemble_bits_np(vals, nbits, phase, partial)
    adler = zlib.adler32(bytes(data))
    return finish_stream(hdr_bytes, hdr_bits, body, body_bits, adler, n,
                         raw=bytes(data))
