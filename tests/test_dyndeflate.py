"""Byte-parity tests for the data-parallel deflate re-formulation.

The per-byte tokenization in codecs/dyndeflate.py (shared with the scheme-12
rANS coder) must reproduce native deflate_sparse_dyn's sequential run
loop byte-for-byte — including the take-adjustment that keeps match tails
>= 3 (native/recode_host.cpp put_run / tokenizer).
"""

import zlib

import numpy as np
import pytest

from pyrecode_tpu import native
from pyrecode_tpu.codecs import dyndeflate as dd

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _streams():
    rng = np.random.default_rng(0)
    streams = [
        b"",
        b"\x00",
        b"\x00" * 3,
        b"\x00" * 4,
        b"\x00" * 100,
        b"abcabcddddd",
        bytes(rng.integers(0, 256, 5000).astype(np.uint8)),  # incompressible
        (rng.integers(0, 256, 50000)
         * (rng.random(50000) < 0.02)).astype(np.uint8).tobytes(),
    ]
    # run lengths straddling every take boundary of the C encoder
    for L in (4, 5, 258, 259, 260, 261, 262, 263, 517, 518, 519, 520, 521, 522, 777):
        streams.append(b"\x07" * L)
        streams.append(b"A" + b"\x00" * L + b"B")
    m = np.zeros(30000, np.uint8)
    m[rng.integers(0, 30000, 400)] = rng.integers(1, 256, 400)
    streams.append(m.tobytes())
    return streams


def test_numpy_pipeline_matches_native_bytes():
    for i, s in enumerate(_streams()):
        ref = native.deflate_sparse(s)
        got = dd.deflate_dyn_np(s)
        assert got == ref, (i, len(s))
        assert zlib.decompress(got) == s, i


def test_tokenize_histogram_consistency():
    """The per-byte histogram must equal the frequency of emitted tokens."""
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 4, 10000) * (rng.random(10000) < 0.1)).astype(np.uint8)
    lut_idx, sym = dd.tokenize_bytes_np(x)
    freq = dd.histogram_np(sym)
    assert freq.sum() == (lut_idx != dd.NO_TOKEN).sum() + 1  # + EOB
    # every literal token's symbol is its byte value
    lit = lut_idx < 256
    assert np.array_equal(sym[lit], lut_idx[lit])
