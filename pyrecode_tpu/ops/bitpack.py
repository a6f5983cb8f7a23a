"""Vectorized bit-packing kernels (XLA; batched over frames).

Device replacement for the reference's per-pixel numba loops
(``_pack_binary_frame`` recode_writer.py:622-634, ``_bit_pack``
recode_writer.py:637-652) and the C pack/unpack loops
(c_extensions/reader.h:74-140).  The wire format is identical:

* binary maps: row-major pixel order, LSB-first within each byte;
* value streams: value ``i`` occupies bits ``[i*b, (i+1)*b)`` of an LSB-first
  bitstream, each value's own bits LSB-first.

The scalar bit loops of the reference are hostile to a vector machine; here
both packings are reshapes plus shift/mask arithmetic on 8-lane groups, which
XLA fuses into neighboring ops.  For a ``b``-bit stream the pattern repeats
every ``lcm(8, b)`` bits, so values are processed in groups of
``g = lcm(8,b)/b`` values -> ``lcm(8,b)/8`` bytes with a small, statically
unrolled set of shifts (at most 8 values and ``b`` bytes per group).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

_BYTE_WEIGHTS = tuple(1 << i for i in range(8))


def pack_bits(bits: jax.Array) -> jax.Array:
    """Pack a 0/1 array (..., n) with n % 8 == 0 into bytes (..., n // 8).

    LSB-first within each byte: bit k of byte j is element ``j*8 + k``.
    """
    *lead, n = bits.shape
    if n % 8:
        raise ValueError(f"pack_bits needs a multiple of 8 elements, got {n}")
    b = bits.reshape(*lead, n // 8, 8).astype(jnp.int32)
    weights = jnp.asarray(_BYTE_WEIGHTS, dtype=jnp.int32)
    return jnp.sum(b * weights, axis=-1).astype(jnp.uint8)


def unpack_bits(packed: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_bits`: bytes (..., m) -> 0/1 uint8 (..., m * 8)."""
    *lead, m = packed.shape
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*lead, m * 8)


def packed_group_shape(bit_depth: int):
    """(values per group, bytes per group) for a ``bit_depth``-bit stream."""
    l = math.lcm(8, bit_depth)
    return l // bit_depth, l // 8


def packed_size_bytes(n_values: int, bit_depth: int) -> int:
    return -(-n_values * bit_depth // 8)


@partial(jax.jit, static_argnames=("bit_depth",))
def bitpack_values(values: jax.Array, bit_depth: int) -> jax.Array:
    """Pack (..., n) unsigned values into a ``bit_depth``-bit stream (..., n*b/8).

    ``n`` must be a multiple of ``lcm(8, bit_depth) / bit_depth`` (pad with
    zeros; zero padding produces zero bytes, matching the reference's
    zero-initialized pack buffers).  Values must fit in ``bit_depth`` bits.
    """
    g_vals, g_bytes = packed_group_shape(bit_depth)
    *lead, n = values.shape
    if n % g_vals:
        raise ValueError(f"n={n} must be a multiple of the value group size {g_vals}")
    if n % packed_word_group_shape(bit_depth)[0] == 0:
        # word-stack formulation: same bytes, combined on 32-bit words
        # (4x fewer elements through the final relayout)
        return bitpack_values_words(values, bit_depth)
    v = values.reshape(*lead, n // g_vals, g_vals).astype(jnp.uint32)

    out_bytes = []
    for j in range(g_bytes):
        acc = None
        for k in range(g_vals):
            lo, hi = k * bit_depth, (k + 1) * bit_depth  # bit span of value k
            if hi <= 8 * j or lo >= 8 * (j + 1):
                continue
            shift = lo - 8 * j
            piece = v[..., k] << shift if shift >= 0 else v[..., k] >> (-shift)
            piece = piece & jnp.uint32(0xFF)
            acc = piece if acc is None else acc | piece
        out_bytes.append(acc)
    out = jnp.stack(out_bytes, axis=-1).astype(jnp.uint8)
    return out.reshape(*lead, (n // g_vals) * g_bytes)


def packed_word_group_shape(bit_depth: int):
    """(values per group, i32 words per group) for a ``bit_depth``-bit stream."""
    l = math.lcm(32, bit_depth)
    return l // bit_depth, l // 32


@partial(jax.jit, static_argnames=("bit_depth",))
def bitpack_values_words(values: jax.Array, bit_depth: int) -> jax.Array:
    """Word-oriented :func:`bitpack_values`: identical output bytes, but the
    combine runs on 32-bit lanes (one minor-dim relayout of words instead of
    bytes — 4x fewer elements through the small-minor-dim transpose).  ``n`` must be a multiple of ``lcm(32, bit_depth) /
    bit_depth``.
    """
    g_vals, g_words = packed_word_group_shape(bit_depth)
    *lead, n = values.shape
    if n % g_vals:
        raise ValueError(f"n={n} must be a multiple of the word group size {g_vals}")
    v = values.reshape(*lead, n // g_vals, g_vals).astype(jnp.uint32)

    out_words = []
    for j in range(g_words):
        acc = None
        for k in range(g_vals):
            lo, hi = k * bit_depth, (k + 1) * bit_depth  # bit span of value k
            if hi <= 32 * j or lo >= 32 * (j + 1):
                continue
            shift = lo - 32 * j
            piece = v[..., k] << shift if shift >= 0 else v[..., k] >> (-shift)
            acc = piece if acc is None else acc | piece
        out_words.append(acc)
    w = jnp.stack(out_words, axis=-1)                    # (..., G, g_words)
    by = jax.lax.bitcast_convert_type(w, jnp.uint8)      # (..., G, g_words, 4)
    return by.reshape(*lead, (n // g_vals) * g_words * 4)


@partial(jax.jit, static_argnames=("bit_depth", "out_dtype"))
def bitunpack_values(packed: jax.Array, bit_depth: int, out_dtype=jnp.uint32) -> jax.Array:
    """Unpack a ``bit_depth``-bit stream (..., m) into values (..., m*8/b).

    ``m`` must be a multiple of ``lcm(8, bit_depth) / 8``.
    """
    g_vals, g_bytes = packed_group_shape(bit_depth)
    *lead, m = packed.shape
    if m % g_bytes:
        raise ValueError(f"m={m} must be a multiple of the byte group size {g_bytes}")
    b = packed.reshape(*lead, m // g_bytes, g_bytes).astype(jnp.uint32)

    mask = jnp.uint32((1 << bit_depth) - 1) if bit_depth < 32 else jnp.uint32(0xFFFFFFFF)
    out_vals = []
    for k in range(g_vals):
        lo, hi = k * bit_depth, (k + 1) * bit_depth
        acc = None
        for j in range(g_bytes):
            if hi <= 8 * j or lo >= 8 * (j + 1):
                continue
            shift = lo - 8 * j  # inverse of the pack shift
            piece = b[..., j] >> shift if shift >= 0 else b[..., j] << (-shift)
            acc = piece if acc is None else acc | piece
        out_vals.append(acc & mask)
    out = jnp.stack(out_vals, axis=-1)
    return out.reshape(*lead, (m // g_bytes) * g_vals).astype(out_dtype)
