"""Per-puddle reductions: L2 summary statistics and L4 centroids.

Device replacement for the reference's numba per-pixel dict loops
(``get_summary_stats_nb`` converters.py:262-297, ``get_centroids_2D_nb``
converters.py:157-259) using segment reductions over the compact component
ids produced by :mod:`cc_label`.  Output slot ``k`` (0-based) corresponds to
component id ``k + 1``; slots at or beyond the per-frame component count are
zero (or harmless defaults) and are trimmed on host.

``max_puddles`` is a static bound on components per frame (fixed shapes under
jit).  The theoretical maximum for 8-connectivity is ceil(H/2)*ceil(W/2)
(a checkerboard at stride 2), which callers may use as a safe bound.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _segment_sum(data, ids, num_segments):
    return jax.ops.segment_sum(data, ids, num_segments=num_segments,
                               indices_are_sorted=False, unique_indices=False)


def _segment_max(data, ids, num_segments):
    return jax.ops.segment_max(data, ids, num_segments=num_segments,
                               indices_are_sorted=False, unique_indices=False)


def _segment_min(data, ids, num_segments):
    return jax.ops.segment_min(data, ids, num_segments=num_segments,
                               indices_are_sorted=False, unique_indices=False)


@partial(jax.jit, static_argnames=("max_puddles", "statistic", "bit_depth"))
def l2_summary_stats(labels: jax.Array, frames: jax.Array, max_puddles: int,
                     statistic: str = "max", bit_depth: int = 16) -> jax.Array:
    """Per-puddle 'max' or 'sum' of pixel intensities.

    Parameters
    ----------
    labels : (B, H, W) int32 compact component ids (0 = background)
    frames : (B, H, W) unsigned intensities

    Returns
    -------
    stats : (B, max_puddles) uint32 — slot k is the statistic of puddle k+1,
        clipped to ``bit_depth`` bits so the value survives bit-packing.
    """
    if statistic not in ("max", "sum"):
        raise ValueError("Only allowed values for summary stats are: 'sum' and 'max'")
    B = labels.shape[0]
    flat_lbl = labels.reshape(B, -1)
    flat_val = frames.reshape(B, -1).astype(jnp.uint32)

    seg = _segment_max if statistic == "max" else _segment_sum
    out = jax.vmap(lambda l, v: seg(v, l, max_puddles + 1))(flat_lbl, flat_val)
    out = out[:, 1:]  # drop background segment
    # (segment_max's identity for uint32 is 0, so empty slots are already 0)
    limit = jnp.uint32((1 << bit_depth) - 1) if bit_depth < 32 else jnp.uint32(0xFFFFFFFF)
    return jnp.minimum(out, limit)


@partial(jax.jit, static_argnames=("max_puddles", "scheme"))
def l4_centroids(labels: jax.Array, frames: jax.Array, max_puddles: int,
                 scheme: str = "weighted_average") -> jax.Array:
    """Per-puddle (row, col) centroids, float32 (B, max_puddles, 2).

    Schemes (reference converters.py:157-259 semantics, fixed dispatch):
    'weighted_average' — intensity-weighted mean position;
    'unweighted' — mean position; 'max' — position of the first
    maximum-intensity pixel in raster order.  Empty slots are (0, 0) but
    callers must trim by the per-frame count before use.
    """
    B, H, W = labels.shape
    N = H * W
    flat_lbl = labels.reshape(B, N)
    flat_val = frames.reshape(B, N).astype(jnp.float32)
    rows = (jax.lax.broadcasted_iota(jnp.int32, (B, N), 1) // W).astype(jnp.float32)
    cols = (jax.lax.broadcasted_iota(jnp.int32, (B, N), 1) % W).astype(jnp.float32)

    nseg = max_puddles + 1

    if scheme == "weighted_average":
        wsum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, flat_val)
        rsum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, flat_val * rows)
        csum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, flat_val * cols)
        denom = jnp.where(wsum == 0, 1.0, wsum)
        r, c = rsum / denom, csum / denom
    elif scheme == "unweighted":
        ones = jnp.ones_like(flat_val)
        count = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, ones)
        rsum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, rows)
        csum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, cols)
        denom = jnp.where(count == 0, 1.0, count)
        r, c = rsum / denom, csum / denom
    elif scheme == "max":
        vmax = jax.vmap(lambda l, v: _segment_max(v, l, nseg))(flat_lbl, flat_val)
        # first raster-order pixel attaining the per-puddle max
        per_pixel_max = jnp.take_along_axis(vmax, jnp.clip(flat_lbl, 0, max_puddles), axis=-1)
        lin = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
        cand = jnp.where((flat_lbl > 0) & (flat_val == per_pixel_max), lin, N)
        first = jax.vmap(lambda l, v: _segment_min(v, l, nseg))(flat_lbl, cand)
        first = jnp.clip(first, 0, N - 1)
        r = (first // W).astype(jnp.float32)
        c = (first % W).astype(jnp.float32)
    else:
        raise ValueError(f"Unknown centroiding scheme: {scheme}")

    return jnp.stack([r[:, 1:], c[:, 1:]], axis=-1)


def _round_div_half_even(num: jax.Array, den: jax.Array) -> jax.Array:
    """Exact round-half-to-even of ``num / den`` for uint32 inputs.

    Integer arithmetic is order-independent, so device and CPU produce identical
    pixels — float division would round differently near .5 across platforms.
    Exact while per-puddle sums stay below 2**32 (electron puddles are tiny;
    a puddle would need ~256 saturated pixels at 4096^2 to wrap).
    """
    den_safe = jnp.maximum(den, 1)
    q = num // den_safe
    rem = num - q * den_safe
    down = den_safe - rem
    round_up = (rem > down) | ((rem == down) & (q % 2 == 1))
    return q + round_up.astype(q.dtype)


@partial(jax.jit, static_argnames=("max_puddles", "scheme"))
def l4_centroid_pixels(labels: jax.Array, frames: jax.Array, max_puddles: int,
                       scheme: str = "weighted_average"):
    """Per-puddle centroid pixel (row, col) as exact integers, (B, P, 2) int32.

    The on-disk L4 product is a *bitmap* of rounded centroids, so the encode
    path computes the rounded pixel directly with integer sums + exact
    round-half-even division instead of going through floats (which would make
    the bitmap platform-dependent in the last ulp).  'max' picks the first
    raster-order maximum pixel.
    """
    B, H, W = labels.shape
    N = H * W
    flat_lbl = labels.reshape(B, N)
    nseg = max_puddles + 1
    lin32 = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
    rows = (lin32 // W).astype(jnp.uint32)
    cols = (lin32 % W).astype(jnp.uint32)

    if scheme in ("weighted_average", "unweighted"):
        if scheme == "weighted_average":
            w = frames.reshape(B, N).astype(jnp.uint32)
        else:
            w = jnp.ones((B, N), dtype=jnp.uint32)
        wsum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, w)
        rsum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, w * rows)
        csum = jax.vmap(lambda l, v: _segment_sum(v, l, nseg))(flat_lbl, w * cols)
        r = _round_div_half_even(rsum[:, 1:], wsum[:, 1:]).astype(jnp.int32)
        c = _round_div_half_even(csum[:, 1:], wsum[:, 1:]).astype(jnp.int32)
    elif scheme == "max":
        flat_val = frames.reshape(B, N).astype(jnp.int32)
        vmax = jax.vmap(lambda l, v: _segment_max(v, l, nseg))(flat_lbl, flat_val)
        per_pixel_max = jnp.take_along_axis(vmax, jnp.clip(flat_lbl, 0, max_puddles), axis=-1)
        cand = jnp.where((flat_lbl > 0) & (flat_val == per_pixel_max), lin32, N)
        first = jax.vmap(lambda l, v: _segment_min(v, l, nseg))(flat_lbl, cand)[:, 1:]
        first = jnp.clip(first, 0, N - 1)
        r, c = first // W, first % W
    else:
        raise ValueError(f"Unknown centroiding scheme: {scheme}")
    return jnp.stack([r, c], axis=-1)


@partial(jax.jit, static_argnames=("height", "width"))
def centroid_pixels_to_mask(pixels: jax.Array, counts: jax.Array, height: int, width: int) -> jax.Array:
    """Rasterize integer centroid pixels (B, P, 2) into a boolean (B, H, W) map."""
    B, P, _ = pixels.shape
    r = jnp.clip(pixels[..., 0], 0, height - 1)
    c = jnp.clip(pixels[..., 1], 0, width - 1)
    lin = r * width + c
    valid = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1) < counts[:, None]
    lin = jnp.where(valid, lin, height * width)  # out of bounds -> dropped

    def _scatter(one_lin):
        out = jnp.zeros((height * width,), dtype=jnp.bool_)
        return out.at[one_lin].set(True, mode="drop")

    return jax.vmap(_scatter)(lin).reshape(B, height, width)


@partial(jax.jit, static_argnames=("height", "width"))
def centroids_to_mask(centroids: jax.Array, counts: jax.Array, height: int, width: int) -> jax.Array:
    """Rasterize rounded centroids into a boolean (B, H, W) map.

    Correct version of the reference's ``make_binary_map``
    (converters.py:300-309).  Rounding is half-to-even to match numpy/the
    offline converter (converters.py:92).  Slots >= counts are dropped.
    """
    B, P, _ = centroids.shape
    r = jnp.clip(jnp.round(centroids[..., 0]).astype(jnp.int32), 0, height - 1)
    c = jnp.clip(jnp.round(centroids[..., 1]).astype(jnp.int32), 0, width - 1)
    lin = r * width + c
    valid = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1) < counts[:, None]
    lin = jnp.where(valid, lin, height * width)  # out of bounds -> dropped

    def _scatter(one_lin):
        out = jnp.zeros((height * width,), dtype=jnp.bool_)
        return out.at[one_lin].set(True, mode="drop")

    return jax.vmap(_scatter)(lin).reshape(B, height, width)
