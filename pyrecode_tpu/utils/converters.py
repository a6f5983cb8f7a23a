"""Offline post-processing of decoded L1 sparse frames.

Capability parity with the reference ``utils/converters.py``:

* ``recalibrate_l1`` — re-threshold decoded L1 frames against a new dark
  reference by adding ``old - (new + eps)`` in float64 with dtype clipping
  (converters.py:15-56);
* ``l1_to_l4_converter`` — connected-component label + centroid each frame,
  returning boolean COO centroid maps (converters.py:59-123), with the
  centroid-scheme dispatch fixed (the reference tests 'weighted_average' in
  every branch, converters.py:159-164);
* ``apply_DE16_common_mode_correction`` — per-256-column even/odd median
  subtraction (converters.py:320-325);
* ``read_dark_ref`` (converters.py:312-317).

The per-frame numba dict loops become oracle/ops kernels;
``l1_to_l4_batch`` additionally runs whole frame batches through the device
CC-labeling + centroid kernels.
"""

from __future__ import annotations

import copy
from typing import Optional
from datetime import datetime

import numpy as np
from scipy.sparse import coo_matrix

from .. import oracle


def _deep_copy_frame_metadata(src, target, frame_id):
    target[frame_id] = {}
    for key, value in src[frame_id].items():
        if key != "data":
            target[frame_id][key] = copy.deepcopy(value)


def recalibrate_l1(l1_frames, n_frames=-1, original_calibration_frame=None,
                   new_calibration_frame=None, epsilon=0.0, in_place=False,
                   verbose=False):
    """Re-threshold decoded L1 frames with a new dark reference."""
    if n_frames < 1:
        n_frames = len(l1_frames)

    calibration_diff = original_calibration_frame.astype(np.float64) - (
        new_calibration_frame.astype(np.float64) + epsilon)

    first = next(iter(l1_frames))
    dtype = l1_frames[first]["data"].dtype
    if np.issubdtype(dtype, np.integer):
        lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    elif np.issubdtype(dtype, np.floating):
        lo, hi = np.finfo(dtype).min, np.finfo(dtype).max
    else:
        raise ValueError("Unknown kind of frame dtype. Expected 'u', 'i', or 'f'.")

    out = {}
    start = datetime.now()
    for frame_count, key in enumerate(l1_frames):
        dense = np.asarray(l1_frames[key]["data"].todense(), dtype=np.float64)
        was_foreground = dense > 0
        dense = dense + calibration_diff
        dense = np.clip(dense, lo, hi)
        dense[~was_foreground] = 0  # only previously-kept pixels carry signal
        dense[dense < 0] = 0
        recal = dense.astype(dtype)

        if in_place:
            out[key] = l1_frames[key]
        else:
            _deep_copy_frame_metadata(l1_frames, out, key)
        out[key]["data"] = coo_matrix(recal, dtype=dtype)

        if 0 < n_frames == frame_count:
            break
    if verbose:
        print("Total processing time:", datetime.now() - start)
    return out


def l1_to_l4_converter(l1_frames, frame_shape, n_frames=-1, area_threshold=0,
                       verbosity=0, method="weighted_average", in_place=False):
    """Convert decoded L1 frames to L4 centroid maps (boolean COO)."""
    max_dim = int(np.max(frame_shape))
    centroids_dtype = None
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_dim < np.iinfo(dt).max:
            centroids_dtype = dt
            break
    if centroids_dtype is None:
        raise ValueError("Unable to identify data type for centroids")

    n_pixels = float(frame_shape[0] * frame_shape[1])
    out = {}
    avg_dose_rate = 0.0
    start = datetime.now()

    for frame_count, key in enumerate(l1_frames):
        dense = np.asarray(l1_frames[key]["data"].todense())
        mask = dense > 0
        labels, num = oracle.label_components(mask)
        cents = oracle.l4_centroids(labels, dense, num, method)
        if area_threshold > 0 and num:
            areas = np.bincount(labels.reshape(-1), minlength=num + 1)[1:]
            cents = cents[areas > area_threshold]
        cents = np.round(cents).astype(centroids_dtype)

        if in_place:
            out[key] = l1_frames[key]
        else:
            _deep_copy_frame_metadata(l1_frames, out, key)

        if len(cents) > 0:
            ones = np.ones(len(cents), dtype=bool)
            out[key]["data"] = coo_matrix(
                (ones, (cents[:, 0], cents[:, 1])),
                shape=(frame_shape[0], frame_shape[1]), dtype=bool)
        else:
            out[key]["data"] = coo_matrix((frame_shape[0], frame_shape[1]), dtype=bool)

        if verbosity > 0:
            print(key, "Dose Rate =", num / n_pixels)
        else:
            avg_dose_rate += num / n_pixels
        if 0 < n_frames == frame_count:
            break

    if verbosity > 0:
        print("Total processing time:", datetime.now() - start)
    return out


def l1_to_l4_batch(dense_frames: np.ndarray, method: str = "weighted_average",
                   max_puddles: Optional[int] = None) -> np.ndarray:
    """Device-batched L1 -> L4: centroid maps for a whole (B, H, W) batch.

    The device path of :func:`l1_to_l4_converter` — one fused program for
    CC-labeling, centroiding and rasterization (ops/cc_label.py,
    ops/segment.py).  ``max_puddles`` defaults to the actual per-frame
    maximum (from the labeling pass) rounded up to a power of two, so no
    component is ever silently dropped.
    """
    from .. import ops

    mask = dense_frames > 0
    labels, counts = ops.label_components(mask)
    if max_puddles is None:
        peak = int(np.asarray(counts).max()) if counts.size else 1
        max_puddles = 1 << max(peak, 1024).bit_length()
    pixels = ops.segment.l4_centroid_pixels(labels, dense_frames, max_puddles, method)
    cmask = ops.segment.centroid_pixels_to_mask(
        pixels, counts, dense_frames.shape[1], dense_frames.shape[2])
    return np.asarray(cmask)


def read_dark_ref(fname, shape, dtype):
    """Load a raw binary dark reference (converters.py:312-317)."""
    with open(fname, "rb") as binary_file:
        data = binary_file.read()
    return np.frombuffer(data, dtype=dtype, count=shape[0] * shape[1]).reshape(shape)


def apply_DE16_common_mode_correction(frame: np.ndarray) -> np.ndarray:
    """DE-16 per-256-column-block even/odd median subtraction
    (converters.py:320-325)."""
    corrected = frame.astype(np.float64).copy()
    for c in range(0, frame.shape[1], 256):
        even = corrected[:, c:c + 256:2]
        odd = corrected[:, c + 1:c + 256:2]
        corrected[:, c:c + 256:2] = even - np.median(even)
        corrected[:, c + 1:c + 256:2] = odd - np.median(odd)
    return corrected.astype(frame.dtype) if np.issubdtype(frame.dtype, np.floating) \
        else corrected
