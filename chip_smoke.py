#!/usr/bin/env python
"""Smoke test of the served path on the GPU, byte-checked against the oracle.

One card (the default):

1. the served path users run (README "Quick start"): ``ReCoDeServer('batch')``
   with three thread nodes -> part files -> ``merge_parts`` -> reader, at
   4096^2 12-bit L1 with compression scheme 0, on synthetic peaked frames with
   a non-zero dark frame and threshold epsilon.  The merged container must be
   byte-identical to the same run on the numpy oracle path
   (``use_device=False``) and the dense read-back must equal
   ``where(frames > thr, frames - thr, 0)``;
2. the same served path for scheme 12 (host rANS) at L1, for L2 (sum) and
   for L4 (weighted centroids), on fewer frames, held to the same checks;
3. every device kernel of that path at 4096^2 against the oracle, exactly:
   ``encode_frames`` at L1-L4, ``decode_l1_frames`` and the 12-bit
   ``bitpack_values`` / ``bitunpack_values``, with each one's step time and
   its share of the card's memory bandwidth.

Four cards (``--four-cards``, and nothing else): 32 frames at 4096^2 over a
('data',) mesh of four — the GSPMD ``encode_frames_sharded``, the shard_map'd
encode step with ``gather_ordered_blocks``, and the sharded
``decode_l1_frames`` — compared byte for byte with the one-card encode and
the oracle.

Times printed here are smoke timings on the host clock (``block_until_ready``),
not benchmark results.  The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed check
raises and the script exits non-zero without printing it.  It also exits
non-zero when JAX finds no GPU.

Usage:
    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # four cards: the sharded phase only
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 bandwidth.  Keyed by the
# device kind JAX reports; a card that is not here is an error.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

BIT_DEPTH = 12
EPSILON = 2
BATCH = 32  # the writer's default buffer_size_in_frames
SIZE = 4096  # frame width and height of the flagship 4096^2 detector
SERVED_FRAMES = 96  # L1 scheme-0 run: a full 32-frame batch for each of 3 nodes
VARIANT_FRAMES = 12  # scheme-12, L2 and L4 runs
FOUR_CARD_FRAMES = 32
SEED = 0


def log(*parts) -> None:
    print(*parts, flush=True)


def require_gpu():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {devices[0].platform!r}")
    return devices


# ------------------------------------------------------------------ inputs


def make_inputs(n_frames: int, size: int, seed: int):
    """(frames, dark): peaked synthetic frames at 1% occupancy on a non-zero
    dark frame, generated in chunks from one seeded generator."""
    from pyrecode_tpu import oracle

    rng = np.random.default_rng(seed)
    dark = rng.integers(0, 8, (size, size)).astype(np.uint16)
    frames = np.empty((n_frames, size, size), np.uint16)
    for start in range(0, n_frames, 8):
        chunk = oracle.synthetic_frames(min(8, n_frames - start), size, size,
                                        occupancy=0.01, bit_depth=BIT_DEPTH,
                                        distribution="peaked", rng=rng)
        chunk += dark
        frames[start:start + chunk.shape[0]] = chunk
    return frames, dark


def threshold_of(dark):
    return (dark.astype(np.int64) + EPSILON).astype(np.uint16)


def expected_dense(frames, thr):
    return np.where(frames > thr, frames - thr, 0).astype(np.uint16)


def input_params(shape, level=1, scheme=0, l2_statistics=0, l4_centroiding=0):
    from pyrecode_tpu import InputParams

    params = InputParams(dict(
        reduction_level=level, rc_operation_mode=1,
        calibration_threshold_epsilon=EPSILON, target_bit_depth=BIT_DEPTH,
        source_bit_depth=BIT_DEPTH, num_cols=shape[2], num_rows=shape[1],
        num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=3,
        l2_statistics=l2_statistics, l4_centroiding=l4_centroiding,
        compression_scheme=scheme, compression_level=1, source_file_type=0,
        source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=0, target_data_type=0))
    if not params.validate():
        raise ValueError("invalid smoke parameters")
    return params


# -------------------------------------------------------------- served path


def served_run(frames, dark, params, out_dir: Path, use_device: bool):
    """One batch acquisition through ReCoDeServer -> merge; returns
    (merged container bytes, merged path, server wall seconds)."""
    from pyrecode_tpu import InitParams
    from pyrecode_tpu.reader import merge_parts
    from pyrecode_tpu.server import ReCoDeServer

    out_dir.mkdir(parents=True)
    init = InitParams("batch", str(out_dir), image_filename="smoke",
                      log_filename=str(out_dir / "recode.log"),
                      use_device=use_device)
    t0 = time.perf_counter()
    metrics = ReCoDeServer("batch").run(init, params, dark_data=dark, data=frames)
    wall = time.perf_counter() - t0
    written = sum(int(m.get("run_frames", 0)) for m in metrics.values())
    if written != frames.shape[0]:
        raise AssertionError(f"server wrote {written} of {frames.shape[0]} frames")
    level = params.reduction_level
    merged = merge_parts(str(out_dir), f"smoke.rc{level}", params.num_threads)
    return Path(merged).read_bytes(), merged, wall


def warm_encode(frames, thr, params):
    """Compile the writer's device programs for this batch shape; returns
    (compile seconds, the compiled encode step)."""
    import jax

    from pyrecode_tpu import ops
    from pyrecode_tpu.writer import _L2_STATISTIC_NAMES, _L4_SCHEME_NAMES, _bucket_for

    batch = frames[:BATCH]
    if batch.shape[0] < BATCH:
        batch = np.concatenate([batch, np.zeros((BATCH - batch.shape[0], *batch.shape[1:]),
                                                batch.dtype)])
    t0 = time.perf_counter()
    counts = np.asarray(ops.count_foreground(batch, thr))
    static = dict(reduction_level=params.reduction_level, bit_depth=BIT_DEPTH,
                  max_values=_bucket_for(int(counts.max()), thr.size),
                  l2_statistic=_L2_STATISTIC_NAMES[params.l2_statistics],
                  l4_scheme=_L4_SCHEME_NAMES[params.l4_centroiding])
    jax.block_until_ready(ops.encode_frames(batch, thr, **static))
    compile_s = time.perf_counter() - t0
    return compile_s, ops.encode_frames.lower(batch, thr, **static).compile()


def check_read_back(merged, frames, thr, level):
    """Dense read-back of every frame, in writer-sized batches; returns
    (read seconds).  L1 must equal the residuals, L2 the foreground mask,
    L4 the oracle's centroid map."""
    from pyrecode_tpu import oracle
    from pyrecode_tpu.reader import ReCoDeReader

    reader = ReCoDeReader(merged)
    reader.open()
    n, h, w = frames.shape
    read_s = 0.0
    for start in range(0, n, BATCH):
        t0 = time.perf_counter()
        dense = reader.read_frames_dense(start, BATCH)
        read_s += time.perf_counter() - t0
        chunk = frames[start:start + BATCH]
        if level == 1:
            expected = expected_dense(chunk, thr)
        elif level == 2:
            expected = (chunk > thr).astype(np.uint16)
        else:
            expected = np.stack([
                oracle.unpack_binary_frame(np.frombuffer(
                    oracle.reduce_frame(f, thr, 4, BIT_DEPTH)["packed_binary_map"],
                    np.uint8), h * w).reshape(h, w) for f in chunk]).astype(np.uint16)
        if not np.array_equal(dense, expected):
            raise AssertionError(f"L{level} dense read-back differs at frames "
                                 f"{start}..{start + chunk.shape[0] - 1}")
    # random access through the reference API on the first and last frame
    for z in (0, n - 1):
        got = reader.get_frame(z)[z]["data"].toarray()
        if level == 1 and not np.array_equal(got, expected_dense(frames[z], thr)):
            raise AssertionError(f"get_frame({z}) differs")
    reader.close()
    return read_s


def phase_served(frames, dark, workdir: Path, label: str, **param_kw):
    """Served write (device and oracle paths) -> merge -> read, checked."""
    thr = threshold_of(dark)
    params = input_params(frames.shape, **param_kw)
    compile_s, compiled = warm_encode(frames, thr, params)
    dev_bytes, merged, wall = served_run(frames, dark, params, workdir / f"{label}-device", True)
    host_bytes, _, host_wall = served_run(frames, dark, params, workdir / f"{label}-oracle", False)
    if dev_bytes != host_bytes:
        raise AssertionError(f"{label}: merged container differs from the oracle path")
    read_s = check_read_back(merged, frames, thr, params.reduction_level)
    raw = frames.nbytes
    log(f"smoke timing [{label}]: {frames.shape[0]} frames of {frames.shape[1]}^2, "
        f"encode compile {compile_s:.3f} s, served write {wall:.3f} s "
        f"({raw / wall / 1e9:.3f} GB/s raw), oracle-path write {host_wall:.3f} s, "
        f"read_frames_dense {read_s:.3f} s ({frames.shape[0] / read_s:.1f} frames/s), "
        f"container {len(dev_bytes)} B byte-identical to the oracle path")
    return compiled


# ------------------------------------------------------------ per-op checks


def _step_time(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def _report(name, seconds, nbytes, peak):
    share = nbytes / seconds / peak if peak else float("nan")
    log(f"smoke timing [op {name}]: {seconds * 1e3:.4f} ms per call, "
        f"{nbytes} B moved, {nbytes / seconds / 1e9:.3f} GB/s, "
        f"{share * 100:.3f}% of HBM peak")


def phase_ops(frames, dark, peak):
    """Each device kernel of the path vs the oracle, exactly, with its time."""
    import jax
    import jax.numpy as jnp

    from pyrecode_tpu import oracle, ops
    from pyrecode_tpu.writer import _bucket_for

    thr = threshold_of(dark)
    n_pix = thr.size
    frames_d, thr_d = jax.device_put(frames), jax.device_put(thr)
    stats = {2: "sum"}
    l1 = None
    for level, batch in ((1, BATCH), (2, 8), (3, BATCH), (4, 8)):
        sub = frames[:batch]
        bound = _bucket_for(int((sub > thr).sum(axis=(1, 2)).max()), n_pix)
        static = dict(reduction_level=level, bit_depth=BIT_DEPTH, max_values=bound,
                      l2_statistic=stats.get(level, "max"))
        res = ops.encode_frames(frames_d[:batch], thr_d, **static)
        bitmap, counts = np.asarray(res.bitmap), np.asarray(res.counts)
        if np.asarray(res.overflow).any():
            raise AssertionError(f"encode L{level} overflowed its bound {bound}")
        for i in range(batch):
            enc = oracle.reduce_frame(sub[i], thr, level, BIT_DEPTH,
                                      l2_statistic=stats.get(level, "max"))
            if bitmap[i].tobytes() != enc["packed_binary_map"]:
                raise AssertionError(f"encode L{level} bitmap differs at frame {i}")
            if res.packed is not None:
                plen = int(np.asarray(res.packed_len)[i])
                if np.asarray(res.packed)[i][:plen].tobytes() != enc["packed_pixvals"]:
                    raise AssertionError(f"encode L{level} values differ at frame {i}")
        sec = _step_time(lambda f, t: ops.encode_frames(f, t, **static),
                         frames_d[:batch], thr_d)
        out_bytes = bitmap.nbytes + counts.nbytes + (
            np.asarray(res.packed).nbytes if res.packed is not None else 0)
        _report(f"encode_frames L{level} B={batch}", sec,
                sub.nbytes + thr.nbytes + out_bytes, peak)
        if level == 1:
            l1 = res

    h, w = thr.shape
    dense = ops.decode_l1_frames(l1.bitmap, l1.packed, h, w, BIT_DEPTH)
    if not np.array_equal(np.asarray(dense), expected_dense(frames[:BATCH], thr)):
        raise AssertionError("decode_l1_frames differs from the residuals")
    sec = _step_time(lambda b, p: ops.decode_l1_frames(b, p, h, w, BIT_DEPTH),
                     l1.bitmap, l1.packed)
    _report(f"decode_l1_frames B={BATCH}", sec,
            l1.bitmap.nbytes + l1.packed.nbytes + frames[:BATCH].nbytes, peak)

    rng = np.random.default_rng(1)
    n_vals = 1 << 18  # the writer's bucket at 1% occupancy of 4096^2 rounds here
    vals = rng.integers(0, 1 << BIT_DEPTH, (BATCH, n_vals), dtype=np.uint32)
    vals_d = jax.device_put(vals)
    packed = np.asarray(ops.bitpack_values(vals_d, BIT_DEPTH))
    if packed.tobytes() != b"".join(oracle.bit_pack(v.astype(np.uint64), BIT_DEPTH).tobytes()
                                    for v in vals):
        raise AssertionError("bitpack_values differs from oracle.bit_pack")
    back = np.asarray(ops.bitunpack_values(jnp.asarray(packed), BIT_DEPTH))
    if not np.array_equal(back, vals):
        raise AssertionError("bitunpack_values does not invert bitpack_values")
    sec = _step_time(lambda v: ops.bitpack_values(v, BIT_DEPTH), vals_d)
    _report(f"bitpack_values B={BATCH} n={n_vals}", sec, vals.nbytes + packed.nbytes, peak)
    sec = _step_time(lambda p: ops.bitunpack_values(p, BIT_DEPTH), jnp.asarray(packed))
    _report(f"bitunpack_values B={BATCH} n={n_vals}", sec, vals.nbytes + packed.nbytes, peak)


# --------------------------------------------------------------- four cards


def phase_four_cards(frames, dark, n_devices=4):
    """Frames over a ('data',) mesh of ``n_devices``: sharded encode (GSPMD
    and shard_map + ordered gather) and sharded decode, byte-checked against
    the one-device encode and the oracle."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pyrecode_tpu import oracle, ops
    from pyrecode_tpu.parallel import (encode_frames_sharded, frame_sharding, make_codec_mesh,
                                       make_sharded_encode_step)
    from pyrecode_tpu.parallel.multihost import (gather_ordered_blocks, make_encode_step,
                                                 replicate_threshold)
    from pyrecode_tpu.writer import _bucket_for

    devices = jax.devices()[:n_devices]
    if len(devices) != n_devices:
        raise AssertionError(f"need {n_devices} devices, JAX has {len(jax.devices())}")
    thr = threshold_of(dark)
    h, w = thr.shape
    bound = _bucket_for(int((frames > thr).sum(axis=(1, 2)).max()), thr.size)
    mesh = make_codec_mesh(n_devices, 1, devices=devices)

    def on_distinct_devices(arr, what):
        used = {s.device for s in arr.addressable_shards}
        if len(used) != n_devices:
            raise AssertionError(f"{what}: shards on {len(used)} devices, not {n_devices}")

    one = ops.encode_frames(jax.device_put(frames, devices[0]), jax.device_put(thr, devices[0]),
                            reduction_level=1, bit_depth=BIT_DEPTH, max_values=bound)
    one_blocks = gather_ordered_blocks(one.bitmap, one.packed, one.counts, BIT_DEPTH)
    for i, (bm, pv) in enumerate(one_blocks):
        enc = oracle.reduce_frame(frames[i], thr, 1, BIT_DEPTH)
        if bm != enc["packed_binary_map"] or pv != enc["packed_pixvals"]:
            raise AssertionError(f"one-device encode differs from the oracle at frame {i}")

    t0 = time.perf_counter()
    gspmd = encode_frames_sharded(frames, thr, mesh, reduction_level=1,
                                  bit_depth=BIT_DEPTH, max_values=bound)
    jax.block_until_ready(gspmd.bitmap)
    gspmd_s = time.perf_counter() - t0
    on_distinct_devices(gspmd.bitmap, "encode_frames_sharded")
    if gather_ordered_blocks(gspmd.bitmap, gspmd.packed, gspmd.counts,
                             BIT_DEPTH) != one_blocks:
        raise AssertionError("encode_frames_sharded differs from the one-device encode")

    step = make_encode_step(mesh, max_values=bound, bit_depth=BIT_DEPTH)
    frames_s = jax.device_put(frames, NamedSharding(mesh, P("data", None, None)))
    thr_s = replicate_threshold(thr, mesh)
    t0 = time.perf_counter()
    bitmap, packed, counts, ovf = step(frames_s, thr_s)
    jax.block_until_ready(bitmap)
    step_s = time.perf_counter() - t0
    on_distinct_devices(bitmap, "shard_map encode step")
    if np.asarray(ovf).any():
        raise AssertionError("shard_map encode step overflowed")
    if gather_ordered_blocks(bitmap, packed, counts, BIT_DEPTH) != one_blocks:
        raise AssertionError("shard_map encode + gather differs from the one-device encode")

    decode = jax.jit(lambda b, p: ops.decode_l1_frames(b, p, h, w, BIT_DEPTH))
    t0 = time.perf_counter()
    dense = decode(bitmap, packed)
    jax.block_until_ready(dense)
    decode_s = time.perf_counter() - t0
    on_distinct_devices(dense, "sharded decode_l1_frames")
    if not np.array_equal(np.asarray(dense), expected_dense(frames, thr)):
        raise AssertionError("sharded decode_l1_frames differs from the residuals")

    log(f"smoke timing [{n_devices} devices]: {frames.shape[0]} frames of {h}^2, "
        f"first calls with compilation: encode_frames_sharded {gspmd_s:.3f} s, "
        f"shard_map encode {step_s:.3f} s, sharded decode {decode_s:.3f} s; "
        f"all byte-identical to the one-device encode and the oracle")
    gspmd_step = make_sharded_encode_step(mesh, 1, BIT_DEPTH, bound)
    frames_g = jax.device_put(frames, frame_sharding(mesh))
    for name, seconds in (
            ("encode_frames_sharded", _step_time(gspmd_step, frames_g, thr_s)),
            ("shard_map encode", _step_time(step, frames_s, thr_s)),
            ("sharded decode", _step_time(decode, bitmap, packed))):
        log(f"smoke timing [{n_devices} devices, {name}]: {seconds * 1e3:.4f} ms per call")


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded phase on four cards")
    args = parser.parse_args(argv)

    devices = require_gpu()
    from pyrecode_tpu import native
    from pyrecode_tpu.profiling import card_line, enable_compile_cache

    log("card:", card_line())
    log("compile cache:", enable_compile_cache())
    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit("the native host codecs did not build")
    log(f"smoke timing [setup]: native library ready in {time.perf_counter() - t0:.3f} s")
    kind = devices[0].device_kind

    if args.four_cards:
        t0 = time.perf_counter()
        frames, dark = make_inputs(FOUR_CARD_FRAMES, SIZE, SEED)
        log(f"smoke timing [setup]: frames generated in {time.perf_counter() - t0:.3f} s")
        phase_four_cards(frames, dark)
        count = 4
    else:
        if kind not in HBM_BYTES_PER_S:
            raise SystemExit(f"no HBM peak on record for {kind!r}")
        t0 = time.perf_counter()
        frames, dark = make_inputs(SERVED_FRAMES, SIZE, SEED)
        log(f"smoke timing [setup]: frames generated in {time.perf_counter() - t0:.3f} s")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            work = Path(tmp)
            compiled = phase_served(frames, dark, work, "L1 scheme 0")
            log("encode step memory_analysis:", compiled.memory_analysis())
            few = frames[:VARIANT_FRAMES]
            phase_served(few, dark, work, "L1 scheme 12", scheme=12)
            phase_served(few, dark, work, "L2 sum", level=2, l2_statistics=2)
            phase_served(few, dark, work, "L4 weighted", level=4, l4_centroiding=0)
        phase_ops(frames[:BATCH], dark, HBM_BYTES_PER_S[kind])
        log("peak_bytes_in_use:", devices[0].memory_stats().get("peak_bytes_in_use"))
        count = 1

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
