#!/usr/bin/env python
"""Benchmark harness: L1 encode throughput on 4096^2 uint16 frames (GPU).

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "GB/s", "platform": "gpu",
     "device_kind": "...", "device_count": N, "card": "<name>, <power limit>"}

Methodology: the fused device encode (:func:`pyrecode_tpu.ops.encode_frames`:
threshold -> mask -> residual compaction -> bitmap + intensity bit-pack) runs
on batches of synthetic frames generated on the device; each call is timed on
the host clock up to ``block_until_ready`` and the median over distinct
batches is reported.  Host<->device copies, entropy coding and file IO are
outside the boundary, matching the reference's own stage split
(recode_writer.py:432-555).  Exits non-zero when JAX finds no GPU.

Usage:
    python bench.py            # full benchmark (4096^2)
    python bench.py --quick    # small smoke run (512^2)
    python bench.py --all      # extra configs to stderr
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def bench_encode(batch, height, width, density, n_batches=16,
                 reduction_level=1, bit_depth=12, max_values=None):
    """Return (GB/s, seconds per batch) for the fused encode."""
    import jax
    import jax.numpy as jnp

    from pyrecode_tpu.ops.encode import encode_frames

    if max_values is None:
        cap = int(density * height * width * 2) + 1024
        max_values = 1 << (cap - 1).bit_length()

    @jax.jit
    def gen_batches(key):
        """Device-side synthetic sparse detector frames (12-bit residuals)."""
        k1, k2 = jax.random.split(key)
        shape = (n_batches, batch, height, width)
        u = jax.random.uniform(k1, shape, dtype=jnp.float32)
        vals = jax.random.randint(k2, shape, 1, 1 << 12, dtype=jnp.int32)
        return jnp.where(u < density, vals, 0).astype(jnp.uint16)

    threshold = jnp.zeros((height, width), dtype=jnp.uint16)
    frames_all = jax.block_until_ready(gen_batches(jax.random.key(0)))

    def run(frames):
        return encode_frames(frames, threshold, reduction_level=reduction_level,
                             bit_depth=bit_depth, max_values=max_values)

    jax.block_until_ready(run(frames_all[0]))  # compile
    times = []
    for i in range(n_batches):
        t0 = time.perf_counter()
        jax.block_until_ready(run(frames_all[i]))
        times.append(time.perf_counter() - t0)
    per_batch = sorted(times)[len(times) // 2]
    batch_bytes = batch * height * width * 2
    return batch_bytes / 1e9 / per_batch, per_batch


def main():
    import jax

    from pyrecode_tpu.profiling import card_line, enable_compile_cache

    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="small smoke run")
    parser.add_argument("--all", action="store_true", help="extra configs to stderr")
    args = parser.parse_args()

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX backend: {jax.default_backend()})")
    enable_compile_cache()
    card = card_line()

    batch, size = (64, 512) if args.quick else (4, 4096)
    gbps, _ = bench_encode(batch, size, size, density=0.01)

    if args.all:
        for level in (1, 3):
            for density in (0.001, 0.01, 0.05):
                g, d = bench_encode(batch, size, size, density=density,
                                    reduction_level=level)
                print(f"  L{level} density={density}: {g:.3f} GB/s "
                      f"({d * 1e3:.3f} ms/batch)", file=sys.stderr)

    devices = jax.devices()
    print(json.dumps({
        "metric": f"L1 encode throughput ({size}x{size} uint16, 1% occupancy, 1 device)",
        "value": gbps,
        "unit": "GB/s",
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card,
    }))


if __name__ == "__main__":
    main()
