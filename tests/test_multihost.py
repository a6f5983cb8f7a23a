"""Multi-process data plane: jax.distributed on 2 localhost CPU processes.

The reference's unit of distribution is N OS processes writing part files
(recode_server.py:350-363).  Here the equivalent cross-process path —
shard_map'd device encode + process_allgather + process-0 container
assembly (parallel/multihost.py) — is executed for real on a 2-process
jax.distributed runtime (4 virtual CPU devices each, 8-device global mesh)
and byte-compared against the single-process result.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = str(Path(__file__).resolve().parent.parent)

_WORKER = """
import os, pickle, sys

proc_id, nprocs, port, outdir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=nprocs, process_id=proc_id)
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from pyrecode_tpu.parallel import multihost

assert jax.process_count() == nprocs
assert len(jax.devices()) == 4 * nprocs

rng = np.random.default_rng(0)
frames = (rng.integers(0, 4096, (8, 64, 128)).astype(np.int64) - 3500)
frames = frames.clip(0).astype(np.uint16)
thr = np.zeros((64, 128), np.uint16)

mesh = Mesh(np.array(jax.devices()), ("data",))
sharding = NamedSharding(mesh, P("data", None, None))
garr = jax.make_array_from_callback(frames.shape, sharding,
                                    lambda idx: frames[idx])
thr_g = multihost.replicate_threshold(thr, mesh)
step = multihost.make_encode_step(mesh, max_values=2048, bit_depth=12)
bitmap, packed, counts, ovf = step(garr, thr_g)
assert not bool(np.any(multihost_utils.process_allgather(ovf, tiled=True)))
blocks = multihost.gather_ordered_blocks(bitmap, packed, counts, 12)
if proc_id == 0:
    assert blocks is not None
    with open(os.path.join(outdir, "blocks.pkl"), "wb") as fp:
        pickle.dump(blocks, fp)
else:
    assert blocks is None
jax.distributed.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gather_matches_single_process(tmp_path):
    port = str(_free_port())
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", port, str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]

    with open(tmp_path / "blocks.pkl", "rb") as fp:
        blocks = pickle.load(fp)

    # single-process ground truth: the numpy oracle on the same fixture
    from pyrecode_tpu import oracle

    rng = np.random.default_rng(0)
    frames = (rng.integers(0, 4096, (8, 64, 128)).astype(np.int64) - 3500)
    frames = frames.clip(0).astype(np.uint16)
    thr = np.zeros((64, 128), np.uint16)
    assert len(blocks) == 8
    for i in range(8):
        enc = oracle.reduce_frame(frames[i], thr, 1, 12)
        assert blocks[i][0] == enc["packed_binary_map"], i
        assert blocks[i][1] == enc["packed_pixvals"], i


_WORKER_FULL = """
import os, sys

proc_id, nprocs, port, outdir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=nprocs, process_id=proc_id)
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrecode_tpu import InputParams
from pyrecode_tpu.writer import ReCoDeWriter

# ---- full per-process writer: device reduce + host entropy + part file ----
rng = np.random.default_rng(5)
data = np.where(rng.random((4, 64, 64)) < 0.04,
                rng.integers(1, 4096, (4, 64, 64)), 0).astype(np.uint16)
dark = np.zeros((64, 64), np.uint16)
params = InputParams(dict(
    reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
    target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64,
    num_frames=4, frame_offset=0, num_calibration_frames=1,
    calibration_frame_offset=0, keep_part_files=1, num_threads=nprocs,
    l2_statistics=0, l4_centroiding=0, compression_scheme=0,
    compression_level=1, source_file_type=0, source_header_length=0,
    keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
    target_data_type=0))
assert params.validate()
w = ReCoDeWriter("dist", dark_data=dark, output_directory=outdir,
                 input_params=params, node_id=proc_id, use_device=True,
                 fast_deflate=True)
w.start()
w.run(data)
w.close()

# ---- shard_map'd encode across BOTH processes (8-device global mesh) -----
from pyrecode_tpu import oracle
from pyrecode_tpu.parallel import multihost

mesh = Mesh(np.array(jax.devices()), ("data",))
frames = np.concatenate([data, data[::-1]])          # 8 frames, one per device
garr = jax.make_array_from_callback(
    frames.shape, NamedSharding(mesh, P("data", None, None)),
    lambda idx: frames[idx])
step = multihost.make_encode_step(mesh, max_values=64 * 64, bit_depth=12)
bitmap, packed, counts, ovf = step(garr, multihost.replicate_threshold(dark, mesh))
assert not bool(np.any(multihost_utils.process_allgather(ovf, tiled=True)))
blocks = multihost.gather_ordered_blocks(bitmap, packed, counts, 12)
if proc_id == 0:
    for i, (bm, pv) in enumerate(blocks):
        enc = oracle.reduce_frame(frames[i], dark, 1, 12)
        assert bm == enc["packed_binary_map"] and pv == enc["packed_pixvals"], i

multihost_utils.sync_global_devices("writer-done")
jax.distributed.shutdown()
"""


def test_two_process_full_writer_pipeline(tmp_path):
    """N jax.distributed processes each run the COMPLETE ReCoDeWriter
    (device encode, host entropy, one part file per process), the parts
    merge into one container that is byte-identical to a single-process
    oracle-path run, and the merged container decodes bit-exactly.  The
    shard_map'd encode also runs over the 8-device global mesh spanning both
    processes, byte-identical to the oracle."""
    port = str(_free_port())
    script = tmp_path / "worker_full.py"
    script.write_text(_WORKER_FULL.format(repo=REPO))
    dist_dir = tmp_path / "dist"
    dist_dir.mkdir()

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", port, str(dist_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]

    # single-process ground truth: same writers, oracle encode path
    from pyrecode_tpu import InputParams
    from pyrecode_tpu.reader import ReCoDeReader, merge_parts
    from pyrecode_tpu.writer import ReCoDeWriter

    rng = np.random.default_rng(5)
    data = np.where(rng.random((4, 64, 64)) < 0.04,
                    rng.integers(1, 4096, (4, 64, 64)), 0).astype(np.uint16)
    dark = np.zeros((64, 64), np.uint16)
    params = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64,
        num_frames=4, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=2,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
        target_data_type=0))
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for nid in (0, 1):
        w = ReCoDeWriter("dist", dark_data=dark, output_directory=str(ref_dir),
                         input_params=params, node_id=nid,
                         use_device=False, fast_deflate=True)
        w.start()
        w.run(data)
        w.close()

    # part files byte-identical across the process boundary
    for nid in (0, 1):
        name = f"dist.rc1_part{nid:03d}"
        assert (dist_dir / name).read_bytes() == \
            (ref_dir / name).read_bytes(), name

    # merged containers byte-identical; decode bit-exact
    merge_parts(str(dist_dir), "dist.rc1", 2)
    merge_parts(str(ref_dir), "dist.rc1", 2)
    assert (dist_dir / "dist.rc1").read_bytes() == \
        (ref_dir / "dist.rc1").read_bytes()
    reader = ReCoDeReader(str(dist_dir / "dist.rc1"))
    reader.open()
    for i in range(4):
        fd = reader.get_next_frame()
        assert np.array_equal(fd[i]["data"].todense(), data[i]), i
    reader.close()
