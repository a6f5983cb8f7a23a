"""ReCoDeWriter: the encoder engine (device-batched).

Capability parity with the reference ``ReCoDeWriter`` (recode_writer.py:24-652)
— same constructor surface, ``start()`` / ``run()`` / ``close()`` lifecycle,
part-file naming ``<base>.rc<L>_part<NNN>``, per-node frame slicing, validation
frames with dose-rate telemetry, and per-stage run metrics — but re-architected
around batched device kernels:

* the reference encodes frame by frame in Python (recode_writer.py:383-428);
  here whole batches go through one fused jitted kernel
  (:func:`pyrecode_tpu.ops.encode_frames`), with the variable-length intensity
  stream handled by max-bound buffers whose bound is picked per batch from a
  cheap foreground-count pre-pass (power-of-two buckets keep the jit cache
  small, and the bound always holds the batch, so no frame overflows);
* bit-packing happens on device; the host does entropy coding (zlib & co
  release the GIL; multiple writer threads overlap) and container byte
  assembly;
* ``use_device=False`` selects the vectorized numpy oracle path instead — the
  two paths produce byte-identical part files.

The produced intermediate part files are byte-compatible with the reference
format (record layouts at recode_writer.py:482-550).
"""

from __future__ import annotations

import math
import os
from datetime import datetime, timedelta
from pathlib import Path
from typing import Optional

import numpy as np

from . import codecs
from .constants import rc_cfg as rc
from .fileutils import read_file
from .header import ReCoDeHeader
from .oracle import label_components as _oracle_label
from .params import InitParams, InputParams
from .structures import ReCoDeStructures

_L2_STATISTIC_NAMES = {0: "max", 1: "max", 2: "sum"}
_L4_SCHEME_NAMES = {0: "weighted_average", 1: "weighted_average", 2: "max", 3: "unweighted"}

_MIN_BUCKET = 1 << 10


def _bucket_for(count: int, limit: int) -> int:
    """Smallest power-of-two >= count (and >= _MIN_BUCKET), capped at limit.

    ``count <= limit`` always (a frame has ``limit`` pixels), so the bucket
    holds every frame of the batch."""
    b = _MIN_BUCKET
    while b < count:
        b <<= 1
    return min(b, limit)


class ReCoDeWriter:
    """Encode a frame stream into a ReCoDe intermediate part file."""

    def __init__(self, image_filename, dark_data=None, dark_filename="", output_directory="",
                 input_params=None, params_filename="", mode="batch", validation_frame_gap=-1,
                 log_filename="recode.log", run_name="run", verbosity=0, use_device=True,
                 max_count=-1, chunk_time_in_sec=0, node_id=0, buffer_size_in_frames=32,
                 use_c=None, fast_deflate=True, use_tpu=None):
        """Parameters mirror the reference writer (recode_writer.py:26-66).

        ``node_id`` selects this writer's contiguous frame slice
        (``[node_id * ceil(nz / num_threads), ...)``, recode_writer.py:320-322)
        and names its part file.  ``buffer_size_in_frames`` is the encode batch
        size (frames per fused device call) and the output buffering unit.
        ``fast_deflate`` (default True; scheme 0 only) uses the native
        dynamic-Huffman sparse-deflate encoder instead of zlib: the output is
        still a valid zlib stream that every inflate (incl. the reference)
        decodes, ~18% smaller than zlib level 1 on sparse detector streams
        and faster to produce.  Set False for byte-identical-to-zlib output.
        ``use_device`` (default True) encodes on the accelerator; False
        selects the numpy oracle path (byte-identical output).  ``use_tpu``
        is accepted as an older alias of ``use_device``.
        """
        self._init_params = InitParams(
            mode, output_directory, image_filename=image_filename,
            calibration_filename=dark_filename, params_filename=params_filename,
            validation_frame_gap=validation_frame_gap, log_filename=log_filename,
            run_name=run_name, verbosity=verbosity, use_device=use_device, use_c=use_c,
            use_tpu=use_tpu,
            max_count=max_count, chunk_time_in_sec=chunk_time_in_sec)

        if input_params is None:
            self._input_params = InputParams()
            self._input_params.load(Path(self._init_params.params_filename))
        elif isinstance(input_params, dict):
            self._input_params = InputParams(input_params)
        else:
            self._input_params = input_params
        if not self._input_params.validate():
            raise ValueError("Invalid input params")

        # create the (intermediate) ReCoDe header
        self._rc_header = ReCoDeHeader()
        self._rc_header.create(self._init_params, self._input_params, is_intermediate=True)
        if self._input_params.source_file_type in (rc.FILE_TYPE_MRC, rc.FILE_TYPE_SEQ):
            self._rc_header.set("source_header_length", 1024)
        else:
            self._rc_header.set("source_header_length", 0)
        if self._init_params.verbosity > 0:
            self._rc_header.print()
        if not self._rc_header.validate():
            raise ValueError("Invalid ReCoDe header created")
        self._header = self._rc_header.as_dict()

        # load calibration frame and precompute the threshold = dark + epsilon
        self._src_dtype = self._input_params.source_numpy_dtype
        calibration = self._load_calibration(dark_data)
        if self._header["ny"] != calibration.shape[0] or self._header["nx"] != calibration.shape[1]:
            raise RuntimeError("Data and Calibration frames have different shapes")
        if calibration.dtype != self._src_dtype:
            calibration = calibration.astype(self._src_dtype)
        self._calibration_frame = calibration
        eps = self._input_params.calibration_threshold_epsilon
        # Saturate instead of wrapping: a dark pixel near the dtype max must
        # become a "never foreground" threshold, not wrap to ~0 and flag the
        # pixel permanently hot (the reference wraps, recode_writer.py:137 —
        # silent-corruption quirk we deliberately do not replicate).
        thr = calibration.astype(np.int64) + eps
        if np.issubdtype(self._src_dtype, np.integer):
            thr = np.minimum(thr, np.iinfo(self._src_dtype).max)
        self._threshold = thr.astype(self._src_dtype)

        self._node_id = node_id
        self._structures = ReCoDeStructures(self._header)
        self._reduction_level = int(self._header["reduction_level"])
        self._rc_operation_mode = int(self._header["rc_operation_mode"])
        self._bit_depth = int(self._input_params.source_bit_depth)
        self._l2_statistic = _L2_STATISTIC_NAMES[int(self._header["L2_statistics"])]
        self._l4_scheme = _L4_SCHEME_NAMES[int(self._header["L4_centroiding"])]
        self._batch_size = max(1, int(buffer_size_in_frames))

        scheme = int(self._header["compression_scheme"])
        self._scheme = scheme
        level = int(self._header["compression_level"])
        self._codec = codecs.get_codec(scheme, level) if self._rc_operation_mode == 1 else None
        if fast_deflate and scheme == 0 and self._codec is not None:
            from . import native

            if native.available():
                self._codec = codecs.Codec(0, "zlib-sparse-native",
                                           native.deflate_sparse,
                                           self._codec.decompress)

        import threading
        from concurrent.futures import ThreadPoolExecutor

        self._codec_local = threading.local()
        self._compression_pool = (
            ThreadPoolExecutor(max_workers=max(2, (os.cpu_count() or 4) // 2),
                               thread_name_prefix=f"rc-compress-{node_id}")
            if self._rc_operation_mode == 1 else None)

        self._intermediate_file = None
        self._intermediate_file_name = None
        self._validation_file = None
        self._validation_file_name = None
        self._is_first_chunk = True
        self._chunk_offset = 0
        self._num_frames_in_part = 0
        self._n_bytes_in_binary_image = self._structures.binary_image_sz_bytes
        self._out_buffer: list = []
        self._out_buffer_bytes = 0
        self._out_buffer_limit = None
        self._source = None
        self._source_shape = None

        # validation-frame counting ROI (central <=128x128 window,
        # recode_writer.py:236-240)
        nx, ny = int(self._header["nx"]), int(self._header["ny"])
        roi_nx, roi_ny = min(nx, 128), min(ny, 128)
        self._vc_roi = {
            "x_start": (nx - roi_nx) // 2, "y_start": (ny - roi_ny) // 2,
            "nx": roi_nx, "ny": roi_ny,
        }
        self._vc_n_pixels = roi_nx * roi_ny
        self._vc_dose_rate = 0.0

    # ------------------------------------------------------------------ setup

    def _load_calibration(self, dark_data) -> np.ndarray:
        if dark_data is not None:
            arr = np.asarray(dark_data)
        else:
            ftype = self._input_params.calibration_file_type
            fname = self._init_params.calibration_filename
            if ftype == rc.FILE_TYPE_BINARY:
                arr = read_file(fname, self._header["ny"], self._header["nx"], self._src_dtype)
            elif ftype in (rc.FILE_TYPE_MRC, rc.FILE_TYPE_SEQ):
                from .em_reader import emfile

                with emfile(fname, ftype) as reader:
                    arr = np.asarray(reader[0])
            else:
                raise NotImplementedError(
                    "No implementation available for loading calibration file of type 'Other'")
        if arr.ndim > 2:
            arr = np.squeeze(arr[0])
        return arr

    @property
    def part_file_name(self) -> Optional[str]:
        return self._intermediate_file_name

    def start(self, resume: bool = False, chunk_offset: int = 0) -> None:
        """Create the part file, serialize the header, set up buffers.

        With ``resume=True`` (stream-mode node replacement) an existing part
        file is *appended to* instead of truncated: the complete records
        already on disk are scanned to restore ``_num_frames_in_part``, any
        torn trailing record is dropped, and ``chunk_offset`` restores the
        global frame counter (the head node tracks it across completed
        chunks) so new frame_ids continue where the dead writer left off.
        """
        if self._init_params.mode == "batch":
            base_filename = Path(self._init_params.image_filename).stem
        else:
            base_filename = self._init_params.run_name

        self._intermediate_file_name = os.path.join(
            self._init_params.output_directory,
            f"{base_filename}.rc{self._reduction_level}_part{self._node_id:03d}")
        resumed = resume and self._resume_part_file(
            max_frame_id_exclusive=int(chunk_offset) if chunk_offset else None)
        if not resumed:
            self._intermediate_file = open(self._intermediate_file_name, "wb")
            self._rc_header.serialize_to(self._intermediate_file)
            self._intermediate_file.flush()
            self._num_frames_in_part = 0

        if self._init_params.validation_frame_gap > 0:
            self._validation_file_name = os.path.join(
                self._init_params.output_directory,
                f"{base_filename}_part{self._node_id:03d}_validation_frames.bin")
            self._validation_file = open(self._validation_file_name,
                                         "ab" if resumed else "wb")

        frame_bytes = int(self._header["ny"]) * int(self._header["nx"]) * np.dtype(self._src_dtype).itemsize
        self._out_buffer_limit = max(frame_bytes * self._batch_size, 1 << 20)
        self._chunk_offset = int(chunk_offset) if resumed else 0

    def _resume_part_file(self, max_frame_id_exclusive=None) -> bool:
        """Reopen an existing part file for append; restore frame count.

        Returns False (caller falls back to a fresh file) when the file is
        missing or its header is unreadable.

        ``max_frame_id_exclusive`` (the head node's completed-chunk frame
        counter) truncates the file at the first record whose frame_id
        belongs to the in-flight chunk: a worker hard-killed MID-chunk may
        have written complete records for part of its slice, and the
        replacement re-encodes the whole chunk — keeping those records
        would duplicate frame_ids in the merge.  Completed chunks' ids are
        all < the counter, the current chunk's all >= it.
        """
        path = self._intermediate_file_name
        if not os.path.exists(path):
            return False
        try:
            from .reader import ReCoDeReader

            scan = ReCoDeReader(path, is_intermediate=True)
            scan.open()
            end_pos = scan._frame_data_start_position
            if os.path.getsize(path) < end_pos:
                scan.close()
                return False  # torn inside the headers: start fresh
            n = 0
            while True:
                rec = scan.get_next_frame_raw(read_data=False)
                if rec is None:
                    break
                if max_frame_id_exclusive is not None and \
                        min(rec.keys()) >= max_frame_id_exclusive:
                    break  # in-flight chunk record: drop it and the rest
                n += 1
                end_pos = scan.get_file_position()
            scan.close()
        except Exception:
            return False
        self._intermediate_file = open(path, "r+b")
        self._intermediate_file.truncate(end_pos)
        self._intermediate_file.seek(end_pos)
        self._num_frames_in_part = n
        self._is_first_chunk = False  # source header is already on disk
        return True

    # -------------------------------------------------------------------- run

    def _do_sanity_checks(self, data=None) -> None:
        """Resolve the source shape and serialize the source header once."""
        if data is None:
            ftype = self._input_params.source_file_type
            if ftype in (rc.FILE_TYPE_MRC, rc.FILE_TYPE_SEQ):
                from .em_reader import emfile

                src = emfile(self._init_params.image_filename, ftype)
                self._source_shape = src.shape
                if self._is_first_chunk:
                    src.serialize_header(self._intermediate_file)
                    self._intermediate_file.flush()
                src.close()
            elif ftype == rc.FILE_TYPE_BINARY:
                self._source_shape = (self._header["nz"], self._header["ny"], self._header["nx"])
            else:
                raise NotImplementedError(
                    "No implementation available for loading source file of type 'Other'")
        else:
            self._source_shape = data.shape

        if self._source_shape[1] != self._header["ny"]:
            raise RuntimeError("Expected height does not match height in source file")
        if self._source_shape[2] != self._header["nx"]:
            raise RuntimeError("Expected width does not match width in source file")

        if self._input_params.num_frames == -1:
            self._header["nz"] = self._source_shape[0]
        elif self._input_params.num_frames > self._source_shape[0]:
            raise RuntimeError(
                "Number of frames requested in config file is larger than available in source file")
        else:
            self._header["nz"] = self._input_params.num_frames

    def run(self, data=None, profile_dir: Optional[str] = None) -> dict:
        """Encode this node's slice of the current chunk; returns run metrics.

        ``profile_dir`` captures a jax.profiler (TensorBoard/XProf) trace of
        the whole run — device kernels show up annotated per batch.
        """
        if profile_dir:
            from .profiling import trace

            with trace(profile_dir):
                return self._run_impl(data)
        return self._run_impl(data)

    def _run_impl(self, data=None) -> dict:
        run_metrics: dict = {}
        self._do_sanity_checks(data)
        self._is_first_chunk = False

        if self._init_params.mode == "batch":
            n_frames_in_chunk = int(self._header["nz"])
        else:
            n_frames_in_chunk = int(self._source_shape[0])

        num_threads = int(self._input_params.num_threads)
        n_frames_per_thread = int(math.ceil(n_frames_in_chunk / num_threads))
        frame_offset = self._node_id * n_frames_per_thread
        available_frames = min(n_frames_per_thread, max(n_frames_in_chunk - frame_offset, 0))

        stt = datetime.now()
        if data is None:
            data = self._read_source_slice(frame_offset, available_frames)
            available_frames = data.shape[0]
        else:
            data = data[frame_offset: frame_offset + available_frames]
        if data.dtype != self._src_dtype:
            data = data.astype(self._src_dtype)
        run_metrics["run_data_read_time"] = datetime.now() - stt

        run_start = datetime.now()
        zero = timedelta(0)
        for key in ("frame_thresholding_and_counting_time", "frame_binary_image_packing_time",
                    "frame_pixel_intensity_packing_time", "frame_binary_image_compression_time",
                    "frame_pixel_intensity_compression_time", "frame_time"):
            run_metrics[key] = zero

        # 1-batch lookahead pipeline: dispatch the (async) device encode for
        # batch k+1, then do batch k's host-side entropy coding and container
        # assembly while the device works
        pending = None
        for batch_start in range(0, available_frames, self._batch_size):
            batch = data[batch_start: batch_start + self._batch_size]
            n_in_batch = batch.shape[0]
            if n_in_batch < self._batch_size:
                # pad short final batches to the fixed shape: every distinct
                # batch size would otherwise compile a new device program
                pad = np.zeros((self._batch_size - n_in_batch, *batch.shape[1:]),
                               dtype=batch.dtype)
                batch = np.concatenate([batch, pad], axis=0)
            first_abs_index = self._chunk_offset + frame_offset + batch_start
            stt = datetime.now()
            dispatched = self._dispatch_encode(batch)
            run_metrics["frame_thresholding_and_counting_time"] += datetime.now() - stt
            if pending is not None:
                self._finish_batch(*pending, run_metrics)
            pending = (first_abs_index, dispatched, n_in_batch)
        if pending is not None:
            self._finish_batch(*pending, run_metrics)

        self._flush_out_buffer()

        # validation frames + dose-rate telemetry (recode_writer.py:402-415)
        if self._init_params.validation_frame_gap > 0:
            gap = self._init_params.validation_frame_gap
            for i in range(available_frames):
                abs_index = self._chunk_offset + frame_offset + i
                if abs_index % gap == 0:
                    self._validation_file.write(np.ascontiguousarray(data[i]).tobytes())
                    roi = self._vc_roi
                    vframe = data[i][roi["y_start"]: roi["y_start"] + roi["ny"],
                                     roi["x_start"]: roi["x_start"] + roi["nx"]]
                    vmask = vframe > self._threshold[roi["y_start"]: roi["y_start"] + roi["ny"],
                                                     roi["x_start"]: roi["x_start"] + roi["nx"]]
                    _, num_features = _oracle_label(vmask)
                    self._vc_dose_rate = num_features / self._vc_n_pixels
                    run_metrics.setdefault("run_dose_rates", []).append(self._vc_dose_rate)

        self._chunk_offset += n_frames_in_chunk
        self._num_frames_in_part += available_frames
        run_metrics["run_time"] = datetime.now() - run_start
        run_metrics["run_frames"] = available_frames
        return run_metrics

    def _read_source_slice(self, frame_offset: int, available_frames: int) -> np.ndarray:
        ftype = self._input_params.source_file_type
        if ftype == rc.FILE_TYPE_BINARY:
            ny, nx = int(self._header["ny"]), int(self._header["nx"])
            frame_bytes = ny * nx * np.dtype(self._src_dtype).itemsize
            offset = self._input_params.source_header_length + frame_offset * frame_bytes
            with open(self._init_params.image_filename, "rb") as f:
                f.seek(offset)
                raw = f.read(available_frames * frame_bytes)
            n = len(raw) // frame_bytes
            return np.frombuffer(raw[: n * frame_bytes], dtype=self._src_dtype).reshape(n, ny, nx)
        from .em_reader import emfile

        with emfile(self._init_params.image_filename, ftype) as f:
            try:
                return np.asarray(f[frame_offset: frame_offset + available_frames])
            except IndexError:
                frames = []
                for i in range(available_frames):
                    try:
                        frames.append(np.squeeze(f[frame_offset + i]))
                    except IndexError:
                        break
                return np.asarray(frames)

    # ------------------------------------------------------------ batch encode

    def _dispatch_encode(self, batch: np.ndarray):
        """Launch the device encode without waiting for it (JAX dispatch is
        async); returns whatever _materialize_streams understands.

        The foreground-count prepass sizes ``max_values``, so the encode
        cannot overflow.  Dispatch returns before the device finishes, which
        lets the device encode batch k+1 overlap batch k's host
        compression."""
        if not self._init_params.use_device:
            return ("host", self._encode_batch_oracle(batch))
        from . import ops

        n_pixels = int(self._header["ny"]) * int(self._header["nx"])
        counts = np.asarray(ops.count_foreground(batch, self._threshold))
        bucket = _bucket_for(int(counts.max()) if counts.size else 0, n_pixels)
        res = ops.encode_frames(
            batch, self._threshold, reduction_level=self._reduction_level,
            bit_depth=self._bit_depth, max_values=bucket,
            l2_statistic=self._l2_statistic, l4_scheme=self._l4_scheme)
        return ("device", res)

    def _materialize_streams(self, dispatched):
        """Resolve a dispatched encode to per-frame (bitmap_bytes,
        pixvals_bytes|None) streams for host entropy coding."""
        kind, res = dispatched
        if kind == "host":
            return res
        bitmaps = np.asarray(res.bitmap)
        if res.packed is None:
            return [(bm.tobytes(), None) for bm in bitmaps]
        packed = np.asarray(res.packed)
        packed_len = np.asarray(res.packed_len)
        return [(bitmaps[i].tobytes(), packed[i][: int(packed_len[i])].tobytes())
                for i in range(bitmaps.shape[0])]

    def _finish_batch(self, first_abs_index: int, dispatched,
                      n_in_batch: int, run_metrics: dict) -> None:
        stt = datetime.now()
        streams = self._materialize_streams(dispatched)[:n_in_batch]
        if self._rc_operation_mode == 1 and self._compression_pool is not None \
                and len(streams) > 1:
            records = self._assemble_records_parallel(first_abs_index, streams, run_metrics)
        else:
            records = [
                self._assemble_record(first_abs_index + i, bitmap, pixvals, run_metrics)
                for i, (bitmap, pixvals) in enumerate(streams)
            ]
        for record in records:
            self._out_buffer.append(record)
            self._out_buffer_bytes += len(record)
            if self._out_buffer_bytes >= self._out_buffer_limit:
                self._flush_out_buffer()
        run_metrics["frame_time"] += datetime.now() - stt

    def _assemble_records_parallel(self, first_abs_index: int, streams, run_metrics):
        """Entropy-compress a batch's frames on the pool (order preserved).

        zlib/zstd/bz2/lzma release the GIL, so frame-level fan-out scales the
        host entropy stage — the analogue of the reference's N compressing
        processes, but per batch inside one writer.  zstd contexts are not
        thread-safe, so each task builds on the per-thread codec cache.
        """
        compress = self._codec_for_thread
        # scheme 12 + L1: pixel values are coded as bit_depth-wide symbols
        # (codecs/rans.compress_symbols) — detector residuals are peaked, and
        # the direct-symbol model recovers the ~1 bit/value the byte-granular
        # model loses to pack-phase misalignment; the stream is
        # self-describing (flags bit1), so the generic decompress reads it
        sym_bits = self._bit_depth if (
            self._scheme == 12 and self._reduction_level == 1
            and 9 <= self._bit_depth <= 16) else 0
        sym12 = self._scheme == 12

        def work(args):
            index, (bitmap, pixvals) = args
            codec = compress()
            t0 = datetime.now()
            if sym12:
                # gap transform (flags 2|4): one symbol per SET BIT instead
                # of one per byte — identical entropy (size-neutral at 1%
                # occupancy) but ~1/occupancy fewer symbols through the
                # serial rANS chain; compress_gaps falls back to the
                # byte-symbol coder when gaps cannot win (dense/empty maps)
                from .codecs import rans as _rans

                cbm = _rans.compress_gaps(bitmap)
            else:
                cbm = codec.compress(bitmap)
            t1 = datetime.now()
            if pixvals is None:
                cpx = None
            elif sym_bits:
                from .codecs import rans as _rans

                cpx = _rans.compress_symbols(pixvals, sym_bits)
            elif sym12:
                from .codecs import rans as _rans

                cpx = _rans.compress_symbols(pixvals, 8)
            else:
                cpx = codec.compress(pixvals)
            t2 = datetime.now()
            return index, bitmap, pixvals, cbm, cpx, t1 - t0, t2 - t1

        results = list(self._compression_pool.map(work, enumerate(streams)))
        records = []
        # Per-stage times measured inside each pool task (the reference times
        # each stage truly, recode_writer.py:497-550); summed task durations
        # are the cumulative-work analogue under thread fan-out.
        for index, bitmap, pixvals, cbm, cpx, t_bm, t_px in results:
            run_metrics["frame_binary_image_compression_time"] += t_bm
            run_metrics["frame_pixel_intensity_compression_time"] += t_px
            frame_id = int(first_abs_index + index).to_bytes(4, "little")
            if self._reduction_level in (1, 2):
                records.append(frame_id
                               + len(cbm).to_bytes(4, "little")
                               + len(cpx).to_bytes(4, "little")
                               + len(pixvals).to_bytes(4, "little")
                               + cbm + cpx)
            else:
                records.append(frame_id + len(cbm).to_bytes(4, "little") + cbm)
        return records

    def _codec_for_thread(self):
        """Per-thread codec (zstd compressor contexts are not shareable)."""
        if self._codec is not None and self._codec.name == "zlib-sparse-native":
            return self._codec  # stateless, thread-safe
        cache = getattr(self._codec_local, "codec", None)
        if cache is None:
            cache = codecs.get_codec(int(self._header["compression_scheme"]),
                                     int(self._header["compression_level"]))
            self._codec_local.codec = cache
        return cache

    def _encode_batch_oracle(self, batch: np.ndarray):
        from . import oracle

        out = []
        for i in range(batch.shape[0]):
            enc = oracle.reduce_frame(
                batch[i], self._threshold, self._reduction_level, self._bit_depth,
                l2_statistic=self._l2_statistic, l4_scheme=self._l4_scheme)
            out.append((enc["packed_binary_map"], enc["packed_pixvals"]))
        return out

    # -------------------------------------------------------- record assembly

    def _assemble_record(self, abs_index: int, bitmap: bytes, pixvals: Optional[bytes],
                         run_metrics: dict) -> bytes:
        """Build one intermediate-file frame record (recode_writer.py:482-550)."""
        level, mode = self._reduction_level, self._rc_operation_mode
        frame_id = int(abs_index).to_bytes(4, "little")

        if mode == 0:
            if level in (1, 2):
                return frame_id + len(pixvals).to_bytes(4, "little") + bitmap + pixvals
            return frame_id + bitmap

        # mode 1: reduce + compress
        stt = datetime.now()
        compressed_bitmap = self._codec.compress(bitmap)
        run_metrics["frame_binary_image_compression_time"] += datetime.now() - stt
        if level in (1, 2):
            stt = datetime.now()
            compressed_pixvals = self._codec.compress(pixvals)
            run_metrics["frame_pixel_intensity_compression_time"] += datetime.now() - stt
            return (frame_id
                    + len(compressed_bitmap).to_bytes(4, "little")
                    + len(compressed_pixvals).to_bytes(4, "little")
                    + len(pixvals).to_bytes(4, "little")
                    + compressed_bitmap + compressed_pixvals)
        return frame_id + len(compressed_bitmap).to_bytes(4, "little") + compressed_bitmap

    def _flush_out_buffer(self) -> None:
        if self._out_buffer:
            self._intermediate_file.write(b"".join(self._out_buffer))
            self._intermediate_file.flush()
            self._out_buffer.clear()
            self._out_buffer_bytes = 0

    # ------------------------------------------------------------------ close

    def close(self) -> None:
        """Flush, patch the true frame count into the header, close files."""
        self._flush_out_buffer()
        self._rc_header.update("nz", self._num_frames_in_part)
        self._intermediate_file.seek(0)
        self._rc_header.serialize_to(self._intermediate_file)
        self._intermediate_file.close()
        if self._validation_file is not None:
            self._validation_file.close()
        if self._compression_pool is not None:
            self._compression_pool.shutdown(wait=False)


def print_run_metrics(run_metrics: dict) -> None:
    """Pretty-print per-frame metrics (reference recode_writer.py:610-618)."""
    for key, value in run_metrics.items():
        if key.startswith("frame_"):
            frames = max(run_metrics.get("run_frames", 1), 1)
            total = run_metrics.get("frame_time")
            fraction = value / total if total else float("nan")
            print(key, "\t", value / frames, "\t", fraction)
        elif key == "run_dose_rates":
            print(key, "\t", value, "\t", "Avg.=", np.mean(value))
        else:
            print(key, "\t", value)
