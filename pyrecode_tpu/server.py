"""ReCoDeServer: multi-node orchestration for batch and stream acquisition.

Capability parity with the reference server stack (recode_server.py:54-773):
``ReCoDeServer.run`` drives N ``ReCoDeNode`` workers plus a ``Logger``
through the ack-verified command sequence start -> process_file* -> close,
with the node status lifecycle NOT_READY -> AVAILABLE -> BUSY -> ... ->
IS_CLOSED (misc.py:14-21), reliable broadcast with retries
(recode_server.py:408-455), a stream mode that watches a directory for chunk
files and renames the oldest to ``Next_Stream.seq`` for the nodes
(recode_server.py:463-564), and a logger that formats records live and
flushes them to a file on close (recode_server.py:203-293).

Re-architecture around the accelerator (SURVEY.md §2.3): the reference
forks N OS processes that each encode on CPU and talk over ZMQ TCP loopback.
A JAX process reserves most of a card's memory when it first uses it, so one
process owns the card, and here the nodes are *threads* sharing the one JAX
runtime — the real data parallelism happens on the device mesh
inside the batched encode, while threads overlap host-side entropy coding
and file IO (all release the GIL).  The ZMQ sockets become in-process
queues carrying the same ``MessageData`` envelopes with the same
session/request-id/ack validation, so the observable protocol, statuses,
log records and on-disk outputs match the reference; ``merge_parts`` and the
live viewer consume the part files identically.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import traceback
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .constants import rc_cfg as rc
from .params import InitParams, InputParams
from .writer import ReCoDeWriter


class MessageData:
    """JSON message envelope (reference recode_server.py:54-115)."""

    def __init__(self, session_id, message_type, message, mapped_data=None):
        self._payload = {
            "session_id": session_id,
            "type": message_type,
            "message": message,
            "mapped_data": dict(mapped_data or {}),
        }
        self._payload["mapped_data"].setdefault("timestamp", datetime.now().isoformat())

    @property
    def session_id(self):
        return self._payload["session_id"]

    @property
    def type(self):
        return self._payload["type"]

    @property
    def message(self):
        return self._payload["message"]

    @property
    def mapped_data(self):
        return self._payload["mapped_data"]

    def get(self, key, default=None):
        return self._payload["mapped_data"].get(key, default)

    def set(self, key, value):
        self._payload["mapped_data"][key] = value

    def serialize(self) -> str:
        return json.dumps(self._payload)

    @classmethod
    def parse(cls, raw: str) -> "MessageData":
        d = json.loads(raw)
        msg = cls(d["session_id"], d["type"], d["message"], d.get("mapped_data"))
        return msg

    def __repr__(self):
        return f"MessageData({self._payload})"


class NodeToken:
    """Addressing record for one node (reference recode_server.py:118-145).

    The reference stores host/port of the node's ZMQ REP socket; here the
    address is the node's command queue.
    """

    def __init__(self, node_id: int, command_queue: "queue.Queue",
                 reply_queue: "queue.Queue"):
        self.node_id = node_id
        self.command_queue = command_queue
        self.reply_queue = reply_queue


class NodeClient:
    """Head-side client for one node: sends a request, validates the ack
    (session id + request id + ack type), reference recode_server.py:148-200."""

    def __init__(self, token: NodeToken, session_id: str, timeout: float = 5.0):
        self._token = token
        self._session_id = session_id
        self._timeout = timeout

    def send_request(self, message: str, mapped_data=None) -> bool:
        request_id = f"{self._token.node_id}-{time.monotonic_ns()}"
        md = MessageData(self._session_id, rc.MESSAGE_TYPE_INFO, message, mapped_data)
        md.set("request_id", request_id)
        # drop stale acks from a previous timed-out request (a slow worker
        # may ack after the head already gave up and retried)
        try:
            while True:
                self._token.reply_queue.get_nowait()
        except queue.Empty:
            pass
        self._token.command_queue.put(md.serialize())
        try:
            raw = self._token.reply_queue.get(timeout=self._timeout)
        except queue.Empty:
            return False
        ack = MessageData.parse(raw)
        return (
            ack.session_id == self._session_id
            and ack.get("request_id") == request_id
            and ack.type == rc.MESSAGE_TYPE_ACK
        )


class Logger:
    """Log sink: all nodes push records to one queue; a dedicated thread
    prints them live and flushes to the log file on close
    (reference recode_server.py:203-293)."""

    def __init__(self, session_id: str, log_filename: str = "recode.log"):
        self._session_id = session_id
        self._log_filename = log_filename
        self.queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._records: List[str] = []
        self._thread: Optional[threading.Thread] = None
        self._echo = True

    def start(self, echo: bool = True) -> None:
        self._echo = echo
        self._thread = threading.Thread(target=self._run, name="recode-logger", daemon=True)
        self._thread.start()

    def push(self, source: str, message: str, message_type=rc.MESSAGE_TYPE_INFO) -> None:
        md = MessageData(self._session_id, message_type, message, {"source": source})
        self.queue.put(md.serialize())

    def _run(self) -> None:
        while True:
            raw = self.queue.get()
            if raw is None:
                break
            md = MessageData.parse(raw)
            line = f"[{md.get('timestamp')}] [{md.get('source', '?')}] {md.message}"
            self._records.append(line)
            if self._echo:
                print(line)

    def close(self) -> None:
        self.queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._log_filename:
            Path(self._log_filename).parent.mkdir(parents=True, exist_ok=True)
            with open(self._log_filename, "a") as fp:
                for line in self._records:
                    fp.write(line + "\n")


class ReCoDeNode:
    """Worker: owns one ReCoDeWriter/part file; executes the command state
    machine start / process_file / close (reference recode_server.py:567-736)."""

    def __init__(self, node_id: int, init_params: InitParams, input_params: InputParams,
                 logger: Logger, session_id: str, fail_on_command: Optional[str] = None,
                 resume: bool = False, resume_chunk_offset: int = 0):
        self.node_id = node_id
        self._init_params = init_params
        self._input_params = input_params
        self._logger = logger
        self._session_id = session_id
        # fault injection for recovery tests: die on the nth occurrence of a
        # command — either "cmd" (first occurrence) or ("cmd", n)
        if isinstance(fail_on_command, tuple):
            self._fail_command, self._fail_at_occurrence = fail_on_command
        else:
            self._fail_command, self._fail_at_occurrence = fail_on_command, 1
        # stream-mode replacement: append to the existing part file instead
        # of truncating it, continuing frame_ids at resume_chunk_offset
        self._resume = resume
        self._resume_chunk_offset = resume_chunk_offset
        self._writer: Optional[ReCoDeWriter] = None
        self._dark_data = None
        self._data = None
        self.status = rc.STATUS_CODE_NOT_READY
        self.run_metrics: dict = {}
        self.token = NodeToken(node_id, queue.Queue(), queue.Queue())
        self._thread: Optional[threading.Thread] = None

    def start_thread(self, dark_data=None, data=None) -> None:
        self._dark_data = dark_data
        self._data = data
        self._thread = threading.Thread(target=self.run, name=f"recode-node-{self.node_id}",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout=None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _log(self, message, message_type=rc.MESSAGE_TYPE_INFO):
        self._logger.push(f"node-{self.node_id}", message, message_type)

    def _send_ack(self, request: MessageData) -> None:
        ack = MessageData(self._session_id, rc.MESSAGE_TYPE_ACK, "ack",
                          {"request_id": request.get("request_id")})
        self.token.reply_queue.put(ack.serialize())

    def run(self) -> None:
        """Command loop; mirrors recode_server.py:630-679."""
        self.status = rc.STATUS_CODE_AVAILABLE
        while True:
            raw = self.token.command_queue.get()
            request = MessageData.parse(raw)
            if request.session_id != self._session_id:
                self._log(f"rejected message from session {request.session_id}",
                          rc.MESSAGE_TYPE_ERROR)
                continue
            command = request.message
            self.status = rc.STATUS_CODE_BUSY
            if command == self._fail_command:
                self._fail_at_occurrence -= 1
                if self._fail_at_occurrence <= 0:
                    self._fail_command = None
                    self._log(f"injected fault on '{command}'", rc.MESSAGE_TYPE_ERROR)
                    self.status = rc.STATUS_CODE_ERROR
                    return
            try:
                if command == "start":
                    self._open()
                    self._start()
                    self._send_ack(request)
                    self.status = rc.STATUS_CODE_AVAILABLE
                elif command == "process_file":
                    self._send_ack(request)
                    self._process_file(request)
                    self.status = rc.STATUS_CODE_AVAILABLE
                elif command == "close":
                    self._close()
                    self._send_ack(request)
                    self.status = rc.STATUS_CODE_IS_CLOSED
                    return
                else:
                    self._log(f"unknown command: {command}", rc.MESSAGE_TYPE_ERROR)
                    self._send_ack(request)
                    self.status = rc.STATUS_CODE_AVAILABLE
            except Exception:
                self._log(traceback.format_exc(), rc.MESSAGE_TYPE_ERROR)
                self.status = rc.STATUS_CODE_ERROR
                return

    def _open(self) -> None:
        image_filename = self._init_params.image_filename
        if self._init_params.mode == "stream":
            image_filename = os.path.join(self._init_params.directory_path, "Next_Stream.seq")
        self._writer = ReCoDeWriter(
            image_filename,
            dark_data=self._dark_data,
            dark_filename=self._init_params.calibration_filename,
            output_directory=self._init_params.output_directory,
            input_params=self._input_params,
            mode=self._init_params.mode,
            validation_frame_gap=self._init_params.validation_frame_gap,
            log_filename=self._init_params.log_filename,
            run_name=self._init_params.run_name,
            verbosity=self._init_params.verbosity,
            use_device=self._init_params.use_device,
            node_id=self.node_id)
        self._log("writer created")

    def _start(self) -> None:
        self._writer.start(resume=self._resume,
                           chunk_offset=self._resume_chunk_offset)
        self._log("writer started" + (" (resumed)" if self._resume else ""))

    def _process_file(self, request: MessageData) -> None:
        metrics = self._writer.run(self._data)
        for key, value in metrics.items():
            if key in self.run_metrics:
                try:
                    self.run_metrics[key] += value
                except TypeError:
                    self.run_metrics[key] = value
            else:
                self.run_metrics[key] = value
        self._log(f"processed chunk ({metrics.get('run_frames', 0)} frames)")

    def _close(self) -> None:
        self._writer.close()
        self._log("writer closed")

    def completed_chunk_offset(self) -> int:
        """Cumulative frame count of chunks this node has fully written."""
        w = self._writer
        return int(w._chunk_offset) if w is not None else 0


# -------------------------------------------------- crash-isolated workers


def _process_node_main(node_id, init_params, input_params, session_id,
                       command_q, reply_q, log_q, status_val, chunk_off_val,
                       metrics_q, dark_data, data, fail_on_command,
                       resume, resume_chunk_offset):
    """Entry point of a crash-isolated worker (``isolation="process"``).

    Runs the same ``ReCoDeNode`` state machine as the thread mode, but in
    its own OS process: a segfault in native code, an OOM kill, or a
    SIGKILL takes down only this worker — the head node detects the death
    (liveness + status), spawns a replacement, and the part-file resume
    machinery recovers (reference nodes are OS processes too,
    recode_server.py:350-363, with the replacement left as a stub).

    Workers encode on the HOST path (``use_device=False``) by design:
    process isolation trades device batching for crash containment.  The
    card belongs to the head process — a JAX process reserves most of a
    card's memory when it first uses it, so a second process on the same
    card would fail for want of memory.
    """
    # Never touch the card: pin this process to the CPU before anything can
    # call jax.devices() (the variable also covers its own subprocesses).
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")
    init_params._use_device = False

    class _MPLogger:
        @staticmethod
        def push(source, message, message_type=rc.MESSAGE_TYPE_INFO):
            try:
                log_q.put((source, message, message_type))
            except Exception:
                pass

    class _SharedStatusNode(ReCoDeNode):
        @property
        def status(self):
            return status_val.value

        @status.setter
        def status(self, value):
            status_val.value = int(value)

        def _process_file(self, request):
            super()._process_file(request)
            chunk_off_val.value = self.completed_chunk_offset()

    node = _SharedStatusNode(node_id, init_params, input_params, _MPLogger(),
                             session_id, fail_on_command=fail_on_command,
                             resume=resume,
                             resume_chunk_offset=resume_chunk_offset)
    node.token = NodeToken(node_id, command_q, reply_q)
    node._dark_data = dark_data
    node._data = data
    try:
        node.run()
    finally:
        try:
            metrics_q.put(node.run_metrics)
        except Exception:
            pass


class ProcessNodeHandle:
    """Head-side handle of a crash-isolated worker; duck-types ReCoDeNode
    (token / status / start_thread / join / run_metrics /
    completed_chunk_offset) so the broadcast, replacement, and queue-manager
    machinery is shared between the thread and process modes."""

    def __init__(self, node_id: int, init_params: InitParams,
                 input_params: InputParams, log_queue, session_id: str,
                 fail_on_command=None, resume: bool = False,
                 resume_chunk_offset: int = 0):
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self.node_id = node_id
        self._init_params = init_params
        self._input_params = input_params
        self._log_queue = log_queue
        self._session_id = session_id
        self._fail_on_command = fail_on_command
        self._resume = resume
        self._resume_chunk_offset = resume_chunk_offset
        self._status = self._ctx.Value("i", rc.STATUS_CODE_NOT_READY)
        self._chunk_off = self._ctx.Value("i", int(resume_chunk_offset))
        self._metrics_q = self._ctx.Queue()
        self.token = NodeToken(node_id, self._ctx.Queue(), self._ctx.Queue())
        self._proc = None
        self._forced_status: Optional[int] = None
        self.run_metrics: dict = {}

    def start_thread(self, dark_data=None, data=None) -> None:
        """Name-parity with ReCoDeNode; starts the worker *process*."""
        self._proc = self._ctx.Process(
            target=_process_node_main,
            args=(self.node_id, self._init_params, self._input_params,
                  self._session_id, self.token.command_queue,
                  self.token.reply_queue, self._log_queue, self._status,
                  self._chunk_off, self._metrics_q, dark_data, data,
                  self._fail_on_command, self._resume,
                  self._resume_chunk_offset),
            daemon=True, name=f"recode-node-{self.node_id}")
        self._proc.start()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    @property
    def status(self) -> int:
        if self._forced_status is not None:
            return self._forced_status
        value = self._status.value
        if (self._proc is not None and not self._proc.is_alive()
                and value != rc.STATUS_CODE_IS_CLOSED):
            return rc.STATUS_CODE_ERROR   # died without closing
        return value

    @status.setter
    def status(self, value) -> None:
        # the head only ever forces ERROR on an unresponsive node
        self._forced_status = int(value)

    def completed_chunk_offset(self) -> int:
        return int(self._chunk_off.value)

    def join(self, timeout=None) -> None:
        if self._proc is not None:
            self._proc.join(timeout)
        try:
            while True:
                self.run_metrics = self._metrics_q.get_nowait()
        except queue.Empty:
            pass
        except Exception:
            pass


class ReCoDeServer:
    """Head node: orchestrates N nodes + logger for batch or stream runs."""

    def __init__(self, mode: str = "batch", isolation: str = "thread"):
        """``isolation``: "thread" (default — nodes share the process and
        the JAX runtime; a Python-level node failure is recovered in place)
        or "process" (each node is a spawned OS process on the host encode
        path — a hard crash/SIGKILL of a worker cannot take down the head,
        which detects the death and resumes the part file; matches the
        reference's process-per-node resilience, recode_server.py:350-363).
        """
        self._mode = str(mode).strip().lower()
        self._isolation = str(isolation).strip().lower()
        if self._isolation not in ("thread", "process"):
            raise ValueError("isolation must be 'thread' or 'process'")
        self._max_attempts = 10
        self._session_id = f"rc-{os.getpid()}-{int(time.time())}"

    # ------------------------------------------------------------------- run

    def run(self, init_params: InitParams, input_params: Optional[InputParams] = None,
            dark_data=None, data=None, fail_node_ids=(), fail_node_on_command=None
            ) -> Dict[int, dict]:
        """Run a full acquisition; returns per-node run metrics.

        Mirrors reference recode_server.py:297-403: load/validate params,
        spawn nodes + logger, broadcast start / process_file / close with
        ack validation, join, return metrics.  ``fail_node_ids`` /
        ``fail_node_on_command`` inject one fault per listed node for
        recovery testing.
        """
        if input_params is None:
            input_params = InputParams()
            input_params.load(Path(init_params.params_filename))
        if not input_params.validate():
            raise ValueError("Invalid input params")

        logger = Logger(self._session_id, init_params.log_filename)
        logger.start(echo=init_params.verbosity > 0)
        logger.push("head", f"session {self._session_id} starting "
                            f"({input_params.num_threads} nodes, mode={self._mode})")

        self._log_mp_queue = None
        self._log_drainer = None
        if self._isolation == "process":
            import multiprocessing as mp

            self._log_mp_queue = mp.get_context("spawn").Queue()
            self._log_drainer = threading.Thread(
                target=self._drain_worker_logs, args=(logger,),
                name="recode-log-drain", daemon=True)
            self._log_drainer.start()
            nodes = [
                ProcessNodeHandle(
                    i, init_params, input_params, self._log_mp_queue,
                    self._session_id,
                    fail_on_command=fail_node_on_command if i in fail_node_ids else None)
                for i in range(int(input_params.num_threads))
            ]
        else:
            nodes = [
                ReCoDeNode(i, init_params, input_params, logger, self._session_id,
                           fail_on_command=fail_node_on_command if i in fail_node_ids else None)
                for i in range(int(input_params.num_threads))
            ]
        self._nodes = nodes  # exposed for tests/monitoring
        for node in nodes:
            node.start_thread(dark_data=dark_data, data=data)
        client_timeout = 30.0 if self._isolation == "process" else 5.0
        clients = [NodeClient(node.token, self._session_id, timeout=client_timeout)
                   for node in nodes]
        self._client_timeout = client_timeout
        self._dark_data, self._data = dark_data, data
        self._init_params_live, self._input_params_live = init_params, input_params

        try:
            self._broadcast(clients, nodes, "start", logger)
            if self._mode == "batch":
                self._broadcast(clients, nodes, "process_file", logger)
                self._wait_until_available(nodes)
                # recover nodes that died mid-processing (one retry round):
                # replace, restart, and re-encode their whole slice
                for index, node in enumerate(nodes):
                    if node.status == rc.STATUS_CODE_ERROR:
                        self._spawn_replacement_node(index, clients, nodes, logger)
                        clients[index].send_request("process_file")
                self._wait_until_available(nodes)
            else:
                self._recode_queue_manager(clients, nodes, init_params, logger)
            self._broadcast(clients, nodes, "close", logger)
        finally:
            for node in nodes:
                node.join(timeout=30)
            if self._log_mp_queue is not None:
                self._log_mp_queue.put(None)
                if self._log_drainer is not None:
                    self._log_drainer.join(timeout=10)
            logger.push("head", "session closed")
            logger.close()

        return {node.node_id: node.run_metrics for node in nodes}

    def _drain_worker_logs(self, logger: Logger) -> None:
        """Forward worker-process log records into the head's Logger."""
        while True:
            try:
                record = self._log_mp_queue.get()
            except Exception:
                return
            if record is None:
                return
            try:
                source, message, message_type = record
                logger.push(source, message, message_type)
            except Exception:
                pass

    # -------------------------------------------------------------- broadcast

    def _broadcast(self, clients: List[NodeClient], nodes: List[ReCoDeNode],
                   message: str, logger: Logger, retry_delay: float = 0.2) -> None:
        """Reliable broadcast: retry un-acked sends, replace dead nodes.

        The reference marks unresponsive nodes ERROR and leaves
        ``_spawn_replacement_node`` as an empty stub (recode_server.py:405,
        418-440); here the replacement is implemented: a dead node's worker
        is rebuilt with the same node id, restarted, and the failed command
        replayed (for ``process_file`` the replacement re-encodes the node's
        whole slice — its part file is recreated from the header on, so no
        partial output survives)."""
        pending = list(range(len(clients)))
        replaced = set()
        for _ in range(self._max_attempts):
            failed = []
            for index in pending:
                if nodes[index].status == rc.STATUS_CODE_ERROR and index not in replaced:
                    self._spawn_replacement_node(index, clients, nodes, logger)
                    replaced.add(index)
                if not clients[index].send_request(message):
                    failed.append(index)
            if not failed:
                return
            pending = failed
            time.sleep(retry_delay)
        for index in pending:
            nodes[index].status = rc.STATUS_CODE_ERROR
            logger.push("head", f"node-{index} unresponsive after "
                                f"{self._max_attempts} attempts", rc.MESSAGE_TYPE_ERROR)

    def _spawn_replacement_node(self, index: int, clients: List[NodeClient],
                                nodes: List[ReCoDeNode], logger: Logger) -> None:
        """Rebuild a failed node in place and bring it back to AVAILABLE.

        Batch mode restarts the part file from the header (the whole slice is
        re-encoded).  Stream mode must NOT truncate: earlier chunks' source
        files are already deleted, so the replacement writer appends to the
        existing part file and continues frame_ids from the head node's
        completed-chunk frame counter.
        """
        logger.push("head", f"spawning replacement for node-{index}",
                    rc.MESSAGE_TYPE_ERROR)
        resume = self._mode == "stream"
        if self._isolation == "process":
            replacement = ProcessNodeHandle(
                index, self._init_params_live, self._input_params_live,
                self._log_mp_queue, self._session_id, resume=resume,
                resume_chunk_offset=getattr(self, "_stream_chunk_offset", 0))
        else:
            replacement = ReCoDeNode(
                index, self._init_params_live, self._input_params_live,
                logger, self._session_id, resume=resume,
                resume_chunk_offset=getattr(self, "_stream_chunk_offset", 0))
        replacement.start_thread(dark_data=self._dark_data, data=self._data)
        nodes[index] = replacement
        clients[index] = NodeClient(replacement.token, self._session_id,
                                    timeout=getattr(self, "_client_timeout", 5.0))
        clients[index].send_request("start")

    @staticmethod
    def _wait_until_available(nodes: List[ReCoDeNode], timeout: float = 3600.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            states = {node.status for node in nodes}
            if states <= {rc.STATUS_CODE_AVAILABLE, rc.STATUS_CODE_IS_CLOSED,
                          rc.STATUS_CODE_ERROR}:
                return True
            time.sleep(0.01)
        return False

    # ----------------------------------------------------------- stream mode

    def _recode_queue_manager(self, clients, nodes, init_params: InitParams,
                              logger: Logger) -> None:
        """Directory-watch queue manager (reference recode_server.py:463-564).

        Chunk files appearing in ``directory_path`` are renamed (oldest
        first) to ``Next_Stream.seq``, the nodes are told to process it, and
        the consumed chunk is deleted — so a crash loses at most one chunk.
        """
        watch_dir = Path(init_params.directory_path)
        next_name = watch_dir / "Next_Stream.seq"
        max_count = init_params.max_count if init_params.max_count > 0 else float("inf")
        idle_timeout = max(15.0, float(init_params.chunk_time_in_sec) + 1.0)

        processed = 0
        # cumulative frames of COMPLETED chunks — the authoritative resume
        # point for a stream-mode replacement writer's frame counter
        self._stream_chunk_offset = 0
        idle_since = time.monotonic()
        while processed < max_count:
            chunks = sorted(
                (p for p in watch_dir.glob("*.seq") if p.name != "Next_Stream.seq"),
                key=lambda p: p.stat().st_mtime)
            if not chunks:
                if time.monotonic() - idle_since > idle_timeout:
                    logger.push("head", "stream idle timeout; stopping")
                    break
                time.sleep(0.05)
                continue
            idle_since = time.monotonic()
            chunk = chunks[0]
            os.replace(chunk, next_name)
            self._broadcast(clients, nodes, "process_file", logger)
            if not self._wait_until_available(nodes, timeout=idle_timeout):
                logger.push("head", "nodes unresponsive during stream",
                            rc.MESSAGE_TYPE_ERROR)
                break
            # a node that died DURING the chunk (after acking — e.g. a
            # hard-killed worker process) surfaces here as ERROR: replace
            # it and have only the replacement redo the current chunk (the
            # chunk file still exists; its part file resumes at the
            # completed-chunk boundary, so no duplicate records)
            for index, node in enumerate(nodes):
                if node.status == rc.STATUS_CODE_ERROR:
                    self._spawn_replacement_node(index, clients, nodes, logger)
                    clients[index].send_request("process_file")
            if not self._wait_until_available(nodes, timeout=idle_timeout):
                logger.push("head", "nodes unresponsive during stream",
                            rc.MESSAGE_TYPE_ERROR)
                break
            next_name.unlink(missing_ok=True)
            processed += 1
            # all healthy nodes share the chunk sequence, so any writer's
            # advanced frame counter is the completed-chunk total
            for node in nodes:
                if node.status != rc.STATUS_CODE_ERROR:
                    self._stream_chunk_offset = max(self._stream_chunk_offset,
                                                    node.completed_chunk_offset())
            logger.push("head", f"processed stream chunk {processed} ({chunk.name})")
