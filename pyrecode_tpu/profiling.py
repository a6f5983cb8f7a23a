"""Tracing / profiling hooks.

Capability parity with the reference's per-frame/per-stage wall-clock metrics
(recode_writer.py:432-555, aggregated at :417-427, printed by
print_run_metrics :610-618) — the writer already maintains that metrics dict —
plus what the reference lacks (SURVEY.md §5): real profiler integration.

* :func:`trace` — context manager around ``jax.profiler.trace``; produces a
  TensorBoard/XProf trace of device execution for any code region.
* :class:`StageTimer` — named wall-clock stages accumulated into a
  reference-shaped metrics dict (timedelta values).
* :func:`annotate` — ``jax.profiler.TraceAnnotation`` wrapper so writer
  stages show up named inside device traces.
* :func:`enable_compile_cache` — the one rule for where compiled programs
  are cached.
* :func:`card_line` — the GPU's name and power limit, to print beside
  every device number.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
from datetime import datetime, timedelta
from pathlib import Path
from typing import Dict, Optional

_CHECKOUT_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a device/host profiler trace for the enclosed region."""
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Name the enclosed region inside profiler traces (no-op overheadwise)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class StageTimer:
    """Accumulate named wall-clock stages, reference-metrics shaped."""

    def __init__(self, metrics: Optional[Dict[str, timedelta]] = None):
        self.metrics: Dict[str, timedelta] = metrics if metrics is not None else {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = datetime.now()
        try:
            yield
        finally:
            elapsed = datetime.now() - start
            self.metrics[name] = self.metrics.get(name, timedelta(0)) + elapsed

    def as_seconds(self) -> Dict[str, float]:
        return {k: v.total_seconds() for k, v in self.metrics.items()
                if isinstance(v, timedelta)}


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to ``.jax_cache`` at the
    root of the checkout: a fixed path, so one run finds what an earlier run
    compiled (the path is part of the cache key).
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = str(_CHECKOUT_CACHE)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
