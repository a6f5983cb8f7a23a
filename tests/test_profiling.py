"""The compile-cache rule and the profiling helpers."""

from datetime import timedelta
from pathlib import Path

import jax

from pyrecode_tpu import profiling

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_defaults_to_a_fixed_ignored_path(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert profiling.enable_compile_cache() == path      # never moves
    assert calls == [("jax_compilation_cache_dir", path)] * 2
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_stage_timer_accumulates():
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("encode"):
            pass
    assert set(timer.as_seconds()) == {"encode"}
    assert isinstance(timer.metrics["encode"], timedelta)
