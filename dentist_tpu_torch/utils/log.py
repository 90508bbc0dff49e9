"""Structured single-line JSON logging + scope timers.

Mirrors the reference's observability model (``source/dentist/util/log.d``):
single-line JSON records on stderr carrying ``timestamp``, ``logLevel`` and
free-form payload, levels ``debug/diagnostic/info/warn/error/fatal``, and an
RAII scope timer (``mixin(traceExecution)``, ``log.d:292-376``) emitting
``{"executionTime": …, "function": …}`` at diagnostic level — here a
context manager / decorator :func:`trace_execution`.
"""

from __future__ import annotations

import functools
import json
import sys
import time
from contextlib import contextmanager

__all__ = ["set_log_level", "log_json", "trace_execution", "tee_log_file",
           "LEVELS"]

LEVELS = {"debug": 0, "diagnostic": 1, "info": 2, "warn": 3, "error": 4, "fatal": 5}
_current_level = LEVELS["info"]
_stream = sys.stderr
_tee = None


def set_log_level(level: str) -> None:
    global _current_level
    _current_level = LEVELS[level]


def tee_log_file(path: str | None) -> None:
    """Duplicate every record to ``path`` (the reference persists per-stage
    ``*.log`` files that ``lost-gaps`` analyzes); ``None`` stops teeing."""
    global _tee
    if _tee is not None:
        _tee.close()
    _tee = open(path, "a") if path else None


def log_json(level: str, **payload) -> None:
    if LEVELS[level] < _current_level:
        return
    record = {"timestamp": time.time_ns() // 1000, "logLevel": level}
    record.update(payload)
    line = json.dumps(record, default=str, separators=(",", ":"))
    print(line, file=_stream)
    if _tee is not None:
        _tee.write(line + "\n")
        _tee.flush()


#: cumulative per-scope wall seconds (bench reads this for the
#: per-stage BENCH fields; reset with :func:`reset_stage_seconds`)
STAGE_SECONDS: dict[str, float] = {}


def reset_stage_seconds() -> None:
    STAGE_SECONDS.clear()


@contextmanager
def _timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        STAGE_SECONDS[name] = STAGE_SECONDS.get(name, 0.0) + dt
        log_json(
            "diagnostic",
            executionTime=int(dt * 1e7),  # hnsecs, as reference
            function=name,
        )


def trace_execution(fn=None, *, name: str | None = None):
    """Decorator or context manager logging execution time at diagnostic level."""
    if fn is None:
        return _timed(name or "<scope>")
    if isinstance(fn, str):
        return _timed(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _timed(name or f"{fn.__module__}.{fn.__qualname__}"):
            return fn(*args, **kwargs)

    return wrapper
