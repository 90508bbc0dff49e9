"""Spans with parents on one clock, and counters, for the port.

Layered on :func:`.log._timed`: every span enters ``log._timed(name)``
(looked up on the module when the span starts, so a wrapper installed
there sees it), which adds its seconds to ``log.STAGE_SECONDS`` and logs
the reference's ``{"executionTime", "function"}`` record.  That is all a
span does while recording is off, besides one flag test.

While recording is on (:func:`start` … :func:`stop`), each span also
keeps its name, its start and end (``time.perf_counter_ns()``; one
Unix-epoch anchor taken at import puts them on the wall clock), its
thread, an id, its pipeline and its parent: the innermost open span on
the same thread or, on a thread with no open span (a pool's worker), the
innermost open span of the pipeline's driving thread when it starts.  A
pipeline is one :func:`pipeline`-decorated call (``run_pipeline``, or
``close_gaps`` called directly) and everything it runs.

:func:`count` adds to always-on counters under a lock; while recording,
each add is also kept with its time and pipeline.  :func:`write_chrome`
writes the recording as Chrome trace events on the Unix epoch in µs,
the time base of ``torch.profiler``'s ``export_chrome_trace`` (its
``ts`` plus ``baseTimeNanoseconds`` / 1000), and :func:`merge_chrome`
joins the two into one file for one Perfetto view:

    python -m dentist_tpu_torch.utils.trace merge OUT TORCH_TRACE SPANS...

With ``DENTIST_TPU_TRACE`` naming a directory when ``run_pipeline``
starts, the call records itself and writes
``<dir>/trace-<pipeline id>.json`` at its end.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import sys
import threading
import time
from contextlib import contextmanager

from . import log

__all__ = ["span", "pipeline", "count", "counts", "start", "stop",
           "write_chrome", "merge_chrome", "summary", "sections", "TRACE_ENV"]

#: the environment variable naming the directory ``run_pipeline`` writes
#: its trace to
TRACE_ENV = "DENTIST_TPU_TRACE"


def _epoch_anchor() -> int:
    """Unix-epoch ns at ``perf_counter_ns() == 0``: the tightest of a few
    paired readings."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


EPOCH_NS = _epoch_anchor()

_lock = threading.Lock()
_on = False
#: finished spans of the current (or last) recording
_spans: list[dict] = []
#: counter adds of the current (or last) recording: (name, n, ns, pipeline)
_adds: list[tuple] = []
#: open spans by thread ident, while recording
_stacks: dict[int, list] = {}
#: open pipelines, in the order they started: id -> driving thread ident
_pipelines: dict[str, int] = {}
_local = threading.local()
_ids = itertools.count(1)
_pipeline_ids = itertools.count(1)
#: always-on counters of this process
_counts: dict[str, int] = {}


def _driver() -> tuple:
    """The latest open pipeline and its driving thread, or ``(None, None)``."""
    with _lock:
        if not _pipelines:
            return None, None
        pid = next(reversed(_pipelines))
        return pid, _pipelines[pid]


def _open(name: str) -> dict:
    stack = _stacks.setdefault(threading.get_ident(), [])
    pid = getattr(_local, "pipeline", None)
    parent = stack[-1] if stack else None
    if parent is None and pid is None:  # a pool's worker
        pid, driver = _driver()
        try:
            parent = _stacks.get(driver, [])[-1]
        except IndexError:  # the driving thread has no span open
            pass
    rec = {"name": name, "id": next(_ids),
           "parent": parent["id"] if parent else None,
           "pipeline": pid or (parent["pipeline"] if parent else None),
           "thread": threading.current_thread().name,
           "tid": threading.get_native_id(), "start": time.perf_counter_ns()}
    stack.append(rec)
    return rec


def _close(rec: dict) -> None:
    rec["end"] = time.perf_counter_ns()
    stack = _stacks.get(threading.get_ident(), [])
    if stack and stack[-1] is rec:
        stack.pop()
    _spans.append(rec)


@contextmanager
def _span(name: str):
    with log._timed(name):
        if not _on:
            yield
            return
        rec = _open(name)
        try:
            yield
        finally:
            _close(rec)


def span(name=None):
    """A span: ``with span("name"):``, ``@span("name")``, or ``@span`` on a
    function, which names it ``module.qualname`` as
    :func:`.log.trace_execution` does."""
    if callable(name):
        fn = name
        label = f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _span(label):
                return fn(*args, **kwargs)

        return wrapper
    return _span(name)


def pipeline(fn=None, *, env: str | None = None):
    """Decorate a pipeline's entry: a span named ``module.qualname`` that
    gives a call, made on a thread that drives no pipeline yet, a new
    pipeline id shared by all of its spans.  With ``env``, a call that
    finds that environment variable naming a directory records itself
    and writes ``<dir>/trace-<pipeline id>.json`` at its end."""
    if fn is None:
        return functools.partial(pipeline, env=env)
    label = f"{fn.__module__}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if getattr(_local, "pipeline", None) is not None:
            with _span(label):
                return fn(*args, **kwargs)
        out_dir = os.environ.get(env) if env else None
        own = bool(out_dir) and not _on
        if own:
            start()
        pid = f"{os.getpid()}-{next(_pipeline_ids)}"
        _local.pipeline = pid
        with _lock:
            _pipelines[pid] = threading.get_ident()
        try:
            with _span(label):
                return fn(*args, **kwargs)
        finally:
            _local.pipeline = None
            with _lock:
                _pipelines.pop(pid, None)
            if out_dir:
                recorded = stop() if own else _snapshot()
                os.makedirs(out_dir, exist_ok=True)
                write_chrome(os.path.join(out_dir, f"trace-{pid}.json"),
                             _of_pipeline(recorded, pid))

    return wrapper


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the always-on counter ``name`` (any thread)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
        if _on:
            stack = _stacks.get(threading.get_ident())
            pid = (stack[-1]["pipeline"] if stack
                   else getattr(_local, "pipeline", None))
            if pid is None and _pipelines:
                pid = next(reversed(_pipelines))
            _adds.append((name, n, time.perf_counter_ns(), pid))


def counts() -> dict:
    """A copy of the always-on counters."""
    with _lock:
        return dict(_counts)


def start() -> None:
    """Start recording (drops the last recording)."""
    global _on
    with _lock:
        _spans.clear()
        _adds.clear()
        _stacks.clear()
        _on = True


def _snapshot() -> dict:
    with _lock:
        adds = list(_adds)
    counters: dict = {}
    for name, n, _t, pid in adds:
        per = counters.setdefault(pid, {})
        per[name] = per.get(name, 0) + n
    return {"spans": list(_spans), "adds": adds, "counters": counters}


def stop() -> dict:
    """Stop recording; returns ``spans`` (dicts: ``name``, ``id``,
    ``parent``, ``pipeline``, ``thread``, ``tid``, ``start`` and ``end``
    in ``perf_counter_ns``), ``adds`` (``(name, n, ns, pipeline)``) and
    ``counters`` (pipeline -> name -> total)."""
    global _on
    with _lock:
        _on = False
    return _snapshot()


def _of_pipeline(recorded: dict, pid: str) -> dict:
    return {"spans": [s for s in recorded["spans"] if s["pipeline"] == pid],
            "adds": [a for a in recorded["adds"] if a[3] == pid],
            "counters": {pid: recorded["counters"].get(pid, {})}}


def _us(ns: int) -> float:
    """``perf_counter_ns`` → µs on the Unix epoch."""
    return (ns + EPOCH_NS) / 1e3


def _chrome_events(recorded: dict) -> list:
    """Chrome trace events of a recording: each span ``"ph": "X"`` on its
    thread, ``args`` its id, parent and pipeline; each counter's running
    total ``"ph": "C"``; the threads' names as metadata."""
    pid = os.getpid()
    events, names = [], {}
    for s in recorded["spans"]:
        names[s["tid"]] = s["thread"]
        events.append({"name": s["name"], "ph": "X", "pid": pid,
                       "tid": s["tid"], "ts": _us(s["start"]),
                       "dur": (s["end"] - s["start"]) / 1e3,
                       "args": {"id": s["id"], "parent": s["parent"],
                                "pipeline": s["pipeline"]}})
    totals: dict = {}
    for name, n, t, _pid in recorded["adds"]:
        totals[name] = totals.get(name, 0) + n
        events.append({"name": name, "ph": "C", "pid": pid, "ts": _us(t),
                       "args": {name: totals[name]}})
    events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in names.items()]
    return events


def write_chrome(path: str, recorded: dict | None = None) -> None:
    """Write ``recorded`` (default: the current or last recording) as a
    Chrome trace, ``ts`` and ``dur`` in µs on the Unix epoch."""
    recorded = _snapshot() if recorded is None else recorded
    with open(path, "w") as fh:
        json.dump({"traceEvents": _chrome_events(recorded),
                   "displayTimeUnit": "ms"}, fh)


def merge_chrome(out: str, torch_trace: str, *spans: str) -> None:
    """One Chrome trace of a ``torch.profiler`` export and span files of
    :func:`write_chrome`: the export's events moved onto the Unix epoch
    (``ts`` + ``baseTimeNanoseconds`` / 1000), the spans as they are."""
    with open(torch_trace) as fh:
        base = json.load(fh)
    shift = base.pop("baseTimeNanoseconds", 0) / 1e3
    for e in base["traceEvents"]:
        if "ts" in e:
            e["ts"] = float(e["ts"]) + shift
    for path in spans:
        with open(path) as fh:
            base["traceEvents"] += json.load(fh)["traceEvents"]
    with open(out, "w") as fh:
        json.dump(base, fh)


def summary(spans: list) -> dict:
    """name -> ``{"total_s", "self_s", "count"}``: self time is a span's
    duration less the part its children on the same thread cover."""
    covered: dict = {}
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        p = by_id.get(s["parent"])
        if p is not None and p["tid"] == s["tid"]:
            lo, hi = max(s["start"], p["start"]), min(s["end"], p["end"])
            covered[p["id"]] = covered.get(p["id"], 0) + max(0, hi - lo)
    out: dict = {}
    for s in spans:
        row = out.setdefault(s["name"], {"total_s": 0.0, "self_s": 0.0,
                                         "count": 0})
        dur = s["end"] - s["start"]
        row["total_s"] += dur / 1e9
        row["self_s"] += (dur - covered.get(s["id"], 0)) / 1e9
        row["count"] += 1
    return out


def sections(recorded: dict) -> dict:
    """name -> ``[seconds, hits, bytes]`` of a recording's spans, the
    bytes from a ``<name>.bytes`` counter where the span has one (the
    profile scripts' section tables)."""
    added: dict = {}
    for name, n, _t, _pid in recorded["adds"]:
        added[name] = added.get(name, 0) + n
    return {k: [v["total_s"], v["count"], added.get(f"{k}.bytes", 0)]
            for k, v in sorted(summary(recorded["spans"]).items())}


if __name__ == "__main__":
    if len(sys.argv) < 5 or sys.argv[1] != "merge":
        sys.exit("usage: python -m dentist_tpu_torch.utils.trace merge "
                 "OUT TORCH_TRACE SPANS...")
    merge_chrome(*sys.argv[2:])
