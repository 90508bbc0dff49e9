"""Host time by function, stage and thread, from samples of every
thread's Python stack.

The host passes of the port run on pools (``ThreadPoolExecutor`` in
``pipeline.masks_for``, ``ops/aligner.py`` and ``ops/consensus.py``)
beside the thread that drives them.  ``cProfile`` cannot attribute that
time on Python 3.12: it is built on ``sys.monitoring``, so one profiler
at a time may run in an interpreter (a second ``Profile.enable()``
raises "Another profiling tool is already active"), and it takes the
calls of every thread into one call stack, which charges a worker's
calls to whatever the driving thread was in.  :class:`StackSampler`
instead reads ``sys._current_frames()`` every ``interval`` seconds from
a thread of its own and charges the time since its last sample to every
function on each thread's stack (cumulative) and to the innermost one
(self), per thread and per stage:

- a thread is ``main`` (the one that started the sampler; the frames
  around the sampled window are not charged) or
  ``pool:<function>``, the task a pool worker (or ``thread:<function>``,
  the target a plain thread) was running; a worker waiting for a task
  is idle and not charged;
- the stage of a sample is the first of ``stages`` whose functions are
  all on some thread's stack then (``"file.py:function"`` names, the
  file matched by its last path components), else ``other``; every
  thread's sample at that instant takes it.  A stage may be listed more
  than once, for functions that mark it in turn.

Time inside native code (numpy, torch, a wait on the card) is charged to
the Python function that called it.  A sample is taken when the sampler
gets the interpreter lock, so a native call that holds the lock
lengthens the next interval rather than losing time.  Nothing runs
unless a sampler is started; it never touches the device.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict

__all__ = ["StackSampler", "PIPELINE_STAGES", "function_name", "format_report"]

#: the stages of ``pipeline.close_gaps``: ``_validation_pass`` (whose
#: re-map is validation, not mapping), then within ``masks_for`` the read
#: mapping (``map_reads``), the self-alignment, dust and tandem (tandem
#: runs on a pool beside dust) and the rest, then collect, process and
#: output
PIPELINE_STAGES = (
    ("validation", ("pipeline.py:_validation_pass",)),
    ("mapping", ("pipeline.py:masks_for", "ops/mapper.py:map_reads")),
    ("self-alignment", ("pipeline.py:masks_for", "ops/aligner.py:align_store_pair")),
    ("dust+tandem", ("pipeline.py:masks_for", "models/mask.py:tandem_mask")),
    ("dust+tandem", ("pipeline.py:masks_for", "models/mask.py:dust_mask")),
    ("masks-other", ("pipeline.py:masks_for",)),
    ("collect", ("models/pileups.py:collect_pile_ups",)),
    ("process", ("models/process.py:process_pile_ups",)),
    ("output", ("models/output.py:build_output",)),
)

_THREAD_FILES = (os.path.join("concurrent", "futures", "thread.py"),
                 os.path.join("concurrent", "futures", "_base.py"),
                 os.path.join("", "threading.py"))


def _is_thread_machinery(code) -> bool:
    return code.co_filename.endswith(_THREAD_FILES)


def function_name(code) -> str:
    """``path:line(qualname)`` of a code object, the path from the last
    ``dentist_tpu_torch`` or ``site-packages`` component on."""
    path = code.co_filename
    for anchor in ("dentist_tpu_torch" + os.sep, "site-packages" + os.sep):
        i = path.rfind(anchor)
        if i >= 0:
            path = path[i + (len(anchor) if anchor.startswith("site") else 0):]
            break
    return f"{path}:{code.co_firstlineno}({code.co_qualname})"


class StackSampler:
    """Samples every Python thread's stack between :meth:`start` and
    :meth:`stop` (or inside ``with``); :meth:`report` sums the samples."""

    def __init__(self, interval: float = 0.005, stages=()):
        self.interval = interval
        self.stages = [(name, tuple(self._marker(m) for m in marks))
                       for name, marks in stages]
        self._marks: dict = {}  # code -> set of (file suffix, name) it matches
        self._cum = defaultdict(float)  # (stage, thread, code) -> seconds
        self._self = defaultdict(float)
        self._busy = defaultdict(float)  # (stage, thread) -> seconds
        self._wall = defaultdict(float)  # stage -> seconds
        self._waiting = defaultdict(float)  # stage -> main thread's waits
        self.samples = 0
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _marker(mark: str) -> tuple[str, str]:
        path, _, name = mark.rpartition(":")
        return os.sep + path.replace("/", os.sep), name

    def start(self) -> "StackSampler":
        self._owner = threading.get_ident()
        # the frames around the sampled window enclose all of it: not
        # charged (held, so that no other frame takes their ids)
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        self._outer_frames = []
        while f is not None:
            self._outer_frames.append(f)
            f = f.f_back
        self._outer = {id(f) for f in self._outer_frames}
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stack-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        self._thread = None
        self._outer_frames = []

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _run(self) -> None:
        me = threading.get_ident()
        last = time.perf_counter()
        while not self._stop.wait(self.interval):
            now = time.perf_counter()
            self._sample(sys._current_frames(), me, now - last)
            last = now

    def _codes_of(self, code) -> frozenset:
        m = self._marks.get(code)
        if m is None:
            m = frozenset((suf, name) for _, marks in self.stages
                          for suf, name in marks
                          if code.co_name == name and code.co_filename.endswith(suf))
            self._marks[code] = m
        return m

    def _stage(self, stacks) -> str:
        on_stack = set()
        for frames in stacks:
            for f in frames:
                on_stack |= self._codes_of(f.f_code)
        for name, marks in self.stages:
            if all(m in on_stack for m in marks):
                return name
        return "other"

    def _sample(self, current: dict, me: int, dt: float) -> None:
        stacks = {}
        for ident, frame in current.items():
            if ident == me:
                continue
            frames = []
            while frame is not None and id(frame) not in self._outer:
                frames.append(frame)
                frame = frame.f_back
            if frames:
                stacks[ident] = frames
        stage = self._stage(stacks.values())
        self.samples += 1
        self._wall[stage] += dt
        for ident, frames in stacks.items():
            if ident == self._owner:
                label = "main"
                if _is_thread_machinery(frames[0].f_code):
                    self._waiting[stage] += dt
            else:
                label = self._label(frames)
                if label is None:
                    continue
            self._busy[stage, label] += dt
            self._self[stage, label, frames[0].f_code] += dt
            for code in {f.f_code for f in frames}:
                self._cum[stage, label, code] += dt

    @staticmethod
    def _label(frames) -> str | None:
        """The task or target a thread runs (its outermost frame outside
        the thread and pool machinery), or None when it runs none."""
        pool = False
        for f in reversed(frames):
            code = f.f_code
            if _is_thread_machinery(code):
                pool = pool or code.co_name == "_worker"
                continue
            return ("pool:" if pool else "thread:") + code.co_qualname
        return None

    def report(self, top: int = 10) -> dict:
        """Per stage: its wall seconds, the main thread's seconds waiting
        in the thread and pool machinery (on a pool's futures or a lock),
        each thread's busy seconds, and the ``top`` (function, thread)
        pairs by cumulative and by self seconds, over all threads and
        (``by_thread``) for each thread.  The machinery is left out, and
        so are the main thread's functions that span the whole stage (the
        stage's entry and its callers).  Seconds are sums of sample
        intervals: a thread's are the time its function was on its stack,
        running, in native code or waiting for the interpreter lock."""
        out = {}
        for stage in sorted(self._wall, key=lambda s: -self._wall[s]):
            wall = self._wall[stage]
            threads = dict(sorted(((t, s) for (st, t), s in self._busy.items()
                                   if st == stage), key=lambda kv: -kv[1]))

            def ranked(acc, label=None):
                rows = sorted(((s, t, c) for (st, t, c), s in acc.items()
                               if st == stage and label in (None, t)
                               and not _is_thread_machinery(c)
                               and not (t == "main" and s >= wall * (1 - 1e-9))),
                              key=lambda r: -r[0])[:top]
                return [{"function": function_name(c), "thread": t, "seconds": s}
                        for s, t, c in rows]

            out[stage] = {
                "wall_s": wall, "main_waiting_s": self._waiting[stage],
                "threads": threads,
                "cumulative": ranked(self._cum), "self": ranked(self._self),
                "by_thread": {t: {"cumulative": ranked(self._cum, t),
                                  "self": ranked(self._self, t)} for t in threads},
            }
        return out

    def seconds_in(self, mark: str) -> dict:
        """Cumulative seconds of the functions matching ``"file.py:name"``,
        by stage and thread."""
        suf, name = self._marker(mark)
        found = defaultdict(float)
        for (stage, label, code), s in self._cum.items():
            if code.co_name == name and code.co_filename.endswith(suf):
                found[f"{stage}/{label}"] += s
        return dict(found)


def format_report(report: dict, interval: float) -> str:
    """The report of :meth:`StackSampler.report` as text tables."""
    lines = [f"---- host stacks, sampled every {interval * 1e3:.1f} ms ----"]
    for stage, e in report.items():
        threads = ", ".join(f"{t} {s:.2f}" for t, s in e["threads"].items())
        lines.append(f"[{stage}] wall {e['wall_s']:.2f} s, main thread waiting "
                     f"{e['main_waiting_s']:.2f} s; busy s by thread: {threads}")
        tables = [(f"by {kind} seconds", e[kind]) for kind in ("cumulative", "self")]
        tables += [(f"{t}, by cumulative seconds", rows["cumulative"])
                   for t, rows in e["by_thread"].items()]
        for title, rows in tables:
            lines.append(f"  {title}:")
            for r in rows:
                lines.append(f"    {r['seconds']:8.3f}  {r['thread']:<40.40s} {r['function']}")
    return "\n".join(lines)
