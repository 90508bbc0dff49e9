"""The port's span recorder (``dentist_tpu_torch/utils/trace.py``), on the CPU.

Spans nest with the right parents on the driving thread and across a
pool; with recording off nothing is kept and ``STAGE_SECONDS`` still
sums each span; counters lose no add from many threads; the Chrome
export lies on ``torch.profiler``'s time base; self time leaves out the
children; and a whole ``run_pipeline`` on ``tests/test_e2e.py``'s 60 kb
scenario, with ``DENTIST_TPU_TRACE`` set, opens the five span keys the
benchmark reads, never one key on two threads at once, and writes one
trace file.  ``utils/prof`` is gone and nothing imports it.
"""

import importlib.util
import json
import os
import re
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.utils import log, trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the span keys the benchmark's per-layer readers read
BENCH_KEYS = ("wait.device", "aligner.seed_wait", "aligner.make_jobs",
              "io.parse", "io.checkpoint")


@pytest.fixture
def recording():
    """A recording, stopped after the test whatever happens."""
    trace.start()
    yield
    trace.stop()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


@trace.pipeline
def _driven(pool_work):
    with trace.span("outer"):
        with trace.span("inner"):
            with ThreadPoolExecutor(max_workers=2) as ex:
                list(ex.map(pool_work, range(4)))
        with trace.span("second"):
            pass


def _pool_task(i):
    with trace.span("task"):
        with trace.span("task.child"):
            time.sleep(0.001)


def test_spans_nest_on_the_driving_thread_and_across_a_pool(recording):
    _driven(_pool_task)
    rec = trace.stop()
    spans = _by_name(rec["spans"])
    (pipe,) = spans[f"{__name__}._driven"]
    (outer,), (inner,), (second,) = spans["outer"], spans["inner"], spans["second"]
    assert pipe["parent"] is None and pipe["pipeline"]
    assert outer["parent"] == pipe["id"] and inner["parent"] == outer["id"]
    assert second["parent"] == outer["id"]
    main = threading.current_thread().name
    assert {s["thread"] for s in (pipe, outer, inner, second)} == {main}
    # a worker's first span hangs under the driving thread's innermost
    # open span; its own children under it, on its thread
    assert len(spans["task"]) == len(spans["task.child"]) == 4
    tasks = {s["id"]: s for s in spans["task"]}
    for t in tasks.values():
        assert t["parent"] == inner["id"] and t["thread"] != main
    for c in spans["task.child"]:
        assert tasks[c["parent"]]["tid"] == c["tid"]
    assert {s["pipeline"] for s in rec["spans"]} == {pipe["pipeline"]}
    for s in rec["spans"]:
        assert s["start"] <= s["end"]
    # each span ends inside its parent
    ids = {s["id"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        p = ids.get(s["parent"])
        if p is not None:
            assert p["start"] <= s["start"] and s["end"] <= p["end"]


def test_pipelines_get_ids_of_their_own(recording):
    _driven(lambda i: None)
    _driven(lambda i: None)
    rec = trace.stop()
    pipes = [s["pipeline"] for s in rec["spans"] if s["name"].endswith("_driven")]
    assert len(set(pipes)) == 2


def test_recording_off_keeps_nothing_and_stage_seconds_still_sum():
    trace.start()
    trace.stop()
    log.reset_stage_seconds()
    t0 = time.perf_counter()
    for _ in range(3):
        with trace.span("off.a"):
            time.sleep(0.002)
    outer = time.perf_counter() - t0
    assert trace.stop()["spans"] == []
    assert 0.006 <= log.STAGE_SECONDS["off.a"] <= outer
    # recording on: STAGE_SECONDS sums what the spans measured
    log.reset_stage_seconds()
    trace.start()
    try:
        for _ in range(3):
            with trace.span("on.a"):
                with trace.span("on.b"):
                    time.sleep(0.002)
    finally:
        rec = trace.stop()
    summ = trace.summary(rec["spans"])
    for name in ("on.a", "on.b"):
        assert summ[name]["count"] == 3
        assert log.STAGE_SECONDS[name] == pytest.approx(summ[name]["total_s"], abs=1e-3)


def test_span_as_decorator_is_named_as_trace_execution_names():
    @trace.span
    def fn():
        return 7

    @trace.span("named")
    def gn():
        return 8

    log.reset_stage_seconds()
    assert (fn(), gn(), gn()) == (7, 8, 8)
    name = f"{__name__}.test_span_as_decorator_is_named_as_trace_execution_names.<locals>.fn"
    assert set(log.STAGE_SECONDS) == {name, "named"}


def test_spans_enter_the_timed_scope_installed_on_the_log_module(monkeypatch):
    """A wrapper installed on ``log._timed`` (the benchmark's traced runs
    label idle gaps so) sees every span, the pipeline's included."""
    import contextlib

    seen = []
    orig = log._timed

    @contextlib.contextmanager
    def timed(name):
        seen.append(name)
        with orig(name):
            yield

    monkeypatch.setattr(log, "_timed", timed)
    _driven(lambda i: None)
    assert seen == [f"{__name__}._driven", "outer", "inner", "second"]


def test_counts_from_many_threads_are_exact(recording):
    before = trace.counts().get("t.adds", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.count("t.adds")
                                                    for _ in range(1000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert trace.counts()["t.adds"] - before == 8000
    rec = trace.stop()
    assert sum(n for name, n, _t, _p in rec["adds"] if name == "t.adds") == 8000


def test_self_time_leaves_out_children_on_the_same_thread():
    def s(i, parent, tid, a, b):
        return {"name": f"n{i}", "id": i, "parent": parent, "tid": tid,
                "start": a, "end": b}

    spans = [s(1, None, 1, 0, 100), s(2, 1, 1, 10, 30), s(3, 1, 1, 40, 60),
             s(4, 1, 2, 0, 90)]  # 4 runs on another thread
    summ = trace.summary(spans)
    assert summ["n1"]["total_s"] == pytest.approx(100e-9)
    assert summ["n1"]["self_s"] == pytest.approx(60e-9)
    assert summ["n4"]["self_s"] == pytest.approx(90e-9)


def test_chrome_export_lies_on_torch_profilers_time_base(tmp_path, recording):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with trace.span("outer.span"):
            with record_function("inside"):
                time.sleep(0.005)
    torch_path, spans_path = tmp_path / "torch.json", tmp_path / "spans.json"
    prof.export_chrome_trace(str(torch_path))
    trace.write_chrome(str(spans_path))
    with open(torch_path) as fh:
        exported = json.load(fh)
    base = exported["baseTimeNanoseconds"] / 1e3
    (inside,) = [e for e in exported["traceEvents"] if e.get("name") == "inside"]
    with open(spans_path) as fh:
        events = json.load(fh)["traceEvents"]
    (ours,) = [e for e in events if e["name"] == "outer.span"]
    assert ours["ph"] == "X" and set(ours["args"]) == {"id", "parent", "pipeline"}
    assert abs(ours["ts"] - (inside["ts"] + base)) < 1e3  # µs
    assert abs(ours["ts"] + ours["dur"] - (inside["ts"] + inside["dur"] + base)) < 1e3
    # the merged file holds both on the epoch
    merged = tmp_path / "merged.json"
    trace.merge_chrome(str(merged), str(torch_path), str(spans_path))
    with open(merged) as fh:
        both = json.load(fh)
    assert "baseTimeNanoseconds" not in both
    (m_inside,) = [e for e in both["traceEvents"] if e.get("name") == "inside"]
    (m_ours,) = [e for e in both["traceEvents"] if e.get("name") == "outer.span"]
    assert abs(m_ours["ts"] - m_inside["ts"]) < 1e3


def test_nothing_imports_utils_prof():
    assert importlib.util.find_spec("dentist_tpu_torch.utils.prof") is None
    pattern = re.compile(r"utils\.prof\b|utils import prof\b|DENTIST_TPU_PROF")
    hits = []
    for top in ("dentist_tpu_torch", "scripts", "benchmark", "tests"):
        for d, _dirs, files in os.walk(os.path.join(ROOT, top)):
            for f in files:
                if f.endswith(".py") and f != "test_torch_trace.py":
                    path = os.path.join(d, f)
                    with open(path) as fh:
                        text = fh.read()
                    # the JAX package's own profile script reads its prof
                    if pattern.search(text) and "dentist_tpu.utils.prof" not in text:
                        hits.append(path)
    for f in ("chip_smoke.py", "bench_torch.py"):
        with open(os.path.join(ROOT, f)) as fh:
            if pattern.search(fh.read()):
                hits.append(f)
    assert hits == []


# ---------------------------------------------------------------------
# one whole pipeline on the CPU


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    """``run_pipeline`` with a workdir on the 60 kb scenario (the kernels'
    plain versions), ``DENTIST_TPU_TRACE`` set: its ``STAGE_SECONDS``,
    the counters it added and the trace directory."""
    from dentist_tpu_torch.pipeline import (STAGE_SECONDS, PipelineConfig,
                                            reset_stage_seconds, run_pipeline)
    from dentist_tpu_torch.scenarios import e2e_scenario, write_scenario

    d = tmp_path_factory.mktemp("trace_e2e")
    asm, reads = write_scenario(e2e_scenario(), str(d / "inputs"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DENTIST_TPU_FORCE_SINGLE", "1")
        mp.setenv(trace.TRACE_ENV, str(d / "traces"))
        set_device("cpu")
        reset_stage_seconds()
        before = trace.counts()
        result = run_pipeline(asm, reads, str(d / "out.fasta"),
                              PipelineConfig(read_coverage=20.0,
                                             workdir=str(d / "work")))
        after = trace.counts()
        stages = dict(STAGE_SECONDS)
    added = {k: v - before.get(k, 0) for k, v in after.items()}
    return result, stages, added, d / "traces"


def _trace_file(e2e_run):
    files = os.listdir(e2e_run[3])
    assert len(files) == 1 and re.fullmatch(r"trace-\d+-\d+\.json", files[0])
    with open(e2e_run[3] / files[0]) as fh:
        return json.load(fh)["traceEvents"]


def test_pipeline_opens_the_five_keys_the_benchmark_reads(e2e_run):
    result, stages, _, _ = e2e_run
    assert result.n_closed_gaps == 3
    for key in BENCH_KEYS:
        assert stages.get(key, 0) > 0, key
    # parsing is part of what runs outside close_gaps
    io = (stages["dentist_tpu_torch.pipeline.run_pipeline"]
          - stages["dentist_tpu_torch.pipeline.close_gaps"])
    assert stages["io.parse"] <= io


def test_pipeline_writes_one_readable_trace_file(e2e_run):
    events = _trace_file(e2e_run)
    spans = [e for e in events if e["ph"] == "X"]
    assert 0 < len(spans) < 2000
    pipes = {e["args"]["pipeline"] for e in spans}
    assert len(pipes) == 1
    (top,) = [e for e in spans if e["args"]["parent"] is None]
    assert top["name"] == "dentist_tpu_torch.pipeline.run_pipeline"
    ids = {e["args"]["id"] for e in spans}
    assert all(e["args"]["parent"] in ids for e in spans if e is not top)
    names = {e["name"] for e in spans}
    assert set(BENCH_KEYS) <= names
    assert {"k1.lanes_live", "k1.lanes_launched", "k5.upload_bytes"} <= {
        e["name"] for e in events if e["ph"] == "C"}


def test_no_key_is_open_on_two_threads_at_once(e2e_run):
    """Every key lands in ``STAGE_SECONDS`` by an unlocked add: the keys
    the benchmark reads are held by one thread at a time."""
    spans = [e for e in _trace_file(e2e_run) if e["ph"] == "X"]
    for key in BENCH_KEYS:
        ivs = sorted((e["ts"], e["ts"] + e["dur"], e["tid"])
                     for e in spans if e["name"] == key)
        for (a0, a1, at), (b0, b1, bt) in zip(ivs, ivs[1:]):
            assert at == bt or b0 >= a1, (key, at, bt)


def test_pipeline_counts_lanes_and_uploads(e2e_run):
    added = e2e_run[2]
    assert 0 < added["k1.lanes_live"] <= added["k1.lanes_launched"]
    assert added["k5.upload_bytes"] > 0
    assert added.get("k1p.window_bytes", 0) == 0  # the store holds the reads
    assert added.get("store.resets", 0) == 0
