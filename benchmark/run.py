"""One run of one benchmark cell of the port (``dentist_tpu_torch``).

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout.  Everything a cell is made of is found
by name: the cell in ``BENCHMARK.json``, its configuration in
``benchmark/configs/<config>.json``, its traffic mix in
``benchmark/traffic/<traffic>.json``, the limits of its check in
``benchmark/limits/<workload>.json`` and each metric's reader in
``benchmark/metrics/<metric>.py`` (``read(record)``, see
``benchmark/README.md``).

A run is a closed loop with one client, as a user runs the program: one
``run_pipeline`` call at a time on an assembly FASTA and a reads FASTA,
each on inputs of its own drawn from ``(seed, unit)`` by
``benchmark/gen.py`` in a child process while the clock is paused, with
its own output and workdir, and a fresh device store.  Set-up (the
imports, loading the kernel library, one warm-up pipeline of the cell's
size on its own seed) is timed apart; then pipelines run until the sum
of their walls reaches ``--seconds``, the one in flight finishing and
counting.  After the window the peak host memory is read, the program's
state freed, and every pipeline's outputs are held against the truth by
``benchmark/reference.py``.  With ``--trace 1`` the window runs under
``torch.profiler`` and the per-layer metrics are reported instead of the
end-to-end ones.

The last line on stdout is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number beside its limit); the last
lines on stderr are the same checks.  Without a CUDA device with as many
cards as the cell asks for, or with JAX or the JAX package loaded, it
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: top-level module names the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "dentist_tpu")


class BenchError(Exception):
    """A cell that cannot run as the files describe it."""


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic, limits and
    the names of the metrics it reports at each trace setting."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(os.path.join(root, configs[cell["config"]]["file"]))
    bench = os.path.join(root, "benchmark")
    traffic = _load_json(os.path.join(bench, "traffic", f"{cell['traffic']}.json"))
    limits = _load_json(os.path.join(bench, "limits", f"{workload}.json"))["limits"]

    def reports(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in moved and reports(m)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "metrics": {0: e2e, 1: layer}}


def reader(name: str, root: str = ROOT):
    """The ``read(record)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def gen_params(cfg: dict, traffic: dict) -> dict:
    """The generator's parameters: the configuration's sizes and read
    model with the traffic's gaps."""
    keys = ("assembly_mb", "repeats_per_mb", "repeat_length",
            "repeat_divergence", "read_coverage", "read_mean", "read_sd",
            "read_min", "read_error")
    return {**{k: cfg[k] for k in keys}, **traffic["gaps"]}


def generate(run_dir: str, params: dict, seed: int, unit) -> tuple[str, dict]:
    """Write unit ``unit``'s inputs in a child process; returns its
    directory and sizes."""
    d = os.path.join(run_dir, f"unit-{unit}")
    subprocess.run([sys.executable, os.path.join(BENCH, "gen.py"), d,
                    json.dumps(params), str(seed), str(unit)], check=True)
    return d, _load_json(os.path.join(d, "unit.json"))


class Spans:
    """Stage spans around the port's ``trace_execution`` scopes: each
    scope also enters ``torch.profiler.record_function('stage:<name>')``,
    so a traced window can tell which stage the host was in."""

    def __init__(self, log_mod):
        self.log = log_mod
        self.orig = log_mod._timed

    def __enter__(self):
        import torch

        orig = self.orig

        @contextlib.contextmanager
        def timed(name):
            with torch.profiler.record_function(f"stage:{name}"), orig(name):
                yield

        self.log._timed = timed
        return self

    def __exit__(self, *exc):
        self.log._timed = self.orig


class K1Launches:
    """Records every K1 and K1p launch's lanes, rows and shape by
    wrapping ``banded.extend`` and ``banded.extend_packed`` (the
    roofline's counts come from each launch's own arguments)."""

    def __init__(self, banded):
        self.banded = banded
        self.orig = (banded.extend, banded.extend_packed)
        self.launches: list[tuple] = []

    def __enter__(self):
        import inspect

        def wrap(fn, packed):
            sig = inspect.signature(fn)

            def launch(*args, **kwargs):
                out = fn(*args, **kwargs)
                a = sig.bind(*args, **kwargs)
                a.apply_defaults()
                meta = a.arguments["meta5" if packed else "meta12"]
                self.launches.append((meta, a.arguments["R"], a.arguments["W"],
                                      packed))
                return out
            return launch

        self.banded.extend = wrap(self.orig[0], False)
        self.banded.extend_packed = wrap(self.orig[1], True)
        return self

    def __exit__(self, *exc):
        self.banded.extend, self.banded.extend_packed = self.orig

    def bound_s(self, int_rate: float) -> float:
        from roofline import k1_bound_s

        total = 0.0
        for meta, R, W, packed in self.launches:
            rows = int(meta[2].clamp(0, R).sum())
            total += k1_bound_s(meta.shape[1], rows,
                                meta.numel() * meta.element_size(), R, W,
                                packed, int_rate)
        return total


def _short(name: str) -> str:
    """A device operation's name without ``void``, namespaces' markers
    and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].removeprefix("void ")[:120]


def reduce_trace(prof) -> dict:
    """Device busy and idle seconds inside the window's units, seconds
    per device operation, and idle seconds by the stage the host was in
    (the innermost ``stage:`` span over each part of each idle gap)."""
    import torch

    dev, units, stages = [], [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(("stage:", "bench:")):  # not the spans' GPU rows
                dev.append((a, b, e.name))
        elif e.name.startswith("bench:unit"):
            units.append((a, b))
        elif e.name.startswith("stage:"):
            stages.append((a, b, e.name[len("stage:"):]))
    dev.sort()
    by_name: dict[str, float] = {}
    busy, idle_by = 0.0, {}
    for u0, u1 in units:
        end = u0
        for a, b, name in dev:
            if b <= u0 or a >= u1:
                continue
            a, b = max(a, u0), min(b, u1)
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            if a > end:
                _label_idle(end, a, stages, idle_by)
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        if u1 > end:
            _label_idle(end, u1, stages, idle_by)
    return {"busy_s": busy, "window_s": sum(b - a for a, b in units),
            "kernel_s": by_name, "idle_by_stage": idle_by}


def _label_idle(a: float, b: float, stages, idle_by: dict) -> None:
    """Charge the idle interval [a, b) to the innermost stage span over
    each of its parts (``"outside a stage"`` where none is)."""
    cuts = sorted({a, b, *(t for s in stages for t in s[:2] if a < t < b)})
    for lo, hi in zip(cuts, cuts[1:]):
        mid = (lo + hi) / 2
        inner = [s for s in stages if s[0] <= mid < s[1]]
        label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                 else "outside a stage")
        idle_by[label] = idle_by.get(label, 0.0) + (hi - lo)


def _cpu_seconds() -> float:
    """This process's CPU seconds, every thread's."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", patch=None, root: str = ROOT,
             warmup: bool = True) -> dict:
    """One run of ``workload``; returns the result line's object and the
    run's record.  ``device="cpu"`` runs the kernels' plain versions
    (tests only); ``patch()``, if given, is called once the port is
    imported and before the warm-up (tests and the control plant faults
    or paths through it); ``warmup=False`` leaves the warm-up pipeline
    out (readings of the check only: set-up is then not measured)."""
    cell = load_cell(workload, root)
    cfg, traffic = cell["config"], cell["traffic"]
    params = gen_params(cfg, traffic)
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(0, p)
    import reference

    paused = 0.0  # generation seconds inside set-up, not set-up's own
    tmp = tempfile.mkdtemp(prefix="bench-run-")
    try:
        t0 = time.perf_counter()
        warm_dir = generate(tmp, params, seed, "warmup")[0] if warmup else None
        paused += time.perf_counter() - t0

        import numpy as np
        import torch

        from dentist_tpu_torch.device import set_device
        from dentist_tpu_torch.ops import banded
        from dentist_tpu_torch.pipeline import (STAGE_SECONDS, PipelineConfig,
                                                reset_stage_seconds, run_pipeline)
        from dentist_tpu_torch.utils import log as port_log
        from dentist_tpu_torch import dryrun

        set_device(device)
        cuda = device == "cuda"
        if patch is not None:
            patch()

        def one(unit_dir: str, info: dict, out_dir: str) -> dict:
            gc.collect()  # the last pipeline's garbage, before the clock starts
            ratio = cfg.get("store_ratio")
            cap = int(info["read_chars"] / ratio) if ratio else None
            store = banded.reset_device_store(cap)
            epoch0 = store.epoch
            reset_stage_seconds()
            dryrun.reset_launch_counts()
            cpu0 = _cpu_seconds()
            t = time.perf_counter()
            run_pipeline(os.path.join(unit_dir, "assembly.fasta"),
                         os.path.join(unit_dir, "reads.fasta"),
                         os.path.join(out_dir, "out.fasta"),
                         PipelineConfig(workdir=os.path.join(out_dir, "work"),
                                        **cfg["pipeline"]))
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            port_log.tee_log_file(None)
            return {"wall_s": wall, "cpu_s": _cpu_seconds() - cpu0,
                    "mb": info["assembly_bases"] / 1e6,
                    "stages": dict(STAGE_SECONDS),
                    "launches": dryrun.launch_counts(),
                    "store_bytes": banded.device_store().capacity,
                    "store_resets": banded.device_store().epoch - epoch0}

        warm = {"wall_s": None}
        if warmup:
            warm = one(warm_dir, _load_json(os.path.join(warm_dir, "unit.json")),
                       os.path.join(warm_dir, "out"))
            shutil.rmtree(warm_dir)
        setup_s = time.perf_counter() - T_START - paused

        units, dirs, failed = [], [], 0
        prof = k1 = None
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import ProfilerActivity, profile

                stack.enter_context(Spans(port_log))
                k1 = stack.enter_context(K1Launches(banded))
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                prof = stack.enter_context(profile(activities=acts))
            while sum(u["wall_s"] for u in units) < seconds:
                i = len(units)
                d, info = generate(tmp, params, seed, i)
                try:
                    with torch.profiler.record_function(f"bench:unit{i}") if trace \
                            else contextlib.nullcontext():
                        units.append(one(d, info, os.path.join(d, "out")))
                except Exception:  # the run reports it and fails
                    print(f"unit {i} failed:", file=sys.stderr)
                    traceback.print_exc()
                    failed += 1
                    break
                dirs.append(d)
        peak_host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        record = {"units": units, "setup_s": setup_s,
                  "first_call_s": warm["wall_s"], "peak_host_gib": peak_host_gib,
                  "config": cfg, "traffic": traffic, "trace": None}
        breakdown = None
        if trace:
            from roofline import int_ops_per_s

            tr = reduce_trace(prof)
            rate = int_ops_per_s() if cuda else None
            tr["k1_bound_s"] = k1.bound_s(rate) if cuda else None
            tr["k1_device_s"] = sum(s for n, s in tr["kernel_s"].items()
                                    if "extend_kernel<" in n and ", true," not in n)
            record["trace"] = tr
            breakdown = {
                "device_ops": [[_short(n), s] for n, s in sorted(
                    tr["kernel_s"].items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [[n, s] for n, s in sorted(
                    tr["idle_by_stage"].items(), key=lambda kv: -kv[1])[:10]]}
            del prof, k1
        gc.collect()
        if cuda:
            banded.reset_device_store(1 << 20)
            torch.cuda.empty_cache()

        rng = np.random.default_rng([int(seed) % 2**64, 7])
        t_check = time.perf_counter()
        counts = [reference.check_unit(d, os.path.join(d, "out"), rng) for d in dirs]
        check_s = time.perf_counter() - t_check
        nums = reference.numbers(counts)
        correct, rows = reference.judge(nums, cell["limits"])
        correct = correct and failed == 0 and len(units) > 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    for m in cell["metrics"][1 if trace else 0]:
        value = reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["cell"]["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
    line = {"correct": bool(correct), "attempted": len(units) + failed,
            "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["info"] = {**reference.info(counts), "check_s": check_s,
                    "walls_s": [u["wall_s"] for u in units],
                    "cpu_s": [u["cpu_s"] for u in units]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return {"line": line, "record": record}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    chips = load_cell(args.workload)["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the measured process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = out["line"]
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
