"""Whole runs of the throwaway CPU cell through the harness: the last
line's keys, the faults the check has to catch, the no-JAX check and the
refusal without a card."""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, TINY, copy_benchmark

import faults
import run


def _run(tiny_root, patch=None, trace=False, seed=31):
    return run.run_cell(TINY, seed, 1.0, trace, device="cpu", patch=patch, root=tiny_root)


def test_the_last_line(tiny_root, one_thread):
    out = _run(tiny_root, trace=True)
    line = out["line"]
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and "breakdown" in keys
    assert line["correct"] is True and line["attempted"] == 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                   "busy_s", "window_s"}
    # on the CPU no device op runs: the device metrics are left out
    names = set(line["metrics"])
    assert {"io_s", "first_call_s", "stage_s.masks", "stage_s.process"} <= names
    assert "device_idle_pct" not in names and "extend_roofline" not in names
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)
    untraced = _run(tiny_root, seed=32)["line"]
    assert set(untraced["metrics"]) == {"pipeline_mb_s", "peak_host_gib", "setup_s"}
    assert "breakdown" not in untraced and untraced["correct"] is True


def _pipeline():
    return sys.modules["dentist_tpu_torch.pipeline"]


def test_consensus_returning_nothing_fails(tiny_root, one_thread, monkeypatch):
    """A step that returns its state unchanged: no insertion, no gap
    closed."""
    def patch():
        monkeypatch.setattr(_pipeline(), "process_pile_ups", lambda *a, **k: [])
    line = _run(tiny_root, patch)["line"]
    assert line["correct"] is False
    assert line["checks"]["gaps_wrong_pct"]["value"] == 100.0


def test_half_the_pile_ups_left_out_fails(tiny_root, one_thread, monkeypatch):
    """Half of the batch left out: consensus over every other pile-up."""
    def patch():
        orig = _pipeline().process_pile_ups
        monkeypatch.setattr(_pipeline(), "process_pile_ups",
                            lambda pile_ups, *a, **k: orig(pile_ups[::2], *a, **k))
    line = _run(tiny_root, patch)["line"]
    assert line["correct"] is False
    assert line["checks"]["gaps_wrong_pct"]["value"] >= 50.0


def test_an_altered_insertion_fails(tiny_root, one_thread, monkeypatch):
    """An answer altered where it is produced: one insertion's bases
    shifted by one code."""
    def patch():
        orig = _pipeline().process_pile_ups

        def altered(*a, **k):
            out = orig(*a, **k)
            if out:
                out[0].sequence = ((np.asarray(out[0].sequence) + 1) % 4).astype(np.uint8)
            return out
        monkeypatch.setattr(_pipeline(), "process_pile_ups", altered)
    line = _run(tiny_root, patch)["line"]
    assert line["correct"] is False
    assert line["checks"]["gap_errors_max"]["value"] > line["checks"]["gap_errors_max"]["limit"]


def test_half_the_mapping_lanes_left_out_fails(tiny_root, one_thread, monkeypatch):
    """Half of the batch left out in the mapping layer: of every K1
    launch's lanes that extend, the second half return nothing."""
    line = _run(tiny_root, functools.partial(faults.lanes_left_out,
                                             monkeypatch.setattr))["line"]
    assert line["correct"] is False
    for name in ("reads_unmapped_pct", "overlap_unaligned_pct"):
        assert line["checks"][name]["value"] > line["checks"][name]["limit"]


def test_raised_alignment_diffs_fail(tiny_root, one_thread, monkeypatch):
    """An answer altered where it is produced: every K1 extension
    reports more differences than its path has.  Nothing but the
    alignments' distance above the best sees it."""
    line = _run(tiny_root, functools.partial(faults.diffs_raised,
                                             monkeypatch.setattr))["line"]
    assert line["correct"] is False
    over = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert over == ["diffs_excess_pct"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert run.forbidden_modules() == []
    for name in ("dentist_tpu_torch", "dentist_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("jax.numpy", "dentist_tpu.ops.banded", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == ["dentist_tpu", "flax", "jax"]


def test_no_result_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", "example.sparse", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the command exits non-zero and prints nothing on stdout."""
    copy_benchmark(str(tmp_path))
    for name in ("run.py", "gen.py", "reference.py", "roofline.py", "control.py",
                 "faults.py"):
        (tmp_path / "benchmark" / name).write_bytes(open(os.path.join(BENCH, name), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "example.sparse",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
