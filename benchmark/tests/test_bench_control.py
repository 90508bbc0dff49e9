"""The control (consensus polishing off) comes out not correct: on the
CPU at the throwaway cell's size, and on the card at a cell's own size."""

from __future__ import annotations

import functools
import json
import os

import pytest

from conftest import ROOT, TINY

import faults
import run


def test_the_control_is_not_correct_on_the_cpu(tiny_root, one_thread, monkeypatch):
    line = run.run_cell(TINY, 41, 1.0, False, device="cpu",
                        patch=functools.partial(faults.polish_off, monkeypatch.setattr),
                        root=tiny_root)["line"]
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert set(failed) <= {"gap_errors_max", "insertion_errors_max", "gaps_wrong_pct"} and failed


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["example.sparse", "large_assembly.sparse"])
def test_the_control_is_not_correct_on_the_card(workload, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        seconds = json.load(fh)["run_seconds"]
    for seed in (9101, 9102, 9103):
        line = run.run_cell(workload, seed, seconds, False,
                            patch=functools.partial(faults.polish_off,
                                                    monkeypatch.setattr))["line"]
        assert line["correct"] is False
