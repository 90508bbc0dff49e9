"""Fixtures of the benchmark's tests: a copy of the benchmark's files
with one throwaway cell small enough to run the port's plain versions on
the CPU, added as files and entries only."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

#: the throwaway cell: a 60 kb genome with 2 gaps and 20x reads of
#: 10 kb +- 4 kb, the example's read error and pipeline settings
TINY = "tiny.two_gaps"


def add_cell(root: str, config: dict, traffic: dict, limits: dict,
             workload: str = TINY, metric: tuple[dict, str] | None = None) -> None:
    """Add a configuration, a traffic mix, a cell, its limits and
    optionally a per-layer metric (its entry and its reader's source) to
    the benchmark under ``root``, by new files and new entries only."""
    cfg_name, traffic_name = workload.split(".")
    with open(os.path.join(root, "benchmark", "configs", f"{cfg_name}.json"), "w") as fh:
        json.dump(config, fh)
    with open(os.path.join(root, "benchmark", "traffic", f"{traffic_name}.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(root, "benchmark", "limits", f"{workload}.json"), "w") as fh:
        json.dump({"limits": limits}, fh)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": cfg_name, "source": "the benchmark's tests",
                            "file": f"benchmark/configs/{cfg_name}.json",
                            "reduced": [], "why": "a CPU-sized cell for the tests"})
    spec["workloads"].append({"name": workload, "config": cfg_name,
                              "traffic": traffic_name, "chips": 1,
                              "why": "a cell small enough for the CPU"})
    if metric is not None:
        entry, source = metric
        spec["per_layer"].append(entry)
        with open(os.path.join(root, "benchmark", "metrics", f"{entry['name']}.py"), "w") as fh:
            fh.write(source)
    with open(path, "w") as fh:
        json.dump(spec, fh)


def copy_benchmark(dest: str) -> str:
    """``BENCHMARK.json`` and the benchmark's data and readers under
    ``dest``; returns ``dest``."""
    os.makedirs(os.path.join(dest, "benchmark"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(dest, "benchmark", sub))
    return dest


def tiny_config() -> dict:
    with open(os.path.join(BENCH, "configs", "example.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny", assembly_mb=0.06, repeats_per_mb=0,
               read_mean=10_000, read_sd=4_000, reduced=[])
    return cfg


TINY_TRAFFIC = {"gaps": {"gaps_per_mb": 33.4, "gap_min": 80, "gap_max": 300,
                         "gap_margin": 8_000}}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    """A benchmark root holding the throwaway CPU cell, with the limits
    of ``example.sparse``."""
    root = copy_benchmark(str(tmp_path_factory.mktemp("bench-root")))
    with open(os.path.join(BENCH, "limits", "example.sparse.json")) as fh:
        limits = json.load(fh)["limits"]
    add_cell(root, tiny_config(), TINY_TRAFFIC, limits)
    return root


@pytest.fixture(scope="session")
def one_thread():
    """The port's plain versions on one PyTorch thread (the tests share
    the machine)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
