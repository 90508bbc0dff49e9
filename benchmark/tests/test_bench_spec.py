"""BENCHMARK.json against the benchmark's contract, and discovery by
name: a cell, a configuration, a traffic mix and a per-layer metric added
as files and entries only."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, ROOT, TINY, TINY_TRAFFIC, add_cell, copy_benchmark, tiny_config

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    SPEC = json.load(fh)


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_entries_have_the_contract_keys_and_names():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "roofline" not in m["name"] or (m["name"].endswith("_roofline") and m["unit"] == "%")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_cell_finds_its_files_and_reports_enough():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        cell = run.load_cell(w["name"])
        e2e = {m["name"] for m in cell["metrics"][0]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["metrics"][1]
        assert set(cell["limits"])  # a limits file
        run.gen_params(cell["config"], cell["traffic"])  # every size the generator needs
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_configs_state_their_cuts():
    for c in SPEC["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg["source_values"])
        assert cfg["guarantees"] and cfg["assumed"]


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    root = copy_benchmark(str(tmp_path))
    entry = {"name": "gaps_per_pipeline", "unit": "gaps", "better": "higher",
             "source": "program_counter", "layer": "Collect", "moves": "pipeline_mb_s",
             "workloads": [TINY]}
    source = ('def read(record):\n'
              '    return record["traffic"]["gaps"]["gaps_per_mb"] * record["config"]["assembly_mb"]\n')
    add_cell(root, tiny_config(), TINY_TRAFFIC, {"gap_errors_max": 3}, metric=(entry, source))
    cell = run.load_cell(TINY, root)
    assert cell["config"]["assembly_mb"] == 0.06
    assert cell["traffic"] == TINY_TRAFFIC and cell["limits"] == {"gap_errors_max": 3}
    layer = [m["name"] for m in cell["metrics"][1]]
    assert "gaps_per_pipeline" in layer
    # the new metric is this cell's alone
    assert "gaps_per_pipeline" not in [m["name"] for m in run.load_cell("example.sparse", root)["metrics"][1]]
    record = {"config": cell["config"], "traffic": cell["traffic"]}
    assert run.reader("gaps_per_pipeline", root)(record) == pytest.approx(2.004)
    assert run.gen_params(cell["config"], cell["traffic"])["gap_margin"] == 8_000
    # nothing that was there changed
    for sub in ("configs", "traffic", "limits", "metrics"):
        for name in os.listdir(os.path.join(BENCH, sub)):
            with open(os.path.join(BENCH, sub, name), "rb") as a, \
                    open(os.path.join(root, "benchmark", sub, name), "rb") as b:
                assert a.read() == b.read()


def test_unknown_workload_is_refused():
    with pytest.raises(run.BenchError):
        run.load_cell("no.such_cell")
