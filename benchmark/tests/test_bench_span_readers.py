"""The readers of the port's own spans (``device_wait_s``, ``seed_wait_s``,
``job_build_s``, ``parse_s``, ``checkpoint_s``) on a hand-built record:
each is the mean over the window's pipelines of one ``STAGE_SECONDS``
key, and reads nothing where no pipeline has that key (the parent of the
change that added the spans)."""

from __future__ import annotations

import json
import os

import pytest

from conftest import ROOT

import run

KEYS = {"device_wait_s": "wait.device", "seed_wait_s": "aligner.seed_wait",
        "job_build_s": "aligner.make_jobs", "parse_s": "io.parse",
        "checkpoint_s": "io.checkpoint"}

#: the stage keys of a pipeline before the spans existed
OLD_STAGES = {"dentist_tpu_torch.pipeline.run_pipeline": 9.0,
              "dentist_tpu_torch.pipeline.close_gaps": 7.0,
              "masks.mapReads": 2.0, "stage.process": 2.5}


def _record(*stages):
    return {"units": [{"stages": s} for s in stages]}


@pytest.mark.parametrize("name", KEYS)
def test_reader_is_the_mean_of_its_key(name):
    key = KEYS[name]
    read = run.reader(name)
    rec = _record({**OLD_STAGES, key: 0.5}, {**OLD_STAGES, key: 1.5},
                  {**OLD_STAGES, key: 4.0})
    assert read(rec) == pytest.approx(2.0)
    # another key that ends like it, or holds it, is not read
    assert read(_record({f"x.{key}": 1.0, f"{key}.x": 2.0})) is None


@pytest.mark.parametrize("name", KEYS)
def test_reader_reads_nothing_without_the_span(name):
    read = run.reader(name)
    assert read(_record(OLD_STAGES, OLD_STAGES)) is None
    assert read(_record()) is None


def test_entries_report_in_every_cell():
    """The five are per-layer span metrics moving ``pipeline_mb_s`` with no
    ``workloads`` list, so every cell's traced run reports them."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in KEYS:
        m = entries[name]
        assert (m["source"], m["moves"], m["unit"]) == ("program_span", "pipeline_mb_s", "s")
        assert "workloads" not in m
    for cell in spec["workloads"]:
        assert set(KEYS) <= {m["name"] for m in run.load_cell(cell["name"])["metrics"][1]}


def test_keys_miss_the_suffixes_the_older_readers_match():
    """``io_s`` and the ``stage_s.*`` readers match keys by suffix; no new
    key may end in one of them."""
    suffixes = (".run_pipeline", ".close_gaps", ".masks_for", "masks.mapReads",
                "stage.collect", "stage.process", "._validation_pass")
    assert not [k for k in KEYS.values() if k.endswith(suffixes)]
