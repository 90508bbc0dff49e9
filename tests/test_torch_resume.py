"""Resume from a workdir, and a seeded purge, in the port against JAX.

The JAX package's ``close_gaps`` runs once with a workdir on the 30 kb
one-gap scenario of ``test_torch_slice.py`` (module fixture).  The port
(``set_device("cpu")``, plain kernel versions) then works on copies of
that workdir, so each case recomputes only the stages under test: the
port must adopt a JAX workdir (the fingerprint covers the inputs, the
scaffold structure and 13 options), rewrite what it recomputes with
JAX's arrays, and give JAX's FASTA records, AGP and BED rows.
Tolerance 0 throughout.  The stages a case must not recompute are
replaced by functions that fail.
"""

import json
import os
import shutil

import numpy as np
import pytest
from test_torch_slice import (JAX_CLOSE_GAPS_SHA256, close_gaps_digest,
                              close_gaps_scenario)

from dentist_tpu_torch import pipeline as port_pl
from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.scenarios import closed_gap_pairs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_LATER_STAGES = ("masks_for", "collect_pile_ups", "process_pile_ups",
                 "_validation_pass")


@pytest.fixture(autouse=True)
def _single_device_cpu(monkeypatch):
    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(scenario args, JAX's complete workdir, JAX's result)."""
    from dentist_tpu import pipeline as jax_pl

    args = close_gaps_scenario()
    wd = str(tmp_path_factory.mktemp("jax") / "wd")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DENTIST_TPU_FORCE_SINGLE", "1")
        result = jax_pl.close_gaps(
            *args, jax_pl.PipelineConfig(read_coverage=20.0, workdir=wd))
    assert close_gaps_digest(result) == JAX_CLOSE_GAPS_SHA256
    return args, wd, result


def _copy(jax_run, tmp_path, name="wd"):
    dst = str(tmp_path / name)
    shutil.copytree(jax_run[1], dst)
    return dst


def _boom(*a, **k):
    raise AssertionError("a stage with a valid artifact was recomputed")


def _fail_stages(monkeypatch, *names):
    for name in names:
        monkeypatch.setattr(port_pl, name, _boom)


def _port(args, wd, **kw):
    return port_pl.close_gaps(
        *args, port_pl.PipelineConfig(read_coverage=20.0, workdir=wd, **kw))


def _assert_output_equal(got, want):
    assert got.records == want.records
    assert got.agp_rows == want.agp_rows
    assert got.bed_rows == want.bed_rows
    assert got.n_closed_gaps == want.n_closed_gaps


def _assert_npz_equal(got, want):
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for key in w.files:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _fingerprint(wd):
    with open(os.path.join(wd, "manifest.json")) as fh:
        return json.load(fh)["fingerprint"]


def test_fingerprint_equals_jax(jax_run, tmp_path):
    """With the scaffold structure, the port's token is the fingerprint in
    JAX's manifest; without it, both packages' states write one token."""
    from dentist_tpu import pipeline as jax_pl

    args, wd, _ = jax_run
    contigs, structure, reads, _ = args
    cfg = port_pl.PipelineConfig(read_coverage=20.0, workdir=_copy(jax_run, tmp_path))
    state = port_pl._ResumeState(cfg, contigs, reads, structure)
    assert state.valid and state.token == _fingerprint(wd)
    bare = {}
    for pkg, pl in (("jax", jax_pl), ("port", port_pl)):
        bare_wd = str(tmp_path / f"bare_{pkg}")
        bare[pkg] = pl._ResumeState(
            pl.PipelineConfig(read_coverage=20.0, workdir=bare_wd),
            contigs, reads).token
        assert _fingerprint(bare_wd) == bare[pkg]
    assert bare["port"] == bare["jax"] != state.token


def test_resume_straight_to_output(jax_run, tmp_path, monkeypatch):
    args, _, want = jax_run
    _fail_stages(monkeypatch, *_LATER_STAGES)
    _assert_output_equal(_port(args, _copy(jax_run, tmp_path)), want)


def test_resume_after_collect(jax_run, tmp_path, monkeypatch):
    """A run stopped after collect (``tests/test_resume.py:50``): the port
    recomputes consensus and validation, writes JAX's insertions and
    skip list, and a second call on the now complete workdir resumes
    straight to the same output."""
    args, jax_wd, want = jax_run
    wd = _copy(jax_run, tmp_path)
    for name in ("insertions.npz", "validation.json"):
        os.remove(os.path.join(wd, name))
    _fail_stages(monkeypatch, "masks_for", "collect_pile_ups")
    _assert_output_equal(_port(args, wd), want)
    _assert_npz_equal(os.path.join(wd, "insertions.npz"),
                      os.path.join(jax_wd, "insertions.npz"))
    with open(os.path.join(wd, "validation.json")) as a, \
            open(os.path.join(jax_wd, "validation.json")) as b:
        assert a.read() == b.read()
    _fail_stages(monkeypatch, *_LATER_STAGES)
    _assert_output_equal(_port(args, wd), want)


def test_resume_after_mapping(jax_run, tmp_path, monkeypatch):
    """The masks and ``reads.las.npz`` kept, the pile-ups and everything
    after them gone: the port reads which artifacts exist once, when its
    ``_ResumeState`` is built, where JAX checks at every load; each stage
    loads before it saves, so the port recomputes collect onwards and
    writes JAX's pile-ups.  Run with ``no_validation=True`` (validation
    is not in the fingerprint, and ``test_resume_after_collect``
    recomputes it) to keep the file inside its time budget."""
    args, jax_wd, want = jax_run
    wd = _copy(jax_run, tmp_path)
    for name in ("pile-ups.npz", "insertions.npz", "validation.json"):
        os.remove(os.path.join(wd, name))
    _fail_stages(monkeypatch, "masks_for", "_validation_pass")
    _assert_output_equal(_port(args, wd, no_validation=True), want)
    for name in ("pile-ups.npz", "insertions.npz"):
        _assert_npz_equal(os.path.join(wd, name), os.path.join(jax_wd, name))
    assert not os.path.exists(os.path.join(wd, "validation.json"))


def test_seeded_purge(jax_run, tmp_path, monkeypatch):
    """A skip list naming the closed gap: both packages resume to output
    with the gap purged, and their outputs are equal."""
    from dentist_tpu import pipeline as jax_pl

    args, _, closed = jax_run
    (pair,) = closed_gap_pairs(closed.bed_rows)
    outs = {}
    for pkg in ("jax", "port"):
        wd = _copy(jax_run, tmp_path, pkg)
        with open(os.path.join(wd, "validation.json"), "w") as fh:
            json.dump({"skip_gaps": [list(pair)]}, fh)
        if pkg == "jax":
            outs[pkg] = jax_pl.close_gaps(
                *args, jax_pl.PipelineConfig(read_coverage=20.0, workdir=wd))
        else:
            _fail_stages(monkeypatch, *_LATER_STAGES)
            outs[pkg] = _port(args, wd)
    _assert_output_equal(outs["port"], outs["jax"])
    assert outs["port"].n_closed_gaps == 0 < closed.n_closed_gaps
    assert not outs["port"].bed_rows


class _Stop(Exception):
    pass


@pytest.mark.parametrize("change", [{"min_spanning_reads": 5},
                                    {"resume": False}],
                         ids=["changed_option", "resume_off"])
def test_invalidated_workdir_recomputes(jax_run, tmp_path, monkeypatch, change):
    """A changed option (``tests/test_resume.py:89``) or ``resume=False``
    (``:115``): the port recomputes from the masks, the stale artifacts
    are gone, and the rewritten manifest is the one JAX writes for the
    same config."""
    from dentist_tpu import pipeline as jax_pl

    args, _, _ = jax_run
    contigs, structure, reads, _ = args
    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise _Stop

    monkeypatch.setattr(port_pl, "masks_for", spy)
    wd = _copy(jax_run, tmp_path, "port")
    with pytest.raises(_Stop):
        _port(args, wd, **change)
    assert calls
    assert not any(os.path.exists(os.path.join(wd, n)) for n in port_pl._ARTIFACTS)
    jax_wd = _copy(jax_run, tmp_path, "jax")
    jax_pl._ResumeState(jax_pl.PipelineConfig(read_coverage=20.0, workdir=jax_wd,
                                              **change),
                        contigs, reads, structure)
    assert _fingerprint(wd) == _fingerprint(jax_wd)
    assert sorted(os.listdir(wd)) == sorted(os.listdir(jax_wd)) == ["manifest.json"]
