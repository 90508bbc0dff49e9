"""Phase C's digests: the port against the JAX package, and the reference.

``chip_smoke.py`` phase 16 holds the port's run of phase C on the card to
the JAX package's CPU run by the digests of
``scenarios.phase_c_digests`` (inputs, outputs, stage artifacts, one per
closed gap), stored by ``scripts/phase_c_reference.py`` in
``scripts/phase_c_reference.json``.  Here both packages run
``phase_c_scenario(mb=0.2, n_gaps=3)`` through ``run_pipeline`` with a
workdir on the CPU (the port on its kernels' plain versions) and must
give equal digests; a one-base change in the output must name the one
gap (or no gap) it lies in; and the reference file must hold every
entry phase 16 reads.  Tolerance 0 throughout.  The port's run is
recorded by ``dryrun.LaunchRecorder``, whose buckets phase 16 holds
against the kernels' plain versions where phase 5 did not launch them.
"""

import contextlib
import json
import os
import shutil

import numpy as np
import pytest

import chip_smoke
from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.dryrun import LaunchRecorder
from dentist_tpu_torch.scenarios import (diff_digests, phase_c_digests,
                                         phase_c_scenario, write_scenario,
                                         write_truth)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MB, GAPS = 0.2, 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scenario, the JAX package's and the port's run directories
    (inputs, ``out.*``, ``work/``), and the recorder of the port's run."""
    from dentist_tpu import pipeline as jax_pl
    from dentist_tpu_torch import pipeline as port_pl

    sc = phase_c_scenario(mb=MB, n_gaps=GAPS)
    dirs = {}
    rec = LaunchRecorder()
    for name, pl in (("jax", jax_pl), ("port", port_pl)):
        d = str(tmp_path_factory.mktemp(name))
        asm, reads = write_scenario(sc, d)
        write_truth(sc, d)
        with pytest.MonkeyPatch.context() as mp, (
                rec if name == "port" else contextlib.nullcontext()):
            mp.setenv("DENTIST_TPU_FORCE_SINGLE", "1")
            set_device("cpu")
            pl.run_pipeline(asm, reads, os.path.join(d, "out.fasta"),
                            pl.PipelineConfig(read_coverage=20.0,
                                              workdir=os.path.join(d, "work")))
        dirs[name] = d
    return sc, dirs, rec


def _digests(sc, d):
    return phase_c_digests(sc, d, os.path.join(d, "work"))


def test_port_digests_equal_jax(runs):
    sc, dirs, _ = runs
    want, got = (_digests(sc, dirs[k]) for k in ("jax", "port"))
    assert diff_digests(want, got) == []
    assert got == want
    assert want["closed"] == len(want["gaps"]) == GAPS
    assert set(want["artifacts"]) == {
        "dust.mask.npz", "repeats.mask.npz", "repeats-H.mask.npz",
        "reads.las.npz", "pile-ups.npz", "insertions.npz", "validation.json"}


@pytest.mark.parametrize("where", [0, 1, 2, "contig"])
def test_one_base_change_names_its_gap(runs, tmp_path, where):
    """One base of the port's output changed inside the span of the
    ``where``-th closed gap's BED row (or in a contig, outside every
    gap): the digests name the output FASTA and exactly that gap."""
    sc, dirs, _ = runs
    want = _digests(sc, dirs["port"])
    d = str(tmp_path / "run")
    shutil.copytree(dirs["port"], d)
    rows = [g["row"].split("\t") for g in want["gaps"].values()]
    keys = list(want["gaps"])
    if where == "contig":
        pos = int(rows[0][1]) - 1000
    else:
        pos = (int(rows[where][1]) + int(rows[where][2])) // 2
    path = os.path.join(d, "out.fasta")
    with open(path) as fh:
        lines = fh.read().split("\n")
    width = len(lines[1])
    i, j = 1 + pos // width, pos % width
    line = lines[i]
    lines[i] = line[:j] + ("A" if line[j] not in "Aa" else "C") + line[j + 1:]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    named = diff_digests(want, _digests(sc, d))
    assert named == ["out.fasta"] + ([] if where == "contig"
                                     else [f"gap {keys[where]}"])


def test_launch_recorder_buckets(runs, tmp_path):
    """The recorder saw every main-path kernel's wrapper called, put the
    pipeline's names back on leaving, kept each K4 and K4w bucket's
    first inputs at the bucket's shapes, and its tables go through
    ``torch.save`` and its summary through JSON."""
    import torch

    from dentist_tpu_torch.ops import banded, consensus

    rec = runs[2]
    for mod, name in ((banded, "extend"), (banded, "store_write"),
                      (consensus, "nw_round_packed"), (consensus, "nw_round_resident"),
                      (consensus, "nw_dist_pairs_packed"), (consensus, "round_pack"),
                      (consensus, "window_pack")):
        assert not getattr(mod, name).__name__.startswith("recorded"), name
    assert rec.k1 and rec.k3 and rec.k5
    assert {k[0] for k in rec.k2} == {"K2p", "K2r"}
    assert {k[0] for k in rec.k4} == {"K4", "K4w"}
    for (R, N), (c, live, rows) in rec.k1.items():
        assert 0 < live <= c * N and 0 < rows <= live * R
    for (mode, T, RL, N), (c, live) in rec.k2.items():
        assert 0 <= live <= c * N and RL == 2 * T
    for (V, NB, TW, TWp, RW), r in rec.k3.items():
        assert r["live"] <= r["launches"] * V and r["filled"] <= r["live"] * NB
        assert r["tl_hist"].sum() == r["live"] and len(r["rl_hist"]) == RW + 2
    for (mode, T, N, sparse, resident), r in rec.k4.items():
        fields = r["inputs"][2 if mode == "K4w" else 1]
        assert fields[0].shape[0] == N and r["live"] <= r["launches"] * N
        if mode == "K4w":
            assert fields[0].shape[1] == T
    path = str(tmp_path / "launches.pt")
    torch.save(rec.tables(), path)
    back = torch.load(path, weights_only=False)
    assert back["k1"] == rec.k1 and back["k2"] == rec.k2 and back["k5"] == rec.k5
    for key, r in rec.k4.items():
        got, want = back["k4"][key]["inputs"], r["inputs"]
        flat = lambda x: [y for z in x for y in (z if isinstance(z, tuple) else (z,))]
        assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                   for a, b in zip(flat(got), flat(want)))
    summary = json.loads(json.dumps(rec.summary()))
    assert summary["K5"] == [n for n, _ in rec.k5]
    assert sum(v[0] for k, v in summary.items() if k.startswith("K1 ")) == sum(
        c for c, _, _ in rec.k1.values())


class _Phase5:
    """A phase-5 recorder's tables, as ``phase_c_holds`` reads them."""
    k1 = {(504, 128): [2, 100, 9]}
    k2 = {("K2p", 2048, 4096, 32): [1, 1], ("K2r", 192, 384, 2048): [3, 10]}
    k3 = {(4096, 32, 34, 36, 48): {"launches": 1}}
    k4 = {("K4", 2048, 32, True, False): {"launches": 1}}
    k5 = [(1000, 0), (64, 16)]


def test_phase_c_holds_takes_the_new_buckets(monkeypatch):
    """Phase 16 holds, for each kernel, the buckets and K5 upload sizes
    that phase C's two runs launched and phase 5 did not, summed over
    the runs; K1 without K1p, K2p and K2r without K2."""
    hist = lambda *x: np.array(x)
    k4 = lambda n: {"launches": n, "live": 2 * n, "inputs": ("chars", n)}
    k3 = lambda n: {"launches": n, "live": 3 * n, "filled": 5 * n, "cells": 7 * n,
                    "word_rows": n, "tl_hist": hist(n, 1), "rl_hist": hist(1, n)}
    small = {"k1": {(504, 128): [5, 5, 5], (4536, 128): [1, 2, 3]},
             "k2": {("K2p", 2048, 4096, 32): [4, 4], ("K2p", 16384, 32768, 32): [1, 7]},
             "k3": {(4096, 32, 34, 36, 48): k3(9), (256, 64, 34, 36, 48): k3(1)},
             "k4": {("K4", 2048, 32, True, False): k4(3), ("K4", 16384, 32, False, False): k4(1)},
             "k5": [(1000, 0), (77, 0)]}
    large = {"k1": {(4536, 128): [2, 4, 6]},
             "k2": {("K2p", 16384, 32768, 32): [2, 9], ("K2r", 192, 384, 32): [5, 6]},
             "k3": {(256, 64, 34, 36, 48): k3(2)},
             "k4": {("K4", 16384, 32, False, False): k4(2),
                    ("K4w", 192, 128, False, False): k4(5)},
             "k5": [(88, 32)]}
    seen = {}
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    monkeypatch.setattr(chip_smoke, "phase_k1", lambda b, base, legacy, packed: seen.update(
        k1=(b, base, legacy, packed)))
    monkeypatch.setattr(chip_smoke, "phase_k2", lambda b, base, full: seen.update(
        k2=(b, base, full)))
    monkeypatch.setattr(chip_smoke, "phase_k3", lambda b, base: seen.update(k3=(b, base)))
    monkeypatch.setattr(chip_smoke, "phase_k4", lambda b, base, fixed: seen.update(
        k4=(b, base, fixed)))
    monkeypatch.setattr(chip_smoke, "phase_k5", lambda u, base: seen.update(k5=(u, base)))
    chip_smoke.phase_c_holds([small, large], _Phase5)
    assert seen["k1"] == ({(4536, 128): [3, 6, 9]}, None, (), False)
    assert seen["k2"] == ({("K2p", 16384, 32768, 32): [3, 16],
                           ("K2r", 192, 384, 32): [5, 6]}, None, False)
    (new3, base3) = seen["k3"]
    assert base3 is None and list(new3) == [(256, 64, 34, 36, 48)]
    r = new3[256, 64, 34, 36, 48]
    assert (r["launches"], r["live"], r["filled"]) == (3, 9, 15)
    assert r["tl_hist"].tolist() == [3, 2] and r["rl_hist"].tolist() == [2, 3]
    assert seen["k4"] == ({("K4", 16384, 32, False, False): {
                               "launches": 3, "live": 6, "inputs": ("chars", 1)},
                           ("K4w", 192, 128, False, False): k4(5)}, None, {})
    assert seen["k5"] == ([(77, 0), (88, 32)], None)


def _reference():
    with open(chip_smoke.PHASE_C_REFERENCE) as fh:
        return json.load(fh)


@pytest.mark.parametrize("mb,gaps", chip_smoke.PHASE_C_SIZES)
def test_reference_entry_is_complete(mb, gaps):
    """Every entry phase 16 (and phase 15, at 3 Mb) reads, one digest per
    closed gap, and counts that agree with each other."""
    e = _reference()[str(mb)]
    assert e["scenario"] == {"mb": mb, "gaps": gaps}
    assert set(e["inputs"]) == {"assembly.fasta", "reads.fasta"}
    assert set(e["sha256"]) == {"out.fasta", "out.agp", "out.closed-gaps.bed"}
    assert {"dust.mask.npz", "repeats.mask.npz", "repeats-H.mask.npz",
            "reads.las.npz", "pile-ups.npz", "insertions.npz",
            "validation.json"} <= set(e["artifacts"])
    digests = [*e["inputs"].values(), *e["sha256"].values(),
               *e["artifacts"].values(), *(g["sha256"] for g in e["gaps"].values())]
    assert all(len(h) == 64 and int(h, 16) >= 0 for h in digests)
    assert len(e["gaps"]) == e["closed"] == e["numClosedGaps"] <= gaps
    for key, g in e["gaps"].items():
        assert f"contigIds={key};" in g["row"]
    assert e["closed_exactly"] == gaps - len(e["inexact"])
    assert e["numCorrectGaps"] <= e["closed"]
    assert e["wall_s"] > 0 and e["stage_s"]
    assert set(e["provenance"]) == {"command", "env", "cpu", "jax", "date"}


def test_reference_inputs_are_the_generators(tmp_path):
    """The data generator still writes the 3 Mb reference's inputs (a
    drift would fail phase 16 before the pipeline runs)."""
    from dentist_tpu_torch.scenarios import file_sha256

    asm, reads = write_scenario(phase_c_scenario(mb=3, n_gaps=16), str(tmp_path))
    want = _reference()["3"]["inputs"]
    assert {"assembly.fasta": file_sha256(asm),
            "reads.fasta": file_sha256(reads)} == want


#: the pile-ups of the two gaps of phase C at 28 Mb that the JAX package
#: closes not byte-exact (8,008,997-8,009,667 and 9,108,631-9,109,531,
#: contigs 45-46 and 50-51), cut from its run's workdir by
#: ``scripts/cut_pile_up_fixture.py``, with that run's insertions for them
INEXACT_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                               "phase_c_inexact_gaps")


def _process_fixture(pkg, d, out):
    """``process_pile_ups`` of package ``pkg`` over the fixture in ``d``,
    with the pipeline's defaults; its insertions saved to ``out``."""
    import importlib

    import numpy as np

    store = importlib.import_module(f"{pkg}.io.store")
    seqs = importlib.import_module(f"{pkg}.models.sequences")
    pileups = importlib.import_module(f"{pkg}.models.pileups")
    process = importlib.import_module(f"{pkg}.models.process")
    with np.load(os.path.join(d, "sequences.npz")) as z:
        contigs = seqs.SeqStore(z["contig_codes"], z["contig_lengths"])
        reads = seqs.SeqStore(z["read_codes"], z["read_lengths"])
    las, chains = store.load_alignments(os.path.join(d, "reads.las.npz"))
    ctx = pileups.ChainCtx(las, chains, contigs.lengths, reads.lengths)
    ins = process.process_pile_ups(
        store.load_pile_ups(os.path.join(d, "pile-ups.npz")), ctx, contigs,
        reads, store.load_mask(os.path.join(d, "repeats-H.mask.npz")),
        process.ProcessConfig(allow_single_reads=False, max_insertion_error=0.1,
                              min_anchor_length=500, min_reads_per_pile_up=3))
    store.save_insertions(out, ins)
    return ins


def test_inexact_gaps_consensus_equals_jax(tmp_path, monkeypatch):
    """The port's process stage (plain kernel versions) over the two
    inexact gaps' pile-ups gives the JAX package's insertions, and both
    give the ones the full 28 Mb run wrote (arrays sha256)."""
    from dentist_tpu_torch.scenarios import npz_sha256

    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")
    set_device("cpu")
    got = {pkg: str(tmp_path / f"{pkg}.npz") for pkg in ("dentist_tpu", "dentist_tpu_torch")}
    ins = {pkg: _process_fixture(pkg, INEXACT_FIXTURE, out) for pkg, out in got.items()}
    assert len(ins["dentist_tpu"]) == 2
    want = npz_sha256(os.path.join(INEXACT_FIXTURE, "insertions.npz"))
    assert npz_sha256(got["dentist_tpu_torch"]) == npz_sha256(got["dentist_tpu"]) == want
