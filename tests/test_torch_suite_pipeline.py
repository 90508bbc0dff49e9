"""The JAX package's tests of contig-edge anchoring and of whole gap
closing, on the port.

Counterparts of ``tests/test_anchor_unique.py:16-63`` (``_locate_anchor``:
a unique hit, a duplicate, a periodic anchor, the edit-tolerant
fallback, an edit-tolerant duplicate, the fallback against a brute-force
DP) and of the gap-closing tests ``tests/test_anchor_unique.py:87`` (a
copy of the entering contig's edge inside the gap never mis-splices),
``tests/test_bubbles.py:16`` (bubble resolution splits a pile-up that
skips a masked contig), ``tests/test_overlap_crop.py:15`` (overlapping
contigs close with a crop), ``tests/test_multiscaffold.py:15`` (two
chromosomes close independently) and ``tests/test_validation_pass.py:26,33``
(a supported gap survives validation, an unsupported one is purged).

``_locate_anchor`` runs in both packages on the JAX test's inputs, and
the results must be equal.  Each gap-closing case is a scenario of
``dentist_tpu_torch.scenarios.SUITE``, built with the JAX test's seeds
and sizes from the port's copies of ``sim/`` and ``io/`` and run through
the port as the test calls it (``scenarios.run_suite``; on the CPU, the
kernels' plain versions, ``DENTIST_TPU_FORCE_SINGLE=1``).  Its digests
(``scenarios.suite_digests``: the sha256 of the FASTA records, AGP and
BED rows, the gaps closed and the skip set; the bubbles case's
alignments, chains, pile-ups and insertions by their arrays) must equal
the JAX package's run of the same scenario in
``scenarios.SUITE_REFERENCE`` (``scripts/jax_suite_reference.py``, which
``chip_smoke.py`` phase 19 holds the card to), and the JAX test's own
property must hold on the port's result.  The JAX side of these six runs
takes about 70 s of CPU here, so it runs live for the overlap case alone
(4 s), whose records, AGP and BED rows must also equal the live run's
byte for byte, and which shows the reference is the package's current
output.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from dentist_tpu_torch import scenarios as S
from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.eval.check_results import check_results
from dentist_tpu_torch.io.fasta import codes_to_seq, seq_to_codes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _single_device_cpu(monkeypatch):
    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")


@pytest.fixture(scope="module")
def reference():
    with open(S.SUITE_REFERENCE) as fh:
        return json.load(fh)["scenarios"]


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _unique():  # :16
    cons = _rand(600, 1)
    return cons, cons[100:164].copy(), lambda loc, A: loc == (100, 164, 0)


def _duplicate():  # :23
    cons, anchor = _rand(600, 2), _rand(64, 3)
    cons[50:114] = anchor
    cons[400:464] = anchor
    return cons, anchor, lambda loc, A: loc is A


def _periodic():  # :31
    return (np.zeros(200, np.uint8), np.zeros(64, np.uint8),
            lambda loc, A: loc is not A and loc is not None and loc[2] == 0)


def _fallback_unique():  # :40
    cons = _rand(600, 4)
    anchor = cons[200:264].copy()
    anchor[10] = (anchor[10] + 1) % 4
    anchor = np.delete(anchor, 30)
    return cons, anchor, lambda loc, A: (
        loc is not None and loc is not A and loc[2] == 2
        and abs(loc[0] - 200) <= 2 and abs(loc[1] - 264) <= 2)


def _fallback_duplicate():  # :52
    cons, probe = _rand(800, 5), _rand(64, 6)
    for start in (100, 500):
        copy = probe.copy()
        copy[7] = (copy[7] + 1) % 4
        cons[start : start + 64] = copy
    return cons, probe, lambda loc, A: loc is A


_ANCHOR_CASES = {"unique_exact_hit": _unique,
                 "duplicate_is_ambiguous": _duplicate,
                 "periodic_is_one_placement": _periodic,
                 "edit_tolerant_unique": _fallback_unique,
                 "edit_tolerant_duplicate_is_ambiguous": _fallback_duplicate}


@pytest.mark.parametrize("case", list(_ANCHOR_CASES))
def test_locate_anchor_equals_jax(case):
    from dentist_tpu.models import process as JP
    from dentist_tpu_torch.models import process as PP

    cons, anchor, holds = _ANCHOR_CASES[case]()
    want = JP._locate_anchor(cons, anchor, max_edits=8)
    got = PP._locate_anchor(cons, anchor, max_edits=8)
    assert got == want
    assert holds(got, PP.AMBIGUOUS)


def test_locate_anchor_fallback_equals_jax_and_bruteforce():
    """``:63``: on ten random 80-base sequences and 12-base anchors the
    edit count equals the brute-force DP's minimum (free leading and
    trailing gaps in the sequence) wherever the placement is unique, and
    every result equals JAX's."""
    from dentist_tpu.models import process as JP
    from dentist_tpu_torch.models import process as PP

    rng = np.random.default_rng(7)
    for _ in range(10):
        cons = rng.integers(0, 4, 80).astype(np.uint8)
        anchor = rng.integers(0, 4, 12).astype(np.uint8)
        la, lc = len(anchor), len(cons)
        prev = np.zeros(lc + 1, dtype=np.int64)
        for i in range(1, la + 1):
            cur = np.empty(lc + 1, dtype=np.int64)
            cur[0] = i
            for j in range(1, lc + 1):
                cur[j] = min(prev[j - 1] + (cons[j - 1] != anchor[i - 1]),
                             prev[j] + 1, cur[j - 1] + 1)
            prev = cur
        loc = PP._locate_anchor(cons, anchor, max_edits=la)
        assert loc == JP._locate_anchor(cons, anchor, max_edits=la)
        if loc is not PP.AMBIGUOUS:
            assert loc is not None and loc[2] == int(prev.min())


def _output(out) -> str:
    return "".join(s for _, s in out["result"].records).lower()


def _truth(out) -> str:
    return codes_to_seq(np.concatenate(out["case"].truths)).lower()


def _repeat_edge(out):
    """Closed means byte-exact (no splice at the edge's repeat copy);
    skipped keeps the gap's ``n``s."""
    if out["result"].n_closed_gaps == 1:
        assert _output(out) == _truth(out)
    else:
        assert "n" in _output(out)


def _bubbles(out):
    """The mask suppresses the middle contig's anchors; without bubble
    resolution one pile-up skips c1→c3, with it the skipper splits into
    c1–c2 and c2–c3, and both gaps close byte-exact."""
    las, ctx, case = out["las"], out["ctx"], out["case"]
    assert not np.any(las.a_id == 2)
    joins = {tuple(sorted((ctx.chains[p.parts[0].chain_idx].a_id,
                           ctx.chains[p.parts[-1].chain_idx].a_id)))
             for pu in out["plain"] for p in pu if len(p.parts) == 2}
    assert (1, 3) in joins
    pairs = {}
    for pu in out["pile_ups"]:
        for rep in pu:
            if rep.is_gap(ctx):
                key = tuple(sorted(ctx.chains[rep.parts[i].chain_idx].a_id
                                   for i in (0, 1)))
                pairs[key] = pairs.get(key, 0) + 1
    assert (1, 2) in pairs and (2, 3) in pairs and (1, 3) not in pairs, pairs
    gap_ins = [i for i in out["insertions"] if i.is_gap]
    assert len(gap_ins) == 2
    for ins in gap_ins:
        g = case.structure.gaps[ins.start_node[0] - 1]
        assert np.array_equal(ins.sequence, case.truths[0][g.begin:g.end])


def _overlap_crop(out):
    """One gap closed by cropping the entering contig, byte-exact."""
    assert out["result"].n_closed_gaps == 1
    assert _output(out) == _truth(out)


def _two_chromosomes(out):
    """Both gaps closed and correct, one output record per chromosome,
    coordinates translated within each scaffold."""
    result, case = out["result"], out["case"]
    assert result.n_closed_gaps == 2
    assert sorted(h.split("\t")[0] for h, _ in result.records) == ["chr1", "chr2"]
    seqs = [seq_to_codes(s.lower()) for _, s in result.records]
    stats = check_results(case.truths, case.structure, case.contigs, seqs)
    assert stats.num_closed == 2 and stats.num_correct(0.99) == 2
    kind, _, coord = result.translate_coord("chr2", 50)
    assert kind == "contig" and coord == 50


def _validation_kept(out):
    assert out["result"].n_closed_gaps == 1


def _validation_purged(out):
    """Closed without validation; validated against unrelated reads, the
    gap is purged."""
    assert out["result"].n_closed_gaps == 1
    assert out["skip"] == {(1, 2)}


_PROPERTIES = {"repeat_edge": _repeat_edge, "bubbles": _bubbles,
               "overlap_crop": _overlap_crop, "two_chromosomes": _two_chromosomes,
               "validation_kept": _validation_kept,
               "validation_purged": _validation_purged}


def test_every_gap_scenario_has_a_counterpart():
    assert list(_PROPERTIES) == [k for k in S.SUITE if not k.startswith("consensus_")]


@pytest.mark.parametrize("key", list(_PROPERTIES))
def test_gap_case_equals_jax(key, reference):
    got = S.run_suite(key, S.port_modules())
    assert S.suite_digests(key, got) == reference[key]["digests"]
    _PROPERTIES[key](got)
    if key == "overlap_crop":  # the JAX package's run, live
        from dentist_tpu import pipeline

        want = S.run_suite(key, SimpleNamespace(pipeline=pipeline))
        for f in ("records", "agp_rows", "bed_rows", "n_closed_gaps"):
            assert getattr(got["result"], f) == getattr(want["result"], f), f
        assert S.suite_digests(key, want) == reference[key]["digests"]
