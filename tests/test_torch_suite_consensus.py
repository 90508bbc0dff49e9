"""The JAX package's consensus tests, on the port.

Counterparts of ``tests/test_consensus.py:57,64,71,94,103`` (consensus
converges to the truth: clean reads, 13 % error, low and moderate
coverage, several seeds), ``:80`` (``tie_policy``), ``:121,141,147``
(variable read ends, a single read, ``win_diffs`` track read quality),
``:157`` (``consensus_batch`` equals ``consensus`` one by one),
``:176,190`` (``rank_reference_reads``; a junk template recovers by a
QV-ranked retry) and ``:248`` (an all-dirty incremental realign equals
the full windowed round).  Each case is a scenario of
``dentist_tpu_torch.scenarios.SUITE``: the JAX test's read sets, drawn
with its seeds and sizes from the port's copy of ``sim/``, run through
both packages' ``ops/consensus`` as the test calls it
(``scenarios.run_suite``; the port on the CPU, its kernels' plain
versions, ``DENTIST_TPU_FORCE_SINGLE=1``).  The port's digests of every
result's ``sequence``, ``read_diffs``, ``read_spans``, ``win_diffs`` and
``coverage`` (a realign round's ``sym``, ``ins``, ``jpath``, ``win`` and
``diffs``) and of the ranks and template indices it computed must equal
the JAX package's run of the same scenario that ``chip_smoke.py`` phase
19 holds the card to (``scenarios.SUITE_REFERENCE``), and the JAX
test's own property must hold on the port's result.  Where the JAX
package's run takes a second or two (``_LIVE``) it also runs here, and
each of those fields must equal its live result bit for bit; its other
five cases take 19 s of the CPU (``tie_policy``, several seeds,
moderate coverage, the batch and the junk template), which the budget
of these tests leaves to the recorded run.  The mesh tests
(``:209,230``) are held by ``tests/test_torch_parallel.py``'s groups of
2 and 3 ranks.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
from test_consensus import assert_matches_interior, edit_ops

from dentist_tpu_torch import scenarios as S
from dentist_tpu_torch.device import set_device
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _single_device_cpu(monkeypatch):
    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")


@pytest.fixture(scope="module")
def reference():
    with open(S.SUITE_REFERENCE) as fh:
        return json.load(fh)["scenarios"]


def _jax_modules():
    from dentist_tpu.ops import consensus

    return SimpleNamespace(consensus=consensus)


def _truths(out):
    return [t for t, _ in out["pairs"]]


def _converges(out, key):
    """Interior-exact (``:64``, ``:94``, ``:103``: no edit 3 bp or more
    from either end), equal to the truth (``:57``), or within 10 edits at
    8x (``:71``)."""
    for truth, res in zip(_truths(out), out["results"]):
        if key == "consensus_clean":
            assert np.array_equal(res.sequence, truth)
            assert res.read_diffs.sum() == 0
        elif key == "consensus_low_coverage":
            assert len(edit_ops(truth, res.sequence)) <= 10
        elif key == "consensus_moderate":
            ops = edit_ops(truth, res.sequence)
            assert [p for p in ops if 3 <= p < len(truth) - 3] == []
        else:
            assert_matches_interior(truth, res.sequence)


def _tie_policy(out, key):
    """Default equals the explicit "delete"; "insert" and "none" stay
    within 4 edits of the truth."""
    [truth] = _truths(out)
    default, delete, *others = out["results"]
    assert np.array_equal(default.sequence, delete.sequence)
    for res in others:
        assert len(edit_ops(truth, res.sequence)) <= 4


def _variable_ends(out, key):
    [truth], [res] = _truths(out), out["results"]
    ops = edit_ops(truth, res.sequence)
    assert len([p for p in ops if 3 <= p < 780]) <= 1
    assert abs(len(res.sequence) - 1500) < 20


def _single_read(out, key):
    [truth], [res] = _truths(out), out["results"]
    assert np.array_equal(res.sequence, truth)


def _win_diffs(out, key):
    [res] = out["results"]
    assert 5 < res.win_diffs.mean() < 40
    assert res.coverage.min() >= 14


def _batch(out, key):
    """The batched results equal the one-by-one ones, each within 3
    edits of its truth."""
    truths = _truths(out)
    batched, single = out["results"][:len(truths)], out["results"][len(truths):]
    for truth, b, s in zip(truths, batched, single):
        assert np.array_equal(b.sequence, s.sequence)
        assert np.array_equal(b.read_diffs, s.read_diffs)
        assert len(edit_ops(truth, b.sequence)) <= 3


def _rank(out, key):
    """The much worse read 4 ranks last or next to last."""
    ranked = out["ranked"]
    assert ranked[-1] == 4 or ranked[-2] == 4
    assert 4 not in ranked[:3]


def _junk_template(out, key):
    """The retry from the best-ranked other read is interior-exact."""
    [truth] = _truths(out)
    assert out["next"] != out["med"]
    assert_matches_interior(truth, out["results"][1].sequence)


def _incremental(out, key):
    """The all-dirty incremental round equals the full windowed round."""
    _, full, inc = out["rounds"]
    for f in S.ROUND_FIELDS:
        assert np.array_equal(getattr(full, f), getattr(inc, f)), f


_PROPERTIES = {
    "consensus_clean": _converges, "consensus_13pct": _converges,
    "consensus_low_coverage": _converges, "consensus_tie_policy": _tie_policy,
    "consensus_seeds": _converges, "consensus_moderate": _converges,
    "consensus_variable_ends": _variable_ends,
    "consensus_single_read": _single_read, "consensus_win_diffs": _win_diffs,
    "consensus_batch": _batch, "consensus_rank": _rank,
    "consensus_junk_template": _junk_template,
    "consensus_incremental": _incremental,
}


#: the cases the JAX package also runs here, live
_LIVE = ("consensus_clean", "consensus_13pct", "consensus_low_coverage",
         "consensus_variable_ends", "consensus_single_read",
         "consensus_win_diffs", "consensus_rank", "consensus_incremental")


def test_every_consensus_scenario_has_a_counterpart():
    assert list(_PROPERTIES) == [k for k in S.SUITE if k.startswith("consensus_")]


@pytest.mark.parametrize("key", list(_PROPERTIES))
def test_consensus_case_equals_jax(key, reference):
    got = S.run_suite(key, S.port_modules())
    assert S.suite_digests(key, got) == reference[key]["digests"]
    _PROPERTIES[key](got, key)
    if key not in _LIVE:
        return
    want = S.run_suite(key, _jax_modules())
    if "rounds" in got:
        pairs, fields = zip(got["rounds"], want["rounds"]), S.ROUND_FIELDS
    else:
        pairs, fields = zip(got["results"], want["results"]), S.CONSENSUS_FIELDS
        assert len(got["results"]) == len(want["results"])
    for i, (a, b) in enumerate(pairs):
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{i} {f}")
    for name in ("ranked", "med", "next"):
        if name in want:
            np.testing.assert_array_equal(got[name], want[name])
