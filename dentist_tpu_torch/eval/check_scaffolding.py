"""check-scaffolding: classify joins of a gap-closed assembly.

Re-expression of ``source/dentist/commands/checkScaffolding.d``: every
pair of input contigs that ended up adjacent *on the same result contig*
is a join; each join is classified (``checkScaffolding.d:118-128``):

- ``correct`` — the contigs are adjacent in the true assembly: same
  ground-truth scaffold, same orientation, consecutive in truth order
  (``adjacentInTrueAssembly``, ``checkScaffolding.d:367-385``); a join
  that skips contigs is still correct when every skipped contig is
  mapped inside the result gap, in order
  (``skippedContigsArePresent``, ``checkScaffolding.d:407-459``),
- ``novel`` — both contigs lie at ends of true-assembly scaffolds (a
  new scaffold-level join the truth cannot confirm or deny,
  ``endOfTrueAssemblyScaffold``, ``checkScaffolding.d:461-487``),
- ``broken`` — the join contradicts the true assembly.

Contigs are located exactly (either strand) with the native
suffix-array index; truth order ranks the input contigs along the true
assembly, replacing the reference's damapper contig mapping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from ..models.sequences import ScaffoldStructure, SeqStore

__all__ = ["JoinState", "JoinSummary", "ScaffoldingReport", "check_scaffolding"]

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


class JoinState(Enum):
    CORRECT = "correct"
    NOVEL = "novel"
    BROKEN = "broken"
    #: a flank contig could not be located (no classification possible)
    UNKNOWN = "unknown"


@dataclass
class JoinSummary:
    state: JoinState
    lhs_contig: int  # global test-contig ids
    rhs_contig: int
    skipped_contigs: list[int] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "state": self.state.value,
            "lhsContig": self.lhs_contig,
            "rhsContig": self.rhs_contig,
            "skippedContigs": self.skipped_contigs,
        }


@dataclass
class ScaffoldingReport:
    joins: list[JoinSummary]

    def count(self, state: JoinState) -> int:
        return sum(1 for j in self.joins if j.state == state)

    def to_json(self) -> dict:
        return {
            "numJoins": len(self.joins),
            "numCorrectJoins": self.count(JoinState.CORRECT),
            "numNovelJoins": self.count(JoinState.NOVEL),
            "numBrokenJoins": self.count(JoinState.BROKEN),
            "numUnknownJoins": self.count(JoinState.UNKNOWN),
            "joins": [j.to_json() for j in self.joins],
        }


@dataclass
class _Loc:
    record: int
    pos: int
    forward: bool


def _locate_all(seq_stores, records):
    """Locate every contig in `records` (either strand) exactly."""
    from ..native import SuffixArrayIndex

    idx = [SuffixArrayIndex(r) for r in records]
    out: dict[int, _Loc] = {}
    for cid, seq in seq_stores:
        rc = _COMP[seq][::-1]
        for ri, ix in enumerate(idx):
            hits = ix.locate(seq, max_out=1)
            if len(hits):
                out[cid] = _Loc(ri, int(hits[0]), True)
                break
            hits = ix.locate(rc, max_out=1)
            if len(hits):
                out[cid] = _Loc(ri, int(hits[0]), False)
                break
    return out


def check_scaffolding(
    true_records: list[np.ndarray],
    test_structure: ScaffoldStructure,
    test_contigs: SeqStore,
    result_records: list[np.ndarray],
    allowance: int = 100,
) -> ScaffoldingReport:
    """Classify every join in `result_records` against the truth."""
    contigs = [(c.global_contig_id, test_contigs.get(c.global_contig_id))
               for c in test_structure.contigs]
    truth_loc = _locate_all(contigs, true_records)
    # joins exist only *within* a gapless result contig: split result
    # scaffolds at N runs (the reference walks per result contig,
    # ``onSameResultContig``, checkScaffolding.d:352-355)
    from ..io.fasta import CODE_N
    result_contigs = []
    for r in result_records:
        is_n = np.r_[True, r == CODE_N, True]
        edges = np.flatnonzero(np.diff(is_n.astype(np.int8)))
        for b, e in zip(edges[::2], edges[1::2]):
            result_contigs.append(r[b:e])
    result_loc = _locate_all(contigs, result_contigs)

    # truth order: rank input contigs along the true assembly
    order = sorted(truth_loc, key=lambda cid: (truth_loc[cid].record,
                                               truth_loc[cid].pos))
    rank = {cid: i for i, cid in enumerate(order)}

    def truth_scaffold(cid):
        return truth_loc[cid].record

    def adjacent_in_truth(lhs, rhs, lhs_fwd_in_result, rhs_fwd_in_result):
        """``adjacentInTrueAssembly``: same truth scaffold, same
        orientation, consecutive truth ranks in the orientation's
        direction."""
        tl, tr = truth_loc.get(lhs), truth_loc.get(rhs)
        if tl is None or tr is None or tl.record != tr.record:
            return False
        # orientation of the truth segment as it appears in the result
        lhs_comp = tl.forward != lhs_fwd_in_result
        rhs_comp = tr.forward != rhs_fwd_in_result
        if lhs_comp != rhs_comp:
            return False
        step = -1 if lhs_comp else 1
        return rank[rhs] == rank[lhs] + step

    def ordered_in_truth(lhs, rhs, lhs_fwd, rhs_fwd):
        tl, tr = truth_loc.get(lhs), truth_loc.get(rhs)
        if tl is None or tr is None or tl.record != tr.record:
            return False
        lhs_comp = tl.forward != lhs_fwd
        rhs_comp = tr.forward != rhs_fwd
        if lhs_comp != rhs_comp:
            return False
        return rank[rhs] > rank[lhs] if not lhs_comp else rank[rhs] < rank[lhs]

    def end_of_truth_scaffold(cid):
        r = rank.get(cid)
        if r is None:
            return False
        prev_scaf = truth_scaffold(order[r - 1]) if r > 0 else None
        next_scaf = truth_scaffold(order[r + 1]) if r + 1 < len(order) else None
        this_scaf = truth_scaffold(cid)
        return prev_scaf != this_scaf or this_scaf != next_scaf

    # joins: consecutive located contigs on the same result record
    by_record: dict[int, list[int]] = {}
    for cid, loc in result_loc.items():
        by_record.setdefault(loc.record, []).append(cid)
    joins: list[JoinSummary] = []
    lengths = {cid: len(seq) for cid, seq in contigs}

    for ri, cids in sorted(by_record.items()):
        cids.sort(key=lambda c: result_loc[c].pos)
        for lhs, rhs in zip(cids, cids[1:]):
            ll, rl = result_loc[lhs], result_loc[rhs]
            s = JoinSummary(JoinState.UNKNOWN, lhs, rhs)
            if lhs not in truth_loc or rhs not in truth_loc:
                joins.append(s)
                continue
            if adjacent_in_truth(lhs, rhs, ll.forward, rl.forward):
                s.state = JoinState.CORRECT
            elif ordered_in_truth(lhs, rhs, ll.forward, rl.forward):
                # skipped contigs must appear inside the result gap, in
                # order, each adjacent to its predecessor in the truth
                gap_lo = ll.pos + lengths[lhs] - allowance
                gap_hi = rl.pos + allowance
                lhs_comp = truth_loc[lhs].forward != ll.forward
                step = -1 if lhs_comp else 1
                needed = order[rank[lhs] + step : rank[rhs] : step]
                prev = lhs
                ok = True
                for mid in needed:
                    ml = result_loc.get(mid)
                    if (ml is None or ml.record != ri
                            or not (gap_lo <= ml.pos
                                    and ml.pos + lengths[mid] <= gap_hi)
                            or not adjacent_in_truth(prev, mid, result_loc[prev].forward,
                                                     ml.forward)):
                        ok = False
                        break
                    s.skipped_contigs.append(mid)
                    prev = mid
                if ok and adjacent_in_truth(prev, rhs, result_loc[prev].forward,
                                            rl.forward):
                    s.state = JoinState.CORRECT
                else:
                    s.state = JoinState.BROKEN
            elif end_of_truth_scaffold(lhs) and end_of_truth_scaffold(rhs):
                s.state = JoinState.NOVEL
            else:
                s.state = JoinState.BROKEN
            joins.append(s)

    return ScaffoldingReport(joins)
