"""check-results: score a gap-closed assembly against the true assembly.

Re-expression of ``source/dentist/commands/checkResults.d``:

- input contigs are located *exactly* in the true assembly on either
  strand (the reference uses a C++ FM-index and searches both
  orientations, ``checkResults.d:513,2100-2135``; here the native
  suffix-array locate),
- duplicate test contigs (exact copies of another test contig,
  ``findPerfectAlignments(refDb)`` → ``duplicateContigIds``,
  ``checkResults.d:401-415``) are detected and their adjacent gaps
  are ``ignored`` in the statistics,
- each input gap is classified
  ``unknown/broken/unclosed/partiallyClosed/closed/ignored``
  (``checkResults.d:239-253``),
- closed gaps get a per-gap sequence identity from an edit-distance
  alignment of the inserted sequence against the true gap content (the
  reference shells out to EMBOSS ``stretcher``, ``checkResults.d:2059``),
- summary statistics mirror the reference ``Stats`` field-for-field
  (``checkResults.d:1744-1830``): bps expected/known/result/in-gaps,
  translocated-gap count, correct gaps at identity levels
  [1.0, .999, .99, .95, .90, .70], maximum/input/result N50 (all
  relative to ``numBpsExpected``, ``checkResults.d:1479-1509``),
  gap medians and extrema, and bucketed gap-length histograms
  (``checkResults.d:1547-1580,1872-1890``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from ..io.fasta import CODE_N
from ..models.sequences import ScaffoldStructure, SeqStore

__all__ = ["GapState", "GapResult", "ResultStats", "check_results"]

IDENTITY_LEVELS = (1.0, 0.999, 0.99, 0.95, 0.90, 0.70)

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


class GapState(Enum):
    UNKNOWN = "unknown"
    BROKEN = "broken"
    UNCLOSED = "unclosed"
    PARTIALLY_CLOSED = "partiallyClosed"
    CLOSED = "closed"
    #: adjacent to a duplicate contig — excluded from the statistics
    #: (``checkResults.d``: ``GapState.ignored``)
    IGNORED = "ignored"


@dataclass
class GapResult:
    begin_contig: int
    end_contig: int
    state: GapState
    identity: float = 0.0
    true_length: int = 0
    filled_length: int = 0


@dataclass
class ResultStats:
    """Mirror of the reference ``Stats`` (``checkResults.d:1744-1775``)."""

    gaps: list[GapResult]
    num_bps_expected: int = 0
    num_bps_known: int = 0
    num_bps_result: int = 0
    num_translocated_gaps: int = 0
    num_contigs_expected: int = 0
    num_mapped_contigs: int = 0
    maximum_n50: int = 0
    n50_input: int = 0
    n50_result: int = 0
    average_insertion_error: float = 0.0
    bucket_size: int = 500

    def _counted(self) -> list[GapResult]:
        return [g for g in self.gaps if g.state != GapState.IGNORED]

    @property
    def num_closed(self) -> int:
        return sum(1 for g in self._counted() if g.state == GapState.CLOSED)

    @property
    def num_partially_closed(self) -> int:
        return sum(1 for g in self._counted()
                   if g.state == GapState.PARTIALLY_CLOSED)

    @property
    def num_bps_in_gaps(self) -> int:
        return sum(g.true_length for g in self._counted())

    def num_correct(self, identity: float) -> int:
        return sum(
            1 for g in self._counted()
            if g.state == GapState.CLOSED and g.identity >= identity
        )

    def _gap_lengths(self, state: GapState | None = None,
                     min_identity: float | None = None) -> list[int]:
        out = []
        for g in self._counted():
            if state is not None and g.state != state:
                continue
            if min_identity is not None and g.identity < min_identity:
                continue
            out.append(g.true_length)
        return out

    def _histogram(self, lengths: list[int]) -> list[int]:
        if not lengths or self.bucket_size <= 0:
            return []
        n_buckets = max(l for l in lengths) // self.bucket_size + 1
        counts = [0] * n_buckets
        for l in lengths:
            counts[l // self.bucket_size] += 1
        return counts

    def _hists_json(self) -> list[dict]:
        """Reference ``histsToJson`` rows (``checkResults.d:1872-1890``):
        one row per bucket with the counts of [correct@1.0, @.999, @.99,
        @.95, closed, all] gap-length histograms."""
        hists = [
            self._histogram(self._gap_lengths(GapState.CLOSED, lvl))
            for lvl in IDENTITY_LEVELS[:4]
        ] + [
            self._histogram(self._gap_lengths(GapState.CLOSED)),
            self._histogram(self._gap_lengths()),
        ]
        n = max((len(h) for h in hists), default=0)
        return [
            {"limit": (i + 1) * self.bucket_size,
             "counts": [h[i] if i < len(h) else 0 for h in hists]}
            for i in range(n)
        ]

    @staticmethod
    def _median(vals: list[int]):
        return int(np.median(vals)) if vals else None

    def to_json(self) -> dict:
        closed = self._gap_lengths(GapState.CLOSED)
        return {
            "numBpsExpected": self.num_bps_expected,
            "numBpsKnown": self.num_bps_known,
            "numBpsResult": self.num_bps_result,
            "numBpsInGaps": self.num_bps_in_gaps,
            "averageInsertionError": self.average_insertion_error,
            "numTranslocatedGaps": self.num_translocated_gaps,
            "numCorrectGaps": self.num_correct(1.0),
            "numCorrectGapsPerIdentityLevel": {
                str(l): self.num_correct(l) for l in IDENTITY_LEVELS},
            "numContigsExpected": self.num_contigs_expected,
            "numMappedContigs": self.num_mapped_contigs,
            "numGaps": len(self._counted()),
            "numClosedGaps": self.num_closed,
            "numPartiallyClosedGaps": self.num_partially_closed,
            "maximumN50": self.maximum_n50,
            "inputN50": self.n50_input,
            "resultN50": self.n50_result,
            "gapMedian": self._median(self._gap_lengths()),
            "closedGapMedian": self._median(closed),
            "minClosedGap": min(closed) if closed else None,
            "maxClosedGap": max(closed) if closed else None,
            "gapLengthHistogram": self._hists_json(),
            "gapStates": {s.value: sum(1 for g in self.gaps if g.state == s)
                          for s in GapState},
        }


def _edit_distance_banded(a: np.ndarray, b: np.ndarray, band: int = 64) -> int:
    """Banded edit distance (host, small sequences)."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return max(n, m)
    band = max(band, abs(n - m) + 2)
    INF = 1 << 30
    prev = np.full(m + 1, INF, dtype=np.int64)
    lo_p, hi_p = 0, min(m, band) + 1
    prev[lo_p:hi_p] = np.arange(lo_p, hi_p)
    for i in range(1, n + 1):
        center = i * m // n
        lo = max(0, center - band)
        hi = min(m, center + band)
        cur = np.full(m + 1, INF, dtype=np.int64)
        seg = b[lo:hi] != a[i - 1] if hi > lo else np.empty(0, dtype=bool)
        diag = np.where(prev[lo:hi] < INF, prev[lo:hi] + seg, INF)
        up = np.where(prev[lo + 1 : hi + 1] < INF, prev[lo + 1 : hi + 1] + 1, INF)
        tmp = np.minimum(diag, up)
        run = INF
        vals = np.empty(hi - lo + 1, dtype=np.int64)
        vals[0] = i if lo == 0 else INF
        for j in range(lo + 1, hi + 1):
            run = min(tmp[j - 1 - lo], vals[j - 1 - lo] + 1)
            vals[j - lo] = run
        cur[lo : hi + 1] = vals
        prev = cur
    return int(prev[m])


def _n50(lengths: list[int], total: int) -> int:
    """N50 relative to ``total`` (the reference computes every N50
    against ``numBpsExpected``, ``checkResults.d:1479-1509``)."""
    if not lengths or total <= 0:
        return 0
    arr = np.sort(np.asarray(lengths))[::-1]
    csum = np.cumsum(arr)
    idx = int(np.searchsorted(csum, total / 2))
    if idx >= len(arr):
        return 0
    return int(arr[idx])


def check_results(
    true_records: list[np.ndarray],
    test_structure: ScaffoldStructure,
    test_contigs: SeqStore,
    result_records: list[np.ndarray],
    bucket_size: int = 500,
) -> ResultStats:
    """Score `result_records` (gap-closed, coded incl. N) against the truth."""
    from ..native import SuffixArrayIndex

    true_idx = [SuffixArrayIndex(t) for t in true_records]
    res_idx = [SuffixArrayIndex(r) for r in result_records]

    # duplicate test contigs: perfect SELF-alignments of the input
    # assembly — a contig found exactly (either strand) inside a
    # DIFFERENT contig is a duplicate and excluded from gap analysis.
    # This also catches *contained* copies, matching the reference's
    # fm-index self-search with refId != queryId
    # (``checkResults.d:401-415,545`` — not just equal-content pairs).
    cids = [c.global_contig_id for c in test_structure.contigs]
    seqs = [test_contigs.get(cid) for cid in cids]
    sep = np.full(1, 4, dtype=np.uint8)
    joined = np.concatenate(
        [p for s in seqs for p in (s, sep)])[:-1] if seqs else sep[:0]
    starts = np.cumsum([0] + [len(s) + 1 for s in seqs[:-1]])
    ends = starts + np.array([len(s) for s in seqs], dtype=np.int64)
    self_idx = SuffixArrayIndex(joined)
    duplicates: set[int] = set()
    for k, (cid, seq) in enumerate(zip(cids, seqs)):
        for pat in (seq, _COMP[seq][::-1]):
            hits = self_idx.locate(pat, max_out=4)
            owner = np.searchsorted(starts, hits, side="right") - 1
            inside = hits + len(pat) <= ends[owner]
            # hits within the contig itself are not duplicates
            # (reference: ``findResult.refId != findResult.queryId``)
            if np.any(inside & (owner != k)):
                duplicates.add(cid)
                break

    # locate each input contig in the truth, both strands (tells us the
    # true gap content; checkResults.d locates via FM-index both ways)
    contig_loc: dict[int, tuple[int, int, bool]] = {}  # id -> (rec, pos, fwd)
    for c in test_structure.contigs:
        seq = test_contigs.get(c.global_contig_id)
        rc = _COMP[seq][::-1]
        for ti, idx in enumerate(true_idx):
            hits = idx.locate(seq, max_out=1)
            if len(hits):
                contig_loc[c.global_contig_id] = (ti, int(hits[0]), True)
                break
            hits = idx.locate(rc, max_out=1)
            if len(hits):
                contig_loc[c.global_contig_id] = (ti, int(hits[0]), False)
                break

    # locate contigs in the result (either strand); count hits for the
    # unique-mapping statistic
    res_loc: dict[int, tuple[int, int, bool]] = {}  # id -> (record, pos, fwd)
    res_hits: dict[int, int] = {}
    for c in test_structure.contigs:
        seq = test_contigs.get(c.global_contig_id)
        rc = _COMP[seq][::-1]
        n_hits = 0
        for ri, idx in enumerate(res_idx):
            hits = idx.locate(seq, max_out=2)
            if len(hits) and c.global_contig_id not in res_loc:
                res_loc[c.global_contig_id] = (ri, int(hits[0]), True)
            n_hits += len(hits)
            hits = idx.locate(rc, max_out=2)
            if len(hits) and c.global_contig_id not in res_loc:
                res_loc[c.global_contig_id] = (ri, int(hits[0]), False)
            n_hits += len(hits)
        res_hits[c.global_contig_id] = n_hits

    # mapped regions of the truth (mappedRegionsMask): union of located
    # contig intervals per true record
    from ..utils.regions import Region
    mapped_triples = []
    for c in test_structure.contigs:
        loc = contig_loc.get(c.global_contig_id)
        if loc is None:
            continue
        ti, tp, _ = loc
        l = len(test_contigs.get(c.global_contig_id))
        mapped_triples.append((ti + 1, tp, tp + l))
    mapped = Region.from_triples(mapped_triples) if mapped_triples else Region()

    # translocated (reference) gaps: inner unmapped regions of the truth
    n_translocated = 0
    for ti, t in enumerate(true_records):
        spans = mapped.for_tag(ti + 1)
        if len(spans) >= 2:
            n_translocated += len(spans) - 1

    gaps: list[GapResult] = []
    err_sum = 0.0
    err_weight = 0
    for gap in test_structure.gaps:
        c1, c2 = gap.begin_global_contig_id, gap.end_global_contig_id
        g = GapResult(c1, c2, GapState.UNKNOWN, true_length=gap.length)
        if c1 in duplicates or c2 in duplicates:
            g.state = GapState.IGNORED
            gaps.append(g)
            continue
        # true gap length when both flanks are located in the truth
        t1, t2 = contig_loc.get(c1), contig_loc.get(c2)
        if t1 and t2 and t1[0] == t2[0] and t1[2] == t2[2]:
            l1 = len(test_contigs.get(c1))
            l2 = len(test_contigs.get(c2))
            if t1[2]:
                true_gap = t2[1] - (t1[1] + l1)
            else:
                true_gap = t1[1] - (t2[1] + l2)
            if true_gap >= 0:
                g.true_length = true_gap
        if c1 not in res_loc or c2 not in res_loc:
            g.state = GapState.BROKEN
            gaps.append(g)
            continue
        r1, p1, f1 = res_loc[c1]
        r2, p2, f2 = res_loc[c2]
        if r1 != r2 or f1 != f2:
            g.state = GapState.BROKEN
            gaps.append(g)
            continue
        l1 = len(test_contigs.get(c1))
        l2 = len(test_contigs.get(c2))
        if f1:
            lo, hi = p1 + l1, p2
        else:
            lo, hi = p2 + l2, p1
        if hi < lo:
            g.state = GapState.BROKEN
            gaps.append(g)
            continue
        filled = result_records[r1][lo:hi]
        if not f1:
            filled = _COMP[filled][::-1]
        g.filled_length = len(filled)
        n_count = int((filled == CODE_N).sum())
        if n_count == len(filled) and len(filled) > 0:
            g.state = GapState.UNCLOSED
        elif n_count > 0:
            g.state = GapState.PARTIALLY_CLOSED
        else:
            g.state = GapState.CLOSED
            if t1 and t2 and t1[0] == t2[0] and t1[2] == t2[2]:
                ti = t1[0]
                if t1[2]:
                    tlo, thi = t1[1] + l1, t2[1]
                else:
                    tlo, thi = t2[1] + l2, t1[1]
                if thi >= tlo:
                    true_fill = true_records[ti][tlo:thi]
                    if not t1[2]:
                        true_fill = _COMP[true_fill][::-1]
                    d = _edit_distance_banded(true_fill, filled)
                    denom = max(len(true_fill), len(filled), 1)
                    g.identity = 1.0 - d / denom
                    w = max(g.true_length, 1)
                    err_sum += (d / denom) * w
                    err_weight += w
        gaps.append(g)

    num_bps_expected = sum(len(t) for t in true_records)
    result_contig_lengths = _contig_lengths(result_records)
    return ResultStats(
        gaps=gaps,
        num_bps_expected=num_bps_expected,
        num_bps_known=mapped.size,
        num_bps_result=sum(result_contig_lengths),
        num_translocated_gaps=n_translocated,
        num_contigs_expected=len(mapped),
        num_mapped_contigs=sum(
            1 for c in test_structure.contigs
            if c.global_contig_id not in duplicates
            and res_hits.get(c.global_contig_id, 0) == 1),
        maximum_n50=_n50([len(t) for t in true_records], num_bps_expected),
        n50_input=_n50([int(e - b) for _, b, e in mapped.iv.tolist()],
                       num_bps_expected),
        n50_result=_n50(result_contig_lengths, num_bps_expected),
        average_insertion_error=(err_sum / err_weight) if err_weight else 0.0,
        bucket_size=bucket_size,
    )


def _contig_lengths(records: list[np.ndarray]) -> list[int]:
    """Contig (non-N run) lengths of scaffold records."""
    out = []
    for r in records:
        is_n = np.r_[True, r == CODE_N, True]
        edges = np.flatnonzero(np.diff(is_n.astype(np.int8)))
        for b, e in zip(edges[::2], edges[1::2]):
            out.append(int(e - b))
    return out
