"""Region validation: check closed gaps against a reads re-mapping.

Re-expression of ``dentist validate-regions``
(``source/dentist/commands/validateRegions.d:1-37``): after re-mapping the
reads to the preliminary (gap-closed) assembly, a closed gap is valid iff

(a) every ``weak_coverage_window`` (500 bp) sliding window of the region
    (± one window of context) is covered by ≥ ``min_coverage_reads``
    local alignments, and
(b) the region is spanned end-to-end by ≥ ``min_spanning_reads`` (3)
    proper read chains.

Emits one JSON-able report per region plus the weak-coverage mask
(windows below the coverage floor).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.chain import Chain
from ..utils.log import log_json
from ..utils.regions import Region
from .alignments import TRACE_SPACING, LocalAlignmentSet

__all__ = ["ValidateConfig", "RegionReport", "validate_regions"]


@dataclass
class ValidateConfig:
    weak_coverage_window: int = 500
    min_coverage_reads: int = 0  # derive via validation_min_coverage()
    min_spanning_reads: int = 3
    proper_allowance: int = TRACE_SPACING
    #: context added to both region sides for the window sweep
    #: (``commandline.d:2404-2411``, default 1000)
    region_context: int = 1000


@dataclass
class RegionReport:
    contig_id: int
    begin: int
    end: int
    is_valid: bool
    n_spanning: int
    weak_windows: list[tuple[int, int]]
    #: ids of the two input contigs flanking the formerly open gap
    contig_ids: tuple[int, int] | None = None
    #: ids of the reads whose consensus filled the gap (attached to the
    #: report as in the reference, ``validateRegions.d:376``)
    read_ids: tuple[int, ...] | None = None

    def to_json(self) -> dict:
        return {
            "contigId": self.contig_id,
            "begin": self.begin,
            "end": self.end,
            "isValid": self.is_valid,
            "numSpanningReads": self.n_spanning,
            "weakWindows": self.weak_windows,
            "contigIds": list(self.contig_ids) if self.contig_ids else None,
            "consensusReadIds": (list(self.read_ids)
                                 if self.read_ids else None),
        }


def validate_regions(
    las: LocalAlignmentSet,
    chains: list[Chain],
    regions: Region,
    contig_lengths: np.ndarray,
    read_lengths: np.ndarray,
    cfg: ValidateConfig,
    region_contig_ids: dict[tuple[int, int, int], tuple[int, int]] | None = None,
    region_read_ids: dict[tuple[int, int, int], tuple[int, ...]] | None = None,
) -> tuple[list[RegionReport], Region]:
    """Validate `regions` (tag = preliminary contig id, begin/end).

    Returns (reports, weak-coverage mask).
    """
    # per-chain A intervals and properness
    spans = []
    for ch in chains:
        ab, ae, bb, be = ch.first_last(las)
        a_len = int(contig_lengths[ch.a_id - 1])
        b_len = int(read_lengths[ch.b_id - 1])
        proper = ch.is_proper(las, a_len, b_len, cfg.proper_allowance)
        spans.append((ch.a_id, ab, ae, proper))
    reports: list[RegionReport] = []
    weak_triples = []
    W = cfg.weak_coverage_window
    for tag, begin, end in regions.iv:
        tag, begin, end = int(tag), int(begin), int(end)
        a_len = int(contig_lengths[tag - 1])
        ctx_lo = max(0, begin - cfg.region_context)
        ctx_hi = min(a_len, end + cfg.region_context)
        cover = [(ab, ae) for (aid, ab, ae, _) in spans if aid == tag]
        # (b) the region WITHOUT context spanned by proper reads
        n_span = sum(
            1 for (aid, ab, ae, proper) in spans
            if aid == tag and proper and ab <= begin and ae >= end
        )
        # (a) every 1bp-sliding window of size W inside [ctx_lo, ctx_hi)
        # must be fully SPANNED by ≥ min_coverage_reads alignments
        # (``validateRegions.d:453-501``): an alignment [ab, ae) spans
        # windows starting at x ∈ [ab, ae - W], so the per-start spanning
        # count is a difference array over window starts.
        weak = []
        n_starts = (ctx_hi - ctx_lo) - W + 1
        if n_starts <= 0:
            # region (plus context) shorter than one window: single
            # truncated window over the whole context
            cov = sum(1 for ab, ae in cover if ab <= ctx_lo and ae >= ctx_hi)
            if cov < cfg.min_coverage_reads:
                weak.append((ctx_lo, ctx_hi))
        else:
            diff = np.zeros(n_starts + 1, dtype=np.int64)
            for ab, ae in cover:
                lo = max(ab, ctx_lo) - ctx_lo
                hi = min(ae - W, ctx_hi - W) - ctx_lo
                if hi >= lo and lo < n_starts:
                    diff[lo] += 1
                    diff[min(hi, n_starts - 1) + 1] -= 1
            f = np.cumsum(diff[:-1])
            weak_x = f < cfg.min_coverage_reads
            # merge weak window starts into intervals [run_lo, run_hi + W)
            if weak_x.any():
                brk = np.flatnonzero(np.diff(weak_x.astype(np.int8)))
                edges = np.concatenate([[0], brk + 1, [n_starts]])
                for s, e in zip(edges[:-1], edges[1:]):
                    if weak_x[s]:
                        weak.append((ctx_lo + int(s), ctx_lo + int(e) - 1 + W))
        is_valid = n_span >= cfg.min_spanning_reads and not weak
        cids = None
        if region_contig_ids:
            cids = region_contig_ids.get((tag, begin, end))
        rids = None
        if region_read_ids:
            rids = region_read_ids.get((tag, begin, end))
        reports.append(RegionReport(tag, begin, end, is_valid, n_span, weak,
                                    cids, rids))
        weak_triples.extend((tag, b, e) for b, e in weak)
    weak_mask = Region.from_triples(weak_triples) if weak_triples else Region()
    log_json("info", event="validateRegions", numRegions=len(reports),
             numValid=sum(r.is_valid for r in reports))
    return reports, weak_mask
