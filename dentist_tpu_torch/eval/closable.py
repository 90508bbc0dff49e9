"""find-closable-gaps: ground-truth upper bound on closable gaps.

Reference counterpart: ``source/dentist/commands/findClosableGaps.d`` —
given the *true* read placements (the simulator records them in read
headers), a gap is closable iff at least ``min_spanning_reads`` reads
truly span it with a minimum anchor on both flanks.
"""

from __future__ import annotations

import re

from ..io.fasta import FastaRecord
from ..models.sequences import ScaffoldStructure

__all__ = ["find_closable_gaps", "parse_true_placement"]

_HEADER_RE = re.compile(
    r"scaffold=(\d+)\s+begin=(\d+)\s+end=(\d+)\s+strand=([+-])"
)


def parse_true_placement(header: str):
    """Read header → (scaffold_id, begin, end, complement) or None."""
    m = _HEADER_RE.search(header)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4) == "-"


def find_closable_gaps(
    structure: ScaffoldStructure,
    reads: list[FastaRecord],
    min_spanning_reads: int = 3,
    min_anchor: int = 500,
) -> list[dict]:
    placements = []
    for i, r in enumerate(reads):
        p = parse_true_placement(r.header)
        if p:
            placements.append((i + 1, *p))
    out = []
    for gap in structure.gaps:
        lo = gap.begin - min_anchor
        hi = gap.end + min_anchor
        spanning = [
            rid for rid, sid, b, e, _ in placements
            if sid == gap.scaffold_id and b <= lo and e >= hi
        ]
        out.append({
            "beginContigId": gap.begin_global_contig_id,
            "endContigId": gap.end_global_contig_id,
            "scaffoldId": gap.scaffold_id,
            "begin": gap.begin,
            "end": gap.end,
            "isClosable": len(spanning) >= min_spanning_reads,
            "numSpanningReads": len(spanning),
            "spanningReads": spanning,
        })
    return out
