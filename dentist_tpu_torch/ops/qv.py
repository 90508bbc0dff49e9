"""Intrinsic quality values + coverage statistics from alignments.

The reference pipeline runs DASqv (intrinsic QV per trace-point window
from the pile of overlapping alignments) and uses DAScover-style
coverage estimates for mask thresholds (SURVEY §2.3 rows DAScover/DASqv;
``source/dentist/dazzler.d`` drives the binaries).  The
same signals here, from the framework's alignment container:

- for every A-read trace window (126 bp), the diffs of each overlapping
  alignment's corresponding trace interval are collected; the window's
  intrinsic QV is the mean diff count of the **best half** of its
  alignments (DASqv's estimator: the worse half is assumed to carry the
  B-reads' errors),
- per-window coverage counts and a global coverage histogram provide the
  DAScover equivalent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.alignments import TRACE_SPACING, LocalAlignmentSet

__all__ = ["IntrinsicQV", "compute_intrinsic_qv"]

#: windows with no alignment get this sentinel (DASqv uses 255)
NO_QV = 255


@dataclass
class IntrinsicQV:
    """Per-read per-126bp-window intrinsic QVs + coverage."""

    offsets: np.ndarray  # (n_reads + 1,) int64 window offsets per read
    qv: np.ndarray  # (total_windows,) uint8: mean diffs of best half
    coverage: np.ndarray  # (total_windows,) int32 alignments per window

    def read_qv(self, read_id: int) -> np.ndarray:
        return self.qv[self.offsets[read_id - 1] : self.offsets[read_id]]

    def read_coverage(self, read_id: int) -> np.ndarray:
        return self.coverage[self.offsets[read_id - 1] : self.offsets[read_id]]

    def to_json(self) -> dict:
        have = self.qv != NO_QV
        qv_hist = np.bincount(self.qv[have], minlength=51)[:51]
        cov_hist = np.bincount(np.minimum(self.coverage, 100))
        return {
            "numReads": len(self.offsets) - 1,
            "numWindows": int(len(self.qv)),
            "numCoveredWindows": int(have.sum()),
            "medianQV": int(np.median(self.qv[have])) if have.any() else None,
            "meanCoverage": round(float(self.coverage.mean()), 2)
            if len(self.coverage) else 0.0,
            "qvHistogram": qv_hist.tolist(),
            "coverageHistogram": cov_hist.tolist(),
        }


def compute_intrinsic_qv(las: LocalAlignmentSet,
                         a_lengths: np.ndarray) -> IntrinsicQV:
    """DASqv over the container: one vectorized pass, no per-read loops.

    ``a_lengths[i]`` is the length of A-read ``i+1``.  Windows are the
    ``ceil(len / 126)`` trace windows of each A read.
    """
    a_lengths = np.asarray(a_lengths, dtype=np.int64)
    n_win = -(-a_lengths // TRACE_SPACING)
    offsets = np.concatenate([[0], np.cumsum(n_win)])
    total = int(offsets[-1])
    coverage = np.zeros(total, dtype=np.int32)
    if len(las) == 0:
        return IntrinsicQV(offsets, np.full(total, NO_QV, np.uint8), coverage)

    # explode alignments into (global window id, diffs) pairs
    n_tr = np.diff(las.trace_offsets)
    a_ids = np.repeat(las.a_id, n_tr)
    first_win = np.repeat(las.a_begin // TRACE_SPACING, n_tr)
    within = np.arange(len(a_ids)) - np.repeat(
        las.trace_offsets[:-1], n_tr)
    g = offsets[a_ids - 1] + first_win + within
    d = las.trace_diffs.astype(np.int64)

    np.add.at(coverage, g, 1)

    # per-window mean of the best half: sort (g, d), then segmented
    # prefix sums pick each window's lowest ceil(cnt/2) entries
    order = np.lexsort((d, g))
    g_s, d_s = g[order], d[order]
    brk = np.ones(len(g_s), dtype=bool)
    brk[1:] = g_s[1:] != g_s[:-1]
    starts = np.flatnonzero(brk)
    ends = np.concatenate([starts[1:], [len(g_s)]])
    cnt = ends - starts
    take = -(-cnt // 2)
    csum = np.concatenate([[0], np.cumsum(d_s)])
    best_sum = csum[starts + take] - csum[starts]
    qv = np.full(total, NO_QV, dtype=np.uint8)
    qv[g_s[starts]] = np.minimum(best_sum // take, NO_QV - 1).astype(np.uint8)
    return IntrinsicQV(offsets, qv, coverage)
