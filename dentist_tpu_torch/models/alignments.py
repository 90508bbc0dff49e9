"""Local-alignment data model: trace-point encoded alignments + chains.

Re-expresses the reference alignment model
(``source/dentist/common/alignments/base.d``):

- ``FlatLocalAlignment`` records (``base.d:1645``) become one
  struct-of-arrays :class:`LocalAlignmentSet` — contig/read ids, begin/end
  coordinates on A and B, complement flag, diff count, and the
  trace-point arrays (``TracePoint{numDiffs, numBasePairs}``,
  ``base.d:148``) stored ragged via offsets.
- Trace spacing is the constant 126 the reference forces wherever it
  reads traces (``forceLargeTracePointType = 126``,
  ``source/dentist/dazzler.d:154``).
- Coordinate translation via trace points without DP mirrors
  ``Trace.translateTracePoint`` (``base.d:185-242``).
- B coordinates of complement alignments live on the reverse-complemented
  B strand (Dazzler ``.las`` convention).

Trace layout per alignment: the first interval spans ``a_begin`` to the
next multiple of 126 (or ``a_end`` if closer), interior intervals are full
126-bp A segments aligned to trace boundaries, and the final interval ends
at ``a_end``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["TRACE_SPACING", "LocalAlignmentSet", "concat_alignments"]

TRACE_SPACING = 126


def _trace_boundaries(a_begin: int, a_end: int) -> np.ndarray:
    """A coordinates of trace interval boundaries: a_begin, 126-multiples, a_end."""
    first = (a_begin // TRACE_SPACING + 1) * TRACE_SPACING
    mids = np.arange(first, a_end, TRACE_SPACING, dtype=np.int64)
    return np.concatenate([[a_begin], mids, [a_end]])


@dataclass
class LocalAlignmentSet:
    """Struct-of-arrays set of flat local alignments with trace points."""

    a_id: np.ndarray  # int32, 1-based
    b_id: np.ndarray  # int32, 1-based
    complement: np.ndarray  # bool
    a_begin: np.ndarray  # int32
    a_end: np.ndarray
    b_begin: np.ndarray  # on aligned strand of B
    b_end: np.ndarray
    diffs: np.ndarray  # int32 total
    trace_offsets: np.ndarray  # int64, len n+1
    trace_diffs: np.ndarray  # int32 concat
    trace_b_adv: np.ndarray  # int32 concat
    #: optional chain assignment: -1 = unchained
    chain_id: np.ndarray = field(default=None)
    #: per-alignment flags
    disabled: np.ndarray = field(default=None)

    def __post_init__(self):
        n = len(self.a_id)
        if self.chain_id is None:
            self.chain_id = np.full(n, -1, dtype=np.int64)
        if self.disabled is None:
            self.disabled = np.zeros(n, dtype=bool)

    def __len__(self) -> int:
        return len(self.a_id)

    @classmethod
    def empty(cls) -> "LocalAlignmentSet":
        z = np.empty(0, dtype=np.int32)
        return cls(
            a_id=z.copy(), b_id=z.copy(), complement=np.empty(0, dtype=bool),
            a_begin=z.copy(), a_end=z.copy(), b_begin=z.copy(), b_end=z.copy(),
            diffs=z.copy(), trace_offsets=np.zeros(1, dtype=np.int64),
            trace_diffs=z.copy(), trace_b_adv=z.copy(),
        )

    # -- per-alignment views ------------------------------------------
    def trace(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(num_diffs, b_adv) trace arrays of alignment i."""
        lo, hi = self.trace_offsets[i], self.trace_offsets[i + 1]
        return self.trace_diffs[lo:hi], self.trace_b_adv[lo:hi]

    def a_length(self, i: int) -> int:
        return int(self.a_end[i] - self.a_begin[i])

    def b_length(self, i: int) -> int:
        return int(self.b_end[i] - self.b_begin[i])

    def error_rate(self, i: int) -> float:
        denom = self.a_length(i) + self.b_length(i)
        return 2.0 * float(self.diffs[i]) / denom if denom else 0.0

    def select(self, mask_or_idx) -> "LocalAlignmentSet":
        """Subset of alignments (boolean mask or index array), traces included."""
        idx = np.flatnonzero(mask_or_idx) if np.asarray(mask_or_idx).dtype == bool else np.asarray(mask_or_idx)
        counts = (self.trace_offsets[1:] - self.trace_offsets[:-1])[idx]
        new_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        td = np.empty(int(counts.sum()), dtype=np.int32)
        tb = np.empty_like(td)
        for k, i in enumerate(idx):
            lo, hi = self.trace_offsets[i], self.trace_offsets[i + 1]
            td[new_offsets[k] : new_offsets[k + 1]] = self.trace_diffs[lo:hi]
            tb[new_offsets[k] : new_offsets[k + 1]] = self.trace_b_adv[lo:hi]
        return LocalAlignmentSet(
            a_id=self.a_id[idx], b_id=self.b_id[idx], complement=self.complement[idx],
            a_begin=self.a_begin[idx], a_end=self.a_end[idx],
            b_begin=self.b_begin[idx], b_end=self.b_end[idx],
            diffs=self.diffs[idx], trace_offsets=new_offsets,
            trace_diffs=td, trace_b_adv=tb,
            chain_id=self.chain_id[idx], disabled=self.disabled[idx],
        )

    # -- coordinate translation ---------------------------------------
    def translate_a_to_b(self, i: int, a: int, round_up: bool = False) -> tuple[int, int]:
        """Translate A coordinate `a` to the nearest trace boundary's B coord.

        Returns ``(a_at_boundary, b_at_boundary)`` for the last boundary
        ≤ `a` (or first ≥ `a` if `round_up`).  Mirrors
        ``Trace.translateTracePoint`` (``base.d:185-242``).
        """
        a_beg, a_end = int(self.a_begin[i]), int(self.a_end[i])
        assert a_beg <= a <= a_end, (a_beg, a, a_end)
        bounds = _trace_boundaries(a_beg, a_end)
        _, b_adv = self.trace(i)
        b_cum = np.concatenate([[0], np.cumsum(b_adv)])
        if round_up:
            k = int(np.searchsorted(bounds, a, side="left"))
        else:
            k = int(np.searchsorted(bounds, a, side="right")) - 1
        k = min(max(k, 0), len(bounds) - 1)
        return int(bounds[k]), int(self.b_begin[i]) + int(b_cum[k])

    def boundaries_and_b(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """All trace boundaries and cumulative B coordinates of alignment i."""
        bounds = _trace_boundaries(int(self.a_begin[i]), int(self.a_end[i]))
        _, b_adv = self.trace(i)
        b = int(self.b_begin[i]) + np.concatenate([[0], np.cumsum(b_adv)])
        return bounds, b

    def exact_alignment(self, i: int, a_codes: np.ndarray, b_codes: np.ndarray,
                        a_interval: tuple[int, int] | None = None):
        """Reconstruct the exact base-level alignment of alignment `i`.

        Trace points bound the path to one 126-bp interval at a time, so
        the exact alignment is recovered with tiny banded NW problems per
        interval — the reference's ``getExactAlignment``
        (``dazzler.d:2185-2249``) built on ``findAlignment``
        (``util/string.d:478``).  `a_codes`/`b_codes` are the full A/B
        sequences (B on the aligned strand); `a_interval` restricts to a
        sub-range (snapped outward to trace boundaries).

        Returns (a_begin, b_begin, edit_ops) where edit_ops is a list of
        ("match"|"sub"|"ins"|"del", a_pos, b_pos) tuples; "ins" consumes
        B only, "del" consumes A only.
        """
        bounds, b_at = self.boundaries_and_b(i)
        if a_interval is not None:
            lo_k = int(np.searchsorted(bounds, a_interval[0], side="right")) - 1
            hi_k = int(np.searchsorted(bounds, a_interval[1], side="left"))
            lo_k = max(lo_k, 0)
            hi_k = min(max(hi_k, lo_k + 1), len(bounds) - 1)
        else:
            lo_k, hi_k = 0, len(bounds) - 1
        ops: list[tuple[str, int, int]] = []
        for k in range(lo_k, hi_k):
            a0, a1 = int(bounds[k]), int(bounds[k + 1])
            b0, b1 = int(b_at[k]), int(b_at[k + 1])
            ops.extend(_nw_ops(a_codes[a0:a1], b_codes[b0:b1], a0, b0))
        return int(bounds[lo_k]), int(b_at[lo_k]), ops

    def check_invariants(self) -> None:
        """Assert trace/coordinate consistency (reference ``invariant``
        blocks, ``base.d:434-457``): interval count matches the 126-bp
        boundary grid and b advances sum to the B span.

        Fully vectorized (one pass over the record set) so the pipeline
        can afford to run it at every stage boundary — the reference
        keeps its contracts on in production builds (``dub.sdl:26-28``,
        CHANGELOG 3.0.0 "keep assertions in production code")."""
        n = len(self)
        if n == 0:
            return
        ab = self.a_begin.astype(np.int64)
        ae = self.a_end.astype(np.int64)
        first = (ab // TRACE_SPACING + 1) * TRACE_SPACING
        n_mids = np.maximum(0, (ae - first + TRACE_SPACING - 1) // TRACE_SPACING)
        counts = np.diff(self.trace_offsets)
        bad = np.flatnonzero(counts != n_mids + 1)
        assert len(bad) == 0, (int(bad[0]), int(counts[bad[0]]),
                               int(n_mids[bad[0]] + 1))
        offs = self.trace_offsets[:-1]
        tb_sum = np.add.reduceat(self.trace_b_adv.astype(np.int64), offs)
        td_sum = np.add.reduceat(self.trace_diffs.astype(np.int64), offs)
        b_len = (self.b_end - self.b_begin).astype(np.int64)
        bad = np.flatnonzero(tb_sum != b_len)
        assert len(bad) == 0, (int(bad[0]), int(tb_sum[bad[0]]),
                               int(b_len[bad[0]]))
        bad = np.flatnonzero(td_sum != self.diffs)
        assert len(bad) == 0, (int(bad[0]), int(td_sum[bad[0]]),
                               int(self.diffs[bad[0]]))
        assert (self.trace_b_adv >= 0).all() and (self.trace_diffs >= 0).all()

    def sort(self) -> "LocalAlignmentSet":
        """Canonical total order: (a_id, b_id, complement, a_begin, b_begin).

        Determinism anchor — the reference "sorts by IDs everywhere"
        (SURVEY §7 hard part 5).
        """
        order = np.lexsort(
            (self.b_begin, self.a_begin, self.complement, self.b_id, self.a_id)
        )
        return self.select(order)


def concat_alignments(sets: list[LocalAlignmentSet]) -> LocalAlignmentSet:
    sets = [s for s in sets if len(s)]
    if not sets:
        return LocalAlignmentSet.empty()
    return LocalAlignmentSet(
        a_id=np.concatenate([s.a_id for s in sets]),
        b_id=np.concatenate([s.b_id for s in sets]),
        complement=np.concatenate([s.complement for s in sets]),
        a_begin=np.concatenate([s.a_begin for s in sets]),
        a_end=np.concatenate([s.a_end for s in sets]),
        b_begin=np.concatenate([s.b_begin for s in sets]),
        b_end=np.concatenate([s.b_end for s in sets]),
        diffs=np.concatenate([s.diffs for s in sets]),
        trace_offsets=_concat_offsets([s.trace_offsets for s in sets]),
        trace_diffs=np.concatenate([s.trace_diffs for s in sets]),
        trace_b_adv=np.concatenate([s.trace_b_adv for s in sets]),
        chain_id=np.concatenate([s.chain_id for s in sets]),
        disabled=np.concatenate([s.disabled for s in sets]),
    )


def _nw_ops(a: np.ndarray, b: np.ndarray, a_off: int, b_off: int):
    """Global NW with unit costs; returns edit ops (small inputs only).

    The per-interval workhorse of :meth:`LocalAlignmentSet.exact_alignment`
    (reference ``findAlignment``, memory-capped — intervals here are ≤126bp
    so the full DP matrix is tiny).
    """
    n, m = len(a), len(b)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for ii in range(1, n + 1):
        sub = D[ii - 1, :-1] + (b != a[ii - 1])
        up = D[ii - 1, 1:] + 1
        tmp = np.minimum(sub, up)
        run = D[ii, 0] = ii
        for jj in range(1, m + 1):
            run = min(tmp[jj - 1], run + 1)
            D[ii, jj] = run
    ops = []
    ii, jj = n, m
    while ii > 0 or jj > 0:
        if ii > 0 and jj > 0 and D[ii, jj] == D[ii - 1, jj - 1] + (a[ii - 1] != b[jj - 1]):
            ops.append(("match" if a[ii - 1] == b[jj - 1] else "sub",
                        a_off + ii - 1, b_off + jj - 1))
            ii -= 1
            jj -= 1
        elif ii > 0 and D[ii, jj] == D[ii - 1, jj] + 1:
            ops.append(("del", a_off + ii - 1, b_off + jj))
            ii -= 1
        else:
            ops.append(("ins", a_off + ii, b_off + jj - 1))
            jj -= 1
    ops.reverse()
    return ops


def _concat_offsets(offset_arrays: list[np.ndarray]) -> np.ndarray:
    out = [np.zeros(1, dtype=np.int64)]
    base = 0
    for off in offset_arrays:
        out.append(off[1:] + base)
        base += off[-1]
    return np.concatenate(out)
