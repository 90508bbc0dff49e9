"""Tagged-interval algebra ("Region" algebra).

A :class:`Region` is a normalized set of *tagged, right-open* intervals
``(tag, begin, end)`` supporting full boolean algebra — union, intersection,
difference, symmetric difference and containment — exactly the semantics of
the reference's ``Region!(Number, Tag)`` (``source/dentist/util/region.d:326-1177``),
which DENTIST uses for repeat masks on the assembly (tag = contig id) and
for read intervals (tag = read id).

Implementation is a vectorized NumPy struct-of-arrays: one ``(N, 3)`` int64
array, sorted lexicographically by ``(tag, begin, end)`` with intervals per
tag disjoint and non-adjacent (normalized).  All operations are O(N log N)
array passes — no per-interval Python loops — so masks with millions of
intervals stay cheap on the host while the heavy per-base work happens on
device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Region", "empty_region", "from_intervals"]


def _normalize(iv: np.ndarray) -> np.ndarray:
    """Sort and merge overlapping/adjacent intervals per tag.

    Matches reference normalization: empty intervals dropped, touching
    intervals merged (``region.d`` keeps intervals "naturally ordered and
    non-overlapping").
    """
    if iv.size == 0:
        return iv.reshape(0, 3).astype(np.int64)
    iv = iv[iv[:, 2] > iv[:, 1]]  # drop empty
    if len(iv) == 0:
        return iv.reshape(0, 3).astype(np.int64)
    order = np.lexsort((iv[:, 2], iv[:, 1], iv[:, 0]))
    iv = iv[order]
    # Merge: an interval starts a new group if its tag differs from the
    # previous or its begin exceeds the running max end of the group.
    tag, beg, end = iv[:, 0], iv[:, 1], iv[:, 2]
    # Per-tag running max of `end` via a keyed cummax: tags are sorted
    # ascending, so a carried-over key from a smaller tag decodes to a
    # negative end and never suppresses a group break.  Keys use *dense tag
    # ranks* (not raw tags, which may be huge read ids or negative) so the
    # packed int64 has headroom: ranks < 2^28, coordinates < 2^35 (32 Gb).
    rank = np.unique(tag, return_inverse=True)[1].astype(np.int64)
    OFFSET = np.int64(1) << 35
    assert end.max() < OFFSET and rank[-1] < (np.int64(1) << 27), \
        "interval coordinates/tag count exceed keyed-cummax headroom"
    cummax_key = np.maximum.accumulate(rank * OFFSET + end)
    new_group = np.ones(len(iv), dtype=bool)
    new_group[1:] = (tag[1:] != tag[:-1]) | (beg[1:] > cummax_key[:-1] - rank[1:] * OFFSET)
    group = np.cumsum(new_group) - 1
    n_groups = group[-1] + 1
    out = np.empty((n_groups, 3), dtype=np.int64)
    first = np.flatnonzero(new_group)
    out[:, 0] = tag[first]
    out[:, 1] = beg[first]
    out[:, 2] = np.iinfo(np.int64).min
    np.maximum.at(out[:, 2], group, end)
    return out


class Region:
    """Normalized set of tagged right-open intervals with boolean algebra."""

    __slots__ = ("iv",)

    def __init__(self, intervals: np.ndarray | None = None, *, _normalized: bool = False):
        if intervals is None:
            intervals = np.empty((0, 3), dtype=np.int64)
        iv = np.asarray(intervals, dtype=np.int64).reshape(-1, 3)
        self.iv = iv if _normalized else _normalize(iv)

    # -- constructors -------------------------------------------------
    @classmethod
    def from_triples(cls, triples) -> "Region":
        return cls(np.array(list(triples), dtype=np.int64).reshape(-1, 3))

    @classmethod
    def single(cls, tag: int, begin: int, end: int) -> "Region":
        return cls(np.array([[tag, begin, end]], dtype=np.int64))

    # -- basic properties ---------------------------------------------
    def __len__(self) -> int:
        return len(self.iv)

    @property
    def empty(self) -> bool:
        return len(self.iv) == 0

    @property
    def size(self) -> int:
        """Total covered length (sum of interval sizes)."""
        if self.empty:
            return 0
        return int((self.iv[:, 2] - self.iv[:, 1]).sum())

    def tags(self) -> np.ndarray:
        return np.unique(self.iv[:, 0])

    def for_tag(self, tag: int) -> np.ndarray:
        """(M, 2) begin/end pairs for one tag."""
        sel = self.iv[self.iv[:, 0] == tag]
        return sel[:, 1:3]

    def __eq__(self, other) -> bool:
        return isinstance(other, Region) and np.array_equal(self.iv, other.iv)

    def __repr__(self) -> str:
        return f"Region({len(self.iv)} intervals, size={self.size})"

    # -- algebra ------------------------------------------------------
    def union(self, other: "Region") -> "Region":
        if self.empty:
            return other
        if other.empty:
            return self
        return Region(np.concatenate([self.iv, other.iv]))

    __or__ = union

    def intersection(self, other: "Region") -> "Region":
        """Per-tag interval intersection via merged boundary sweep."""
        if self.empty or other.empty:
            return Region()
        out = _boolean_sweep(self.iv, other.iv, lambda a, b: a & b)
        return Region(out, _normalized=True)

    __and__ = intersection

    def difference(self, other: "Region") -> "Region":
        if self.empty or other.empty:
            return self
        out = _boolean_sweep(self.iv, other.iv, lambda a, b: a & ~b)
        return Region(out, _normalized=True)

    __sub__ = difference

    def symmetric_difference(self, other: "Region") -> "Region":
        if self.empty:
            return other
        if other.empty:
            return self
        out = _boolean_sweep(self.iv, other.iv, lambda a, b: a ^ b)
        return Region(out, _normalized=True)

    __xor__ = symmetric_difference

    def contains(self, other: "Region") -> bool:
        """True iff every point of `other` is covered by `self`."""
        return (other - self).empty

    def contains_point(self, tag: int, point: int) -> bool:
        sel = self.for_tag(tag)
        if len(sel) == 0:
            return False
        idx = np.searchsorted(sel[:, 0], point, side="right") - 1
        return idx >= 0 and point < sel[idx, 1]

    # -- transforms ---------------------------------------------------
    def filter_min_size(self, min_size: int) -> "Region":
        """Drop intervals shorter than `min_size`.

        Reference: ``filter-mask --min-interval-size``
        (``commands/filterMask.d``).
        """
        if self.empty:
            return self
        keep = (self.iv[:, 2] - self.iv[:, 1]) >= min_size
        return Region(self.iv[keep], _normalized=True)

    def close_gaps(self, min_gap: int) -> "Region":
        """Merge same-tag intervals separated by a gap < `min_gap`.

        Reference: ``filter-mask --min-gap-size`` (``commands/filterMask.d``).
        """
        if self.empty or min_gap <= 1:
            return self
        iv = self.iv.copy()
        # Extend each end by (min_gap - 1); normalize merges anything whose
        # true gap is < min_gap; then shrink ends back where not merged.
        # Simpler exact approach: mark gaps to close directly.
        same_tag = iv[1:, 0] == iv[:-1, 0]
        small_gap = (iv[1:, 1] - iv[:-1, 2]) < min_gap
        join = same_tag & small_gap
        # group consecutive joined intervals
        new_group = np.ones(len(iv), dtype=bool)
        new_group[1:] = ~join
        group = np.cumsum(new_group) - 1
        n_groups = group[-1] + 1
        out = np.empty((n_groups, 3), dtype=np.int64)
        first = np.flatnonzero(new_group)
        out[:, 0] = iv[first, 0]
        out[:, 1] = iv[first, 1]
        out[:, 2] = np.full(n_groups, np.iinfo(np.int64).min)
        np.maximum.at(out[:, 2], group, iv[:, 2])
        return Region(out, _normalized=True)

    def expand(self, radius: int, bounds: "Region | None" = None) -> "Region":
        """Dilate every interval by `radius` on both sides, clipped to bounds."""
        if self.empty:
            return self
        iv = self.iv.copy()
        iv[:, 1] = np.maximum(iv[:, 1] - radius, 0)
        iv[:, 2] += radius
        r = Region(iv)
        return r & bounds if bounds is not None else r

    def coverage_of(self, tag: int, begin: int, end: int) -> int:
        """Number of bases of [begin, end) on `tag` covered by this region."""
        clip = self & Region.single(tag, begin, end)
        return clip.size


def _boolean_sweep(a: np.ndarray, b: np.ndarray, op) -> np.ndarray:
    """Generic per-tag boolean combination of two normalized interval sets.

    Builds the merged sorted list of all boundary points per tag, evaluates
    membership of each elementary segment in A and B, applies `op`, and
    emits intervals where the result is true.  Fully vectorized.
    """
    # Event lists: (tag, pos, delta) with delta ±1 for open/close.
    def events(iv, col):
        n = len(iv)
        ev = np.empty((2 * n, 3), dtype=np.int64)
        ev[:n, 0] = iv[:, 0]
        ev[:n, 1] = iv[:, 1]
        ev[:n, 2] = 1
        ev[n:, 0] = iv[:, 0]
        ev[n:, 1] = iv[:, 2]
        ev[n:, 2] = -1
        return ev

    ea, eb = events(a, 0), events(b, 1)
    tags = np.concatenate([ea[:, 0], eb[:, 0]])
    pos = np.concatenate([ea[:, 1], eb[:, 1]])
    da = np.concatenate([ea[:, 2], np.zeros(len(eb), dtype=np.int64)])
    db = np.concatenate([np.zeros(len(ea), dtype=np.int64), eb[:, 2]])
    order = np.lexsort((pos, tags))
    tags, pos, da, db = tags[order], pos[order], da[order], db[order]

    # Running membership after each event; reset at tag boundaries is
    # automatic because deltas balance to zero within each tag.
    ca = np.cumsum(da)
    cb = np.cumsum(db)
    inside = op(ca > 0, cb > 0)

    # Elementary segments: [pos[i], pos[i+1]) within the same tag, state
    # = inside[i].  Emit segments where state is true and length > 0.
    same = tags[1:] == tags[:-1]
    seg_tag = tags[:-1]
    seg_beg = pos[:-1]
    seg_end = pos[1:]
    keep = same & inside[:-1] & (seg_end > seg_beg)
    out = np.stack([seg_tag[keep], seg_beg[keep], seg_end[keep]], axis=1)
    return _normalize(out)


def empty_region() -> Region:
    return Region()


def from_intervals(tag: int, pairs) -> Region:
    """Region from (begin, end) pairs all on one tag."""
    arr = np.array(list(pairs), dtype=np.int64).reshape(-1, 2)
    out = np.empty((len(arr), 3), dtype=np.int64)
    out[:, 0] = tag
    out[:, 1:] = arr
    return Region(out)
