"""Masking stages: low-complexity (dust), tandem, coverage-based repeats,
and mask propagation through alignments.

Replaces DBdust / datander+TANmask / ``dentist mask-repetitive-regions`` /
``dentist propagate-mask`` (SURVEY §2.3, §2.2):

- :func:`dust_mask` — SDUST windowed triplet scoring (the algorithm
  inside DBdust, which the reference shells out to via ``dbdust``,
  ``dazzler.d:3813-3817``): a window is low-complexity when its triplet
  pair count ``Σ_t c_t(c_t−1)/2`` exceeds ``threshold × (l−1)`` where
  ``l`` is the triplet count of the window (DBdust defaults: 64-bp
  window, threshold 2.0, min interval 10).  Vectorized via per-triplet
  pair-range scatter instead of the serial sliding window.
- :func:`tandem_mask` — datander + TANmask semantics
  (``dazzler.d:5855-5881``, ``Snakefile:1056-1123``): self-align each
  sequence against itself restricted to near-diagonal bands using the
  production banded trace-point kernel (k=12, min alignment 500 bp,
  ≤30 % error — the reference's datander invocation,
  ``commandline.d:2865-2876``), then mask
  the union span ``[b_begin, a_end)`` of every self-alignment whose A
  and B intervals overlap (TANmask), keeping intervals ≥ 500 bp.
- :func:`coverage_mask` — the reference ``BadAlignmentCoverageAssessor``
  (``commands/maskRepetitiveRegions.d:246-540``): mask every region whose
  alignment coverage is outside ``[lower, upper]``, merging adjacent
  out-of-bounds zones; coverage counted per *chain* span on contig A.
- :func:`repeat_coverage_bounds_*` — the reference's default threshold
  formulas from ``--read-coverage`` (``commandline.d:1877-1984``).
- :func:`propagate_mask` — transfer mask intervals through alignments
  A→B via trace-point translation with floor/ceil rounding, flipping
  coordinates for complement alignments
  (``commands/propagateMask.d:284-295``).
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.chain import Chain
from ..ops.seeding import kmer_codes
from ..utils.regions import Region
from .alignments import LocalAlignmentSet

__all__ = [
    "dust_mask",
    "tandem_mask",
    "coverage_mask",
    "chain_intervals",
    "pack_chain_intervals",
    "repeat_coverage_bounds_reads",
    "repeat_coverage_bounds_improper",
    "validation_min_coverage",
    "propagate_mask",
    "propagate_mask_b_to_a",
]


def _sdust_windows(tri: np.ndarray, window: int, threshold: float) -> np.ndarray:
    """SDUST window scores → boolean "dusty" flag per window end.

    The DUST score of a window is ``Σ_t c_t(c_t−1)/2`` — the number of
    equal-triplet *pairs* inside it.  Each pair ``(p, q)`` (triplet
    indices, ``p < q``, ``q − p ≤ l−1`` where ``l = window − 2``)
    contributes to exactly the windows ending at ``e ∈ [q, p + l − 1]``,
    so the per-end scores are a prefix sum over a pair-range difference
    array — no serial sliding window.  Windows at the sequence start are
    truncated (length ``e + 1``) with the threshold scaled accordingly,
    matching the growing-window behavior at sequence boundaries.
    """
    nt = len(tri)
    l = window - 2
    if nt == 0:
        return np.zeros(0, dtype=bool)
    diff = np.zeros(nt + l + 1, dtype=np.int64)
    order = np.argsort(tri, kind="stable")  # groups by triplet, pos ascending
    tri_s = tri[order]
    starts = np.flatnonzero(np.r_[True, tri_s[1:] != tri_s[:-1]])
    bounds = np.r_[starts, nt]
    for gi in range(len(starts)):  # ≤ 64 distinct triplets
        P = order[bounds[gi] : bounds[gi + 1]]
        if len(P) < 2:
            continue
        idx = np.arange(len(P))
        pred = idx - np.searchsorted(P, P - (l - 1))
        succ = np.searchsorted(P, P + (l - 1), side="right") - idx - 1
        diff[P] += pred          # pair contribution begins at e = q
        diff[P + l] -= succ      # and ends after e = p + l − 1
    score = np.cumsum(diff)[:nt]
    l_e = np.minimum(np.arange(nt) + 1, l)
    return score > threshold * np.maximum(l_e - 1, 1)


def dust_mask(
    codes: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    window: int = 64,
    threshold: float = 2.0,
    min_size: int = 10,
) -> Region:
    """Low-complexity mask with SDUST windowed triplet scoring.

    DBdust semantics and defaults (the reference's ``dbdust``,
    ``dazzler.d:3796-3817``): 64-bp windows, threshold 2.0, minimum
    masked interval 10 bp.  A window is dusty when its triplet pair
    count exceeds ``threshold × (l − 1)``; dusty windows are marked
    whole and merged.  Tags are 1-based sequence ids.
    """
    triples = []
    l = window - 2
    for i, (o, L) in enumerate(zip(offsets, lengths)):
        tri = kmer_codes(codes[o : o + L], 3)
        dusty = np.flatnonzero(_sdust_windows(tri, window, threshold))
        if len(dusty) == 0:
            continue
        beg = np.maximum(dusty - l + 1, 0)
        end = np.minimum(dusty + 3, L)
        tags = np.full(len(dusty), i + 1, dtype=np.int64)
        triples.append(np.stack([tags, beg, end], axis=1))
    if not triples:
        return Region()
    return Region(np.concatenate(triples)).filter_min_size(min_size)


def tandem_mask(
    codes: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    k: int = 12,
    max_unit: int = 4000,
    min_alignment: int = 500,
    max_error: float = 0.30,
    min_size: int = 500,
    config=None,
) -> Region:
    """Tandem-repeat mask by banded self-alignment (datander + TANmask).

    Each sequence is aligned against itself on the near-diagonal bands
    only: seeds are consecutive same-k-mer occurrence pairs at distance
    ``(0, max_unit]`` (the tandem unit), extended with the production
    banded trace-point kernel at the reference's datander invocation (``-k12 -l<minAnchorLength=500>
    -e<1-maxAlignmentError=.70>``, ``commandline.d:2865-2876,2036``).  TANmask semantics turn the
    resulting self-alignments into mask intervals: whenever the A and B
    intervals of a self-alignment overlap or touch (``b_end ≥
    a_begin``), the array span ``[b_begin, a_end)`` is masked; merged
    intervals below ``min_size`` (TANmask ``-l500`` default) are
    dropped.  Tags are 1-based sequence ids.
    """
    from ..ops.aligner import Aligner, AlignerConfig

    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)

    class _MetaIndex:
        """Store metadata shim: the self-alignment seeds are injected, so
        no k-mer table is built (mirrors :class:`KmerIndex`'s surface)."""

        def __init__(self):
            self.offsets, self.lengths = offsets, lengths

        def seq_id_of(self, global_pos):
            return np.searchsorted(self.offsets, global_pos,
                                   side="right").astype(np.int64)

    cfg = config or AlignerConfig(k=k, min_length=min_alignment,
                                  max_error=max_error)
    # query_store = the store itself: tandem rides the resident
    # (arena) dispatch path and shares the mapping pass's compiled
    # programs instead of first-touching the host-window family
    aligner = Aligner(_MetaIndex(), codes, cfg,
                      query_store=(codes, offsets))
    for i, (o, L) in enumerate(zip(offsets, lengths)):
        seq = codes[o : o + L]
        km = kmer_codes(seq, k)
        if len(km) == 0:
            continue
        order = np.argsort(km, kind="stable")
        km_s = km[order]
        pos_s = order.astype(np.int64)
        same = km_s[1:] == km_s[:-1]
        d = pos_s[1:] - pos_s[:-1]
        m = same & (d >= 1) & (d <= max_unit)
        if not m.any():
            continue
        # A is the later copy: diag = a − b = unit ∈ (0, max_unit]
        a_pos = o + pos_s[1:][m]
        b_pos = pos_s[:-1][m]
        aligner.align_query(seq, i + 1, strands=(False,),
                            seeds={False: (a_pos, b_pos)}, self_tandem=True)
    las = aligner.finish()
    if len(las) == 0:
        return Region()
    tandem = las.b_end >= las.a_begin  # A/B intervals overlap or touch
    if not tandem.any():
        return Region()
    triples = np.stack([
        las.a_id[tandem],
        np.minimum(las.b_begin[tandem], las.a_begin[tandem]),
        np.maximum(las.a_end[tandem], las.b_end[tandem]),
    ], axis=1).astype(np.int64)
    return Region(triples).filter_min_size(min_size)


def chain_intervals(las: LocalAlignmentSet, chains: list[Chain]) -> np.ndarray:
    """(tag=a_id, first.a_begin, last.a_end) triples per chain.

    Mirrors ``alignmentIntervals`` (``maskRepetitiveRegions.d:183-200``).
    """
    if not chains:
        return np.empty((0, 3), dtype=np.int64)
    out = np.empty((len(chains), 3), dtype=np.int64)
    for i, ch in enumerate(chains):
        ab, ae, _, _ = ch.first_last(las)
        out[i] = (ch.a_id, ab, ae)
    return out


def pack_chain_intervals(las: LocalAlignmentSet) -> np.ndarray:
    """Per-chain A-span intervals from pre-assigned ``chain_id``.

    The reference masker packs flats into chains purely by their chain
    flags (``alignmentChainPacker``) — unchained LAs (daligner self
    output) each count as their own chain; mapper output groups by
    chain_id.  No score filtering happens here.
    """
    n = len(las)
    if n == 0:
        return np.empty((0, 3), dtype=np.int64)
    cid = las.chain_id
    unchained = cid < 0
    groups: dict[int, list[int]] = {}
    out = []
    for i in range(n):
        if unchained[i]:
            out.append((int(las.a_id[i]), int(las.a_begin[i]), int(las.a_end[i])))
        else:
            groups.setdefault(int(cid[i]), []).append(i)
    for idx in groups.values():
        ab = min(int(las.a_begin[i]) for i in idx)
        ae = max(int(las.a_end[i]) for i in idx)
        out.append((int(las.a_id[idx[0]]), ab, ae))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def coverage_mask(
    intervals: np.ndarray,
    contig_lengths: np.ndarray,
    lower: float,
    upper: float,
) -> Region:
    """Mask regions whose interval coverage is outside [lower, upper].

    `intervals` is (N, 3) = (contig_id 1-based, begin, end).  Contig
    boundaries generate zero-coverage zones at both ends, matching the
    reference's contig boundary events.
    """
    intervals = np.asarray(intervals, dtype=np.int64).reshape(-1, 3)
    if len(intervals) == 0:
        if lower <= 0:
            return Region()
        tags = np.arange(1, len(contig_lengths) + 1)
        tri = np.stack([tags, np.zeros_like(tags), np.asarray(contig_lengths)], axis=1)
        return Region(tri)
    events = []
    events.append(np.stack([intervals[:, 0], intervals[:, 1], np.ones(len(intervals), dtype=np.int64)], axis=1))
    events.append(np.stack([intervals[:, 0], intervals[:, 2], -np.ones(len(intervals), dtype=np.int64)], axis=1))
    tags = np.arange(1, len(contig_lengths) + 1, dtype=np.int64)
    zeros = np.zeros_like(tags)
    events.append(np.stack([tags, zeros, zeros], axis=1))
    events.append(np.stack([tags, np.asarray(contig_lengths, dtype=np.int64), zeros], axis=1))
    ev = np.concatenate(events)
    order = np.lexsort((ev[:, 2], ev[:, 1], ev[:, 0]))
    ev = ev[order]
    cov = np.cumsum(ev[:, 2])
    # segment between event i and i+1 on same tag has coverage cov[i]
    same = ev[1:, 0] == ev[:-1, 0]
    seg_tag = ev[:-1, 0]
    seg_beg = ev[:-1, 1]
    seg_end = ev[1:, 1]
    bad = (cov[:-1] < lower) | (cov[:-1] > upper)
    keep = same & bad & (seg_end > seg_beg)
    return Region(np.stack([seg_tag[keep], seg_beg[keep], seg_end[keep]], axis=1))


# -- reference threshold formulas (commandline.d) -----------------------

def repeat_coverage_bounds_reads(read_coverage: float) -> tuple[float, float]:
    """[0, C/ln(ln(ln(0.1650612·C + 5.9354533)/ln 1.65))] (``commandline.d:1877``)."""
    a, b, c = 1.65, 0.1650612, 5.9354533
    upper = read_coverage / math.log(math.log(math.log(b * read_coverage + c) / math.log(a)))
    return 0.0, float(int(upper))


def repeat_coverage_bounds_improper(read_coverage: float) -> tuple[float, float]:
    """[0, 0.5·C + exp(0.1875·(8 − C))] — smooth max(4, C/2) (``commandline.d:1957``)."""
    a, b, c = 0.5, 0.1875, 8.0
    upper = a * read_coverage + math.exp(b * (c - read_coverage))
    return 0.0, float(int(upper))


def validation_min_coverage(read_coverage: float, ploidy: int = 1) -> int:
    """min-coverage-reads default = C/(2·ploidy) (``commandline.d:2079``)."""
    return int(0.5 * read_coverage / ploidy)


def propagate_mask(
    mask: Region,
    las: LocalAlignmentSet,
    b_lengths: np.ndarray,
) -> Region:
    """Transfer mask intervals from the A side to the B side of alignments.

    For each alignment and each mask interval intersecting its A span, the
    interval endpoints (cropped to the span) are translated to B via trace
    points (floor for begin, ceil for end) and, for complement alignments,
    flipped to forward-strand B coordinates
    (``propagateMask.d:284-295``).  Tags of the result are b_ids.
    """
    if mask.empty or len(las) == 0:
        return Region()
    triples = []
    for i in range(len(las)):
        a_id = int(las.a_id[i])
        spans = mask.for_tag(a_id)
        if len(spans) == 0:
            continue
        a_beg, a_end = int(las.a_begin[i]), int(las.a_end[i])
        sel = spans[(spans[:, 1] > a_beg) & (spans[:, 0] < a_end)]
        if len(sel) == 0:
            continue
        bounds, b_at = las.boundaries_and_b(i)
        b_len = int(b_lengths[int(las.b_id[i]) - 1])
        for mb, me in sel:
            mb_c, me_c = max(mb, a_beg), min(me, a_end)
            # floor for begin, ceil for end
            kb = int(np.searchsorted(bounds, mb_c, side="right")) - 1
            ke = int(np.searchsorted(bounds, me_c, side="left"))
            ke = min(ke, len(bounds) - 1)
            pb, pe = int(b_at[kb]), int(b_at[ke])
            if bool(las.complement[i]):
                pb, pe = b_len - pe, b_len - pb
            if pe > pb:
                triples.append((int(las.b_id[i]), pb, pe))
    if not triples:
        return Region()
    return Region.from_triples(triples)


def propagate_mask_b_to_a(
    mask: Region,
    las: LocalAlignmentSet,
    a_lengths: np.ndarray,
    b_lengths: np.ndarray | None = None,
) -> Region:
    """Transfer mask intervals from the B (read) side back to the A side.

    The reads→assembly leg of mask homogenization
    (``Snakefile:1218-1287``: propagate to reads, then back, then merge).
    Mask tags are b_ids with forward-strand coordinates; the result is
    tagged by a_ids.  Translation inverts the trace-point mapping: the B
    coordinate is located among the cumulative B positions at trace
    boundaries, yielding A boundary coordinates (floor/ceil).
    """
    if mask.empty or len(las) == 0:
        return Region()
    triples = []
    for i in range(len(las)):
        b_id = int(las.b_id[i])
        spans = mask.for_tag(b_id)
        if len(spans) == 0:
            continue
        bounds, b_at = las.boundaries_and_b(i)
        b_beg, b_end = int(las.b_begin[i]), int(las.b_end[i])
        comp = bool(las.complement[i])
        L = int(b_lengths[b_id - 1]) if b_lengths is not None else b_end
        for mb_f, me_f in spans:
            if comp:
                mb, me = L - int(me_f), L - int(mb_f)
            else:
                mb, me = int(mb_f), int(me_f)
            mb_c, me_c = max(mb, b_beg), min(me, b_end)
            if me_c <= mb_c:
                continue
            kb = max(int(np.searchsorted(b_at, mb_c, side="right")) - 1, 0)
            ke = min(int(np.searchsorted(b_at, me_c, side="left")), len(bounds) - 1)
            ab, ae = int(bounds[kb]), int(bounds[ke])
            if ae > ab:
                triples.append((int(las.a_id[i]), ab, ae))
    if not triples:
        return Region()
    return Region.from_triples(triples)
