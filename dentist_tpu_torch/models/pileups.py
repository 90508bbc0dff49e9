"""Pile-up collection — stage 1 of the core algorithm ("collect").

Re-expression of ``source/dentist/commands/collectPileUps/`` and the
read-alignment model of ``common/alignments/base.d``:

- The six filter passes in reference order (``package.d:130-157``,
  ``filter.d:121-340``): low-quality → improper → weakly-anchored →
  contained → ambiguous → redundant.
- Per-read candidate extraction ``collectReadAlignments``
  (``pileups.d:821-888``): seeded copies of each chain (front/back
  extension), ordered along the read, no read region used twice,
  paired into gap-spanning / extension `ReadAlignment`s.
- Scaffold-join construction ``makeJoin`` (``base.d:2680``), graph build
  with payload merging, ambiguity resolution by pile-up size margin with
  existing-gap bonus (``discardAmbiguousJoins``/``findCorrectGapJoin``,
  ``pileups.d:1592-1857``), min-spanning-reads enforcement, input-gap
  removal and optional extension merging
  (``mergeExtensionsWithGaps``, ``scaffold.d:789``).

Defaults mirror ``commandline.d``: max_alignment_error=0.3,
proper_allowance=126, min_anchor_length=500, best_pileup_margin=3.0,
existing_gap_bonus=6.0, min_spanning_reads=3.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from ..ops.chain import Chain
from ..utils.log import log_json
from ..utils.regions import Region
from .alignments import TRACE_SPACING, LocalAlignmentSet
from .scaffold import ContigPart, Join, Node, ScaffoldGraph
from .sequences import GapSegment

__all__ = [
    "CollectConfig",
    "Seed",
    "SeededChain",
    "ReadAlignmentRep",
    "ScaffoldPayload",
    "collect_pile_ups",
    "collect_read_alignments",
]


class Seed(IntEnum):
    FRONT = 0
    BACK = 1


@dataclass
class CollectConfig:
    max_alignment_error: float = 0.3
    proper_allowance: int = TRACE_SPACING
    min_anchor_length: int = 500
    best_pileup_margin: float = 3.0
    existing_gap_bonus: float = 6.0
    min_spanning_reads: int = 3
    merge_extensions: bool = True
    #: tolerated read-interval overlap between the two flank chains of a
    #: gap candidate: overlapping-contig joins (closed by cropping at the
    #: splice stage, ``insertions.d:107-284``) produce reads whose two
    #: chains legitimately share up to the contig-overlap length
    overlap_allowance: int = 2 * TRACE_SPACING
    #: bubble resolution (skipped short contigs): max cycle size / passes
    max_bubble_size: int = 12
    max_bubble_resolver_iterations: int = 5
    #: dump pile-ups after each collect sub-stage to <stem>.<stage>.npz
    #: (reference ``--debug-pile-ups``, ``pileups.d:459-483``)
    debug_pile_ups_stem: str | None = None


# ----------------------------------------------------------------------
# chain-level geometry helpers


@dataclass
class ChainCtx:
    """Chains + sequence metadata shared by all collect passes."""

    las: LocalAlignmentSet
    chains: list[Chain]
    contig_lengths: np.ndarray  # per 1-based a_id
    read_lengths: np.ndarray  # per 1-based b_id
    disabled: np.ndarray = None  # per chain

    def __post_init__(self):
        if self.disabled is None:
            self.disabled = np.zeros(len(self.chains), dtype=bool)

    def a_len(self, ch: Chain) -> int:
        return int(self.contig_lengths[ch.a_id - 1])

    def b_len(self, ch: Chain) -> int:
        return int(self.read_lengths[ch.b_id - 1])

    def spans(self, ch: Chain):
        return ch.first_last(self.las)

    def error_rate(self, ch: Chain) -> float:
        ab, ae, bb, be = self.spans(ch)
        covered = sum(
            (self.las.a_length(i) + self.las.b_length(i)) for i in ch.indices
        )
        return 2.0 * ch.total_diffs(self.las) / max(1, covered)

    def b_fwd_interval(self, ch: Chain) -> tuple[int, int]:
        """Chain's read interval in forward-strand coordinates."""
        _, _, bb, be = self.spans(ch)
        if ch.complement:
            L = self.b_len(ch)
            return L - be, L - bb
        return bb, be

    def is_front_extension(self, ch: Chain) -> bool:
        """Read sequence extends beyond the contig begin (``base.d:2030``)."""
        ab, _, bb, _ = self.spans(ch)
        return bb > ab

    def is_back_extension(self, ch: Chain) -> bool:
        ab, ae, bb, be = self.spans(ch)
        return (self.b_len(ch) - be) > (self.a_len(ch) - ae)

    def is_proper(self, ch: Chain, allowance: int) -> bool:
        ab, ae, bb, be = self.spans(ch)
        begins = ab <= allowance or bb <= allowance
        ends = ae >= self.a_len(ch) - allowance or be >= self.b_len(ch) - allowance
        return begins and ends

    def is_fully_contained(self, ch: Chain) -> bool:
        """Read + dangling ends fits inside one contig (``base.d:589``)."""
        ab, ae, bb, be = self.spans(ch)
        if bb > ab:
            return False
        x = ab - bb
        y = ae + self.b_len(ch) - be
        return 0 <= x and y < self.a_len(ch)


# ----------------------------------------------------------------------
# filters (reference order)


def _filter_lq(ctx: ChainCtx, cfg: CollectConfig) -> int:
    n = 0
    for k, ch in enumerate(ctx.chains):
        if not ctx.disabled[k] and ctx.error_rate(ch) > cfg.max_alignment_error:
            ctx.disabled[k] = True
            n += 1
    return n


def _filter_improper(ctx: ChainCtx, cfg: CollectConfig) -> int:
    n = 0
    for k, ch in enumerate(ctx.chains):
        if not ctx.disabled[k] and not ctx.is_proper(ch, cfg.proper_allowance):
            ctx.disabled[k] = True
            n += 1
    return n


def _filter_weakly_anchored(ctx: ChainCtx, cfg: CollectConfig, repeats: Region) -> int:
    n = 0
    for k, ch in enumerate(ctx.chains):
        if ctx.disabled[k]:
            continue
        ab, ae, _, _ = ctx.spans(ch)
        unique = (ae - ab) - repeats.coverage_of(ch.a_id, ab, ae)
        if unique <= cfg.min_anchor_length:
            ctx.disabled[k] = True
            n += 1
    return n


def _filter_contained(ctx: ChainCtx) -> int:
    """Disable chains contained in another chain on both A and B."""
    n = 0
    order = sorted(
        range(len(ctx.chains)),
        key=lambda k: (
            ctx.chains[k].a_id, ctx.chains[k].b_id,
            ctx.spans(ctx.chains[k])[0], -ctx.spans(ctx.chains[k])[1],
        ),
    )
    for ii, k1 in enumerate(order):
        if ctx.disabled[k1]:
            continue
        c1 = ctx.chains[k1]
        ab1, ae1, bb1, be1 = ctx.spans(c1)
        for k2 in order[ii + 1 :]:
            c2 = ctx.chains[k2]
            if (c2.a_id, c2.b_id) != (c1.a_id, c1.b_id):
                break
            ab2, ae2, bb2, be2 = ctx.spans(c2)
            if ab2 >= ae1:
                break
            if ctx.disabled[k2] or c2.complement != c1.complement:
                continue
            if ab1 <= ab2 and ae2 <= ae1 and bb1 <= bb2 and be2 <= be1:
                ctx.disabled[k2] = True
                n += 1
    return n


def _filter_ambiguous(ctx: ChainCtx, overlap_allowance: int = 0) -> int:
    """Discard reads where one read region aligns to multiple loci.

    ``overlap_allowance`` admits a bounded overlap between chains to
    different loci — the signature of an overlapping-contigs join (the
    splice stage resolves it by cropping); each chain still needs its own
    ≥500bp unique anchor, so short shared edges cannot create false joins.
    """
    n = 0
    by_read: dict[int, list[int]] = {}
    for k, ch in enumerate(ctx.chains):
        if not ctx.disabled[k]:
            by_read.setdefault(ch.b_id, []).append(k)
    for read_id, ks in by_read.items():
        ivs = [ctx.b_fwd_interval(ctx.chains[k]) for k in ks]
        # maximally connected components by interval overlap
        order = sorted(range(len(ks)), key=lambda i: ivs[i])
        ambiguous = False
        group_end = -1
        for i in order:
            b, e = ivs[i]
            if b + overlap_allowance < group_end:  # overlaps current group
                ambiguous = True
                group_end = max(group_end, e)
            else:
                group_end = max(group_end, e)
        if ambiguous:
            for k in ks:
                ctx.disabled[k] = True
            n += 1
    return n


def _filter_redundant(ctx: ChainCtx) -> int:
    """Discard reads fully contained (with extensions) in a single contig."""
    n = 0
    discard_reads = set()
    for k, ch in enumerate(ctx.chains):
        if not ctx.disabled[k] and ctx.is_fully_contained(ch):
            discard_reads.add(ch.b_id)
    for k, ch in enumerate(ctx.chains):
        if ch.b_id in discard_reads and not ctx.disabled[k]:
            ctx.disabled[k] = True
            n += 1
    return n


# ----------------------------------------------------------------------
# per-read candidate extraction


@dataclass(frozen=True)
class SeededChain:
    chain_idx: int  # into ctx.chains
    seed: Seed


@dataclass
class ReadAlignmentRep:
    """1–2 seeded chains of one read: an extension or gap candidate."""

    parts: tuple[SeededChain, ...]

    @property
    def is_extension(self) -> bool:
        return len(self.parts) == 1

    def is_gap(self, ctx: ChainCtx) -> bool:
        if len(self.parts) != 2:
            return False
        c0 = ctx.chains[self.parts[0].chain_idx]
        c1 = ctx.chains[self.parts[1].chain_idx]
        return c0.a_id != c1.a_id and c0.b_id == c1.b_id

    def is_valid(self, ctx: ChainCtx) -> bool:
        return self.is_extension ^ self.is_gap(ctx)

    def get_in_order(self, ctx: ChainCtx) -> "ReadAlignmentRep":
        if len(self.parts) == 2:
            c0 = ctx.chains[self.parts[0].chain_idx]
            c1 = ctx.chains[self.parts[1].chain_idx]
            if c0.a_id > c1.a_id:
                return ReadAlignmentRep((self.parts[1], self.parts[0]))
        return self

    def read_id(self, ctx: ChainCtx) -> int:
        return ctx.chains[self.parts[0].chain_idx].b_id

    def make_join_nodes(self, ctx: ChainCtx) -> tuple[Node, Node]:
        """``makeJoin`` (``base.d:2680``)."""
        if self.is_extension:
            ch = ctx.chains[self.parts[0].chain_idx]
            if self.parts[0].seed == Seed.FRONT:
                return (ch.a_id, ContigPart.PRE), (ch.a_id, ContigPart.BEGIN)
            return (ch.a_id, ContigPart.END), (ch.a_id, ContigPart.POST)
        part = lambda p: ContigPart.BEGIN if p.seed == Seed.FRONT else ContigPart.END
        c0 = ctx.chains[self.parts[0].chain_idx]
        c1 = ctx.chains[self.parts[1].chain_idx]
        return (c0.a_id, part(self.parts[0])), (c1.a_id, part(self.parts[1]))


def collect_read_alignments(ctx: ChainCtx, chain_idxs: list[int],
                            start_allowance: int = TRACE_SPACING,
                            overlap_allowance: int = 2 * TRACE_SPACING,
                            ) -> list[ReadAlignmentRep]:
    """``collectReadAlignments`` (``pileups.d:821-888``) for one read.

    `start_allowance`: the reference tests ``beginRelToContigB > 0``
    strictly (daligner alignments of reads starting inside a contig reach
    read base 0 exactly); our aligner may trim a few bases at the read
    start, so an unaligned prefix up to one trace interval does not count
    as an extension.

    `overlap_allowance`: the reference rejects any read region used by
    two chains; a bounded overlap is admitted here so overlapping-contig
    joins (resolved by cropping at the splice stage) keep their spanning
    reads.
    """
    seeded: list[tuple[int, int, int, SeededChain]] = []  # (b_fwd_begin, b_fwd_end, seed_rel, sc)
    for k in chain_idxs:
        ch = ctx.chains[k]
        b, e = ctx.b_fwd_interval(ch)
        for seed, pred in ((Seed.FRONT, ctx.is_front_extension), (Seed.BACK, ctx.is_back_extension)):
            if pred(ch):
                seed_rel = -int(seed) if ch.complement else int(seed)
                seeded.append((b, e, seed_rel, SeededChain(k, seed)))
    if not seeded:
        return []
    seeded.sort(key=lambda t: t[:3])

    # no region of the read may be used twice (by different chains),
    # modulo the bounded overlap of overlapping-contig joins
    for (b1, e1, _, s1), (b2, e2, _, s2) in zip(seeded, seeded[1:]):
        if e1 > b2 + overlap_allowance and s1.chain_idx != s2.chain_idx:
            return []

    start_with_extension = seeded[0][0] > start_allowance
    slice_start = 1 if start_with_extension else 0
    reps: list[ReadAlignmentRep] = []
    if start_with_extension:
        reps.append(ReadAlignmentRep((seeded[0][3],)))
    for i in range(slice_start, len(seeded), 2):
        parts = tuple(s[3] for s in seeded[i : i + 2])
        reps.append(ReadAlignmentRep(parts))
    if any(not r.is_valid(ctx) for r in reps):
        return []
    return [r.get_in_order(ctx) for r in reps]


# ----------------------------------------------------------------------
# scaffold payload + pile-up assembly


@dataclass
class ScaffoldPayload:
    """Edge payload: pile-up reads and/or an input-gap marker."""

    read_alignments: list[ReadAlignmentRep] = field(default_factory=list)
    is_pile_up: bool = False
    is_input_gap: bool = False

    @staticmethod
    def pile_up(reps: list[ReadAlignmentRep]) -> "ScaffoldPayload":
        return ScaffoldPayload(list(reps), is_pile_up=True)

    @staticmethod
    def input_gap() -> "ScaffoldPayload":
        return ScaffoldPayload(is_input_gap=True)

    @property
    def empty(self) -> bool:
        return not (self.is_pile_up or self.is_input_gap)

    @staticmethod
    def merge(a: "ScaffoldPayload", b: "ScaffoldPayload") -> "ScaffoldPayload":
        return ScaffoldPayload(
            a.read_alignments + b.read_alignments,
            is_pile_up=a.is_pile_up or b.is_pile_up,
            is_input_gap=a.is_input_gap or b.is_input_gap,
        )


def _merge_joins(a: Join, b: Join) -> Join:
    return Join(a.start, a.end, ScaffoldPayload.merge(a.payload, b.payload))


def _remove_none_joins(g: ScaffoldGraph) -> None:
    for key in [k for k, j in g.edges.items()
                if isinstance(j.payload, ScaffoldPayload) and j.payload.empty]:
        g.remove(key)


def collect_pile_ups(
    ctx: ChainCtx,
    input_gaps: list[GapSegment],
    repeats: Region,
    cfg: CollectConfig | None = None,
    contigs=None,
    reads=None,
) -> list[list[ReadAlignmentRep]]:
    """Run the full collect stage; returns pile-ups (lists of candidates).

    `contigs`/`reads` (SeqStores) enable bubble resolution — re-mapping
    reads that skip short contigs against the skipped contigs without
    masks (``resolveBubbles``, ``pileups.d:1124-1370``).
    """
    cfg = cfg or CollectConfig()

    counts = {
        "lq": _filter_lq(ctx, cfg),
        "improper": _filter_improper(ctx, cfg),
        "weaklyAnchored": _filter_weakly_anchored(ctx, cfg, repeats),
        "contained": _filter_contained(ctx),
        "ambiguous": _filter_ambiguous(ctx, cfg.overlap_allowance),
        "redundant": _filter_redundant(ctx),
    }
    log_json("info", event="filterAlignments", disabled=counts,
             remaining=int((~ctx.disabled).sum()))

    # per-read candidate extraction → scaffold joins
    by_read: dict[int, list[int]] = {}
    for k, ch in enumerate(ctx.chains):
        if not ctx.disabled[k]:
            by_read.setdefault(ch.b_id, []).append(k)
    joins: list[Join] = []
    for read_id in sorted(by_read):
        for rep in collect_read_alignments(ctx, by_read[read_id],
                                           overlap_allowance=cfg.overlap_allowance):
            start, end = rep.make_join_nodes(ctx)
            joins.append(Join(start, end, ScaffoldPayload.pile_up([rep])))
    for gap in input_gaps:
        joins.append(
            Join(
                (gap.begin_global_contig_id, ContigPart.END),
                (gap.end_global_contig_id, ContigPart.BEGIN),
                ScaffoldPayload.input_gap(),
            )
        )

    graph = ScaffoldGraph.build(len(ctx.contig_lengths), joins, _merge_joins)
    _remove_none_joins(graph)
    _debug_dump(graph, cfg, "raw")

    if contigs is not None and reads is not None:
        for _ in range(cfg.max_bubble_resolver_iterations):
            if _resolve_bubbles(graph, ctx, contigs, reads, cfg) == 0:
                break
        _debug_dump(graph, cfg, "resolvedBubbles")

    _discard_ambiguous_joins(graph, cfg.best_pileup_margin, cfg.existing_gap_bonus)
    _debug_dump(graph, cfg, "unambiguous")
    _enforce_min_spanning_reads(graph, cfg.min_spanning_reads)
    _debug_dump(graph, cfg, "minSpanningEnforced")
    _remove_input_gaps(graph)
    _debug_dump(graph, cfg, "inputGapsRemoved")
    if cfg.merge_extensions:
        _merge_extensions_with_gaps(graph)
        _debug_dump(graph, cfg, "extensionsMerged")

    pile_ups = _graph_pile_ups(graph)
    log_json("info", event="collectPileUps", numPileUps=len(pile_ups))
    return pile_ups


def _graph_pile_ups(g: ScaffoldGraph) -> list[list[ReadAlignmentRep]]:
    out = []
    for join in sorted(g.joins(), key=lambda j: j.key):
        p = join.payload
        if isinstance(p, ScaffoldPayload) and p.is_pile_up and p.read_alignments:
            out.append(p.read_alignments)
    return out


def _debug_dump(g: ScaffoldGraph, cfg: CollectConfig, stage: str) -> None:
    """``--debug-pile-ups`` stage dumps (``pileups.d:459-483``)."""
    if not cfg.debug_pile_ups_stem:
        return
    from ..io.store import save_pile_ups

    save_pile_ups(f"{cfg.debug_pile_ups_stem}.{stage}.npz", _graph_pile_ups(g))


def _discard_ambiguous_joins(g: ScaffoldGraph, margin: float, gap_bonus: float) -> None:
    """``discardAmbiguousJoins`` + ``findCorrectGapJoin`` (``pileups.d:1592``)."""
    inc = g.incidence_map()
    to_strip: list[Join] = []
    for node, edges in inc.items():
        if not node[1].is_real or len(edges) <= 2:
            continue
        gap_joins = [j for j in edges if j.is_gap and j.payload.is_pile_up]
        if len(gap_joins) <= 1:
            continue
        sizes = [
            len(j.payload.read_alignments) * (gap_bonus if j.payload.is_input_gap else 1.0)
            for j in gap_joins
        ]
        order = np.argsort(-np.asarray(sizes), kind="stable")
        best, snd = order[0], order[1]
        if sizes[snd] * margin < sizes[best]:
            losers = [gap_joins[i] for i in order[1:]]
        else:
            log_json("warn", event="pileUpSkipped", reason="scaffoldingConflict",
                     node=list(node))
            losers = gap_joins
        to_strip.extend(losers)
    for j in to_strip:
        j.payload.read_alignments = []
        j.payload.is_pile_up = False
    _remove_none_joins(g)


def _enforce_min_spanning_reads(g: ScaffoldGraph, min_spanning: int) -> None:
    for j in g.joins():
        p = j.payload
        if (isinstance(p, ScaffoldPayload) and p.is_pile_up and j.is_gap
                and len(p.read_alignments) < min_spanning):
            log_json("warn", event="pileUpSkipped", reason="minSpanningReads",
                     numReads=len(p.read_alignments), join=[list(j.start), list(j.end)])
            p.read_alignments = []
            p.is_pile_up = False
    _remove_none_joins(g)


def _remove_input_gaps(g: ScaffoldGraph) -> None:
    for j in g.joins():
        if isinstance(j.payload, ScaffoldPayload):
            j.payload.is_input_gap = False
    _remove_none_joins(g)


def _resolve_bubbles(graph: ScaffoldGraph, ctx: ChainCtx, contigs, reads,
                     cfg: CollectConfig) -> int:
    """Resolve "simple bubbles": pile-ups whose reads skip short contigs.

    A gap join (the *skipper*) whose endpoints are also connected by an
    alternate path of degree-2 nodes indicates reads jumping over one or
    more short (typically repeat-masked) contigs.  The skipper's reads
    are re-mapped against the skipped contigs *without masks*, requiring
    full-contig coverage, and the recovered anchoring splits the skipper
    into path-consistent joins (``resolveBubbles``/``BubbleResolver``,
    ``pileups.d:1124-1420``).
    """
    from ..ops.mapper import MapperConfig, map_reads
    from .alignments import concat_alignments

    inc = graph.incidence_map()

    def degree_ne(node):  # degree disregarding extension joins
        return sum(1 for j in inc.get(node, []) if not j.is_extension)

    resolved = 0
    for join in list(graph.joins()):
        p = join.payload
        if not (isinstance(p, ScaffoldPayload) and p.is_pile_up and join.is_gap):
            continue
        u, v = join.start, join.end
        if degree_ne(u) < 3 or degree_ne(v) < 3:
            continue
        path = _bubble_path(graph, inc, u, v, join, cfg.max_bubble_size, degree_ne)
        if path is None:
            continue
        interior_contigs = sorted({n[0] for n in path[1:-1]} - {u[0], v[0]})
        if not interior_contigs:
            continue

        # re-map the skipper's reads against the skipped contigs, unmasked
        read_ids = sorted({rep.read_id(ctx) for rep in p.read_alignments})
        sub_codes = np.concatenate([contigs.get(c) for c in interior_contigs])
        sub_lens = np.array([len(contigs.get(c)) for c in interior_contigs])
        sub_offs = np.concatenate([[0], np.cumsum(sub_lens)])[:-1]
        las2, chains2 = map_reads(
            sub_codes, sub_offs, sub_lens,
            [reads.get(r) for r in read_ids], read_ids=list(range(1, len(read_ids) + 1)),
            config=MapperConfig(),
        )
        # keep chains completely covering their intermediate contig
        keep = []
        for ch in chains2:
            ab, ae, _, _ = ch.first_last(las2)
            a_len = int(sub_lens[ch.a_id - 1])
            if ab <= cfg.proper_allowance and ae >= a_len - cfg.proper_allowance:
                keep.append(ch)
        log_json("diagnostic", event="resolveBubble",
                 skipper=[list(u), list(v)], interior=interior_contigs,
                 nReads=len(read_ids), nRecovered=len(keep))
        if not keep:
            continue

        # splice recovered chains into the shared context (ids remapped)
        base = len(ctx.las)
        id_map_a = {i + 1: c for i, c in enumerate(interior_contigs)}
        id_map_b = {i + 1: r for i, r in enumerate(read_ids)}
        las2.a_id = np.array([id_map_a[int(x)] for x in las2.a_id], dtype=np.int32)
        las2.b_id = np.array([id_map_b[int(x)] for x in las2.b_id], dtype=np.int32)
        ctx.las = concat_alignments([ctx.las, las2])
        new_idx = []
        for ch in keep:
            ch.indices = ch.indices + base
            ch.a_id = int(ctx.las.a_id[ch.indices[0]])
            ch.b_id = int(ctx.las.b_id[ch.indices[0]])
            new_idx.append(len(ctx.chains))
            ctx.chains.append(ch)
        ctx.disabled = np.concatenate([ctx.disabled, np.zeros(len(keep), dtype=bool)])

        # allowed joins: consecutive node pairs along the alternate path
        allowed = {Join(path[i], path[i + 1]).key for i in range(len(path) - 1)}
        by_read: dict[int, list[int]] = {}
        for k, ch in enumerate(ctx.chains):
            if not ctx.disabled[k] and ch.b_id in set(read_ids):
                by_read.setdefault(ch.b_id, []).append(k)
        new_joins = []
        for rid in read_ids:
            for rep in collect_read_alignments(ctx, by_read.get(rid, [])):
                start, end = rep.make_join_nodes(ctx)
                key = Join(start, end).key
                if rep.is_gap(ctx) and key not in allowed:
                    continue  # inconsistent with the scaffold path
                new_joins.append(Join(start, end, ScaffoldPayload.pile_up([rep])))

        p.read_alignments = []
        p.is_pile_up = False
        for j in new_joins:
            graph.add(j, _merge_joins)
        resolved += 1

    if resolved:
        _remove_none_joins(graph)
        log_json("info", event="resolveBubbles", resolved=resolved)
    return resolved


def _bubble_path(graph, inc, u: Node, v: Node, skipper: Join, max_size: int,
                 degree_ne) -> list[Node] | None:
    """Shortest u→v path through degree-2 nodes, excluding the skipper."""
    from collections import deque

    queue = deque([(u, [u])])
    seen = {u}
    while queue:
        node, path = queue.popleft()
        if len(path) > max_size:
            continue
        for j in inc.get(node, []):
            if j.key == skipper.key or j.is_extension:
                continue
            m = j.other(node)
            if m == v and len(path) >= 2:
                return path + [v]
            if m in seen or degree_ne(m) > 2:
                continue
            seen.add(m)
            queue.append((m, path + [m]))
    return None


def _merge_extensions_with_gaps(g: ScaffoldGraph) -> None:
    """``mergeExtensionsWithGaps`` (``scaffold.d:789``)."""
    inc = g.incidence_map()
    for node, edges in inc.items():
        if not node[1].is_real or len(edges) != 3:
            continue
        non_default = [j for j in edges if not j.is_default]
        if len(non_default) != 2:
            continue
        gap_join = next((j for j in non_default if j.other(node)[1].is_real), None)
        ext_join = next((j for j in non_default if not j.other(node)[1].is_real), None)
        if gap_join is None or ext_join is None:
            continue
        gap_join.payload = ScaffoldPayload.merge(gap_join.payload, ext_join.payload)
        ext_join.payload = ScaffoldPayload()
    _remove_none_joins(g)
