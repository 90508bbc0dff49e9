"""Collect stage of the port: pile-up collection with bubble re-mapping.

``collect_pile_ups`` and ``_resolve_bubbles`` are copies of
``dentist_tpu.models.pileups``'s, the only two functions of that module
that reach the device (bubble resolution re-maps reads with
``map_reads``); here they call the port's mapper.  Everything else is
host code and is re-exported from ``dentist_tpu.models.pileups``.
"""

from __future__ import annotations

import numpy as np

from dentist_tpu.models.alignments import concat_alignments
from dentist_tpu.models.pileups import (  # noqa: F401  (re-exports)
    ChainCtx,
    CollectConfig,
    GapSegment,
    Join,
    ReadAlignmentRep,
    Region,
    ScaffoldGraph,
    ScaffoldPayload,
    Seed,
    _bubble_path,
    _debug_dump,
    _discard_ambiguous_joins,
    _enforce_min_spanning_reads,
    _filter_ambiguous,
    _filter_contained,
    _filter_improper,
    _filter_lq,
    _filter_redundant,
    _filter_weakly_anchored,
    _graph_pile_ups,
    _merge_extensions_with_gaps,
    _merge_joins,
    _remove_input_gaps,
    _remove_none_joins,
    collect_read_alignments,
    log_json,
)
from dentist_tpu.models.scaffold import ContigPart

__all__ = ["ChainCtx", "CollectConfig", "ReadAlignmentRep", "Seed",
           "collect_pile_ups"]


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
