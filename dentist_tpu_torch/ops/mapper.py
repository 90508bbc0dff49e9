"""Read-to-assembly mapper: the damapper replacement.

Port of ``dentist_tpu/ops/mapper.py`` with its imports re-pointed at the
port's aligner; the chaining and best-fraction selection are unchanged.

damapper maps each read to the reference as *chains* of local alignments,
reporting the best chain and all chains within a fraction of the best
(SURVEY §2.3: "chains of LAs, best ±n%, -C symmetric output").  Here:

1. the alignment engine (:mod:`.aligner`) produces flat LAs of each read
   against the whole assembly (soft-masked seeding),
2. the reference chaining algorithm (:mod:`.chain`) runs per
   (contig, read) pair with no score filtering inside the pair
   (min_relative_score=0), and
3. per read, chains scoring ≥ ``best_frac`` × the read's best chain
   survive (damapper's -n semantics); the rest are dropped.

Survivors get ``chain_id`` assigned on the returned LocalAlignmentSet
(the Dazzler chain flags equivalent) so downstream stages — coverage
masking, pile-up collection — can pack chains without re-chaining.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.alignments import LocalAlignmentSet
from ..utils.log import log_json
from .aligner import AlignerConfig, align_store_pair
from .chain import Chain, ChainingOptions, chain_local_alignments

__all__ = ["MapperConfig", "map_reads"]


@dataclass
class MapperConfig:
    #: stride-3 query k-mer sampling: 25 kb reads at 13 % error still
    #: carry ~45 seeds/kb (hit rate ≈ 0.14), 10× the density floor, and
    #: 3 Mb-scenario chains are bit-identical to stride 2 while host
    #: seeding drops ~30 %
    aligner: AlignerConfig = field(
        default_factory=lambda: AlignerConfig(max_candidates=12,
                                              query_stride=3))
    chaining: ChainingOptions = field(
        default_factory=lambda: ChainingOptions(min_relative_score=0.0, min_score=0)
    )
    #: keep chains within this fraction of the read's best chain score
    best_frac: float = 0.95


def map_reads(
    target_codes: np.ndarray,
    target_offsets: np.ndarray,
    target_lengths: np.ndarray,
    reads: list[np.ndarray],
    read_ids: list[int] | None = None,
    config: MapperConfig | None = None,
    mask_intervals: np.ndarray | None = None,
    query_store=None,
    group=None,
) -> tuple[LocalAlignmentSet, list[Chain]]:
    """Map reads against the assembly.  Returns (las, chains).

    ``las`` contains only LAs belonging to surviving chains, sorted
    canonically, with ``chain_id`` set; ``chains`` index into it.
    ``group`` splits extension dispatches over data-parallel ranks (see
    :func:`~.aligner.align_store_pair`).
    """
    from ..utils.prof import prof

    cfg = config or MapperConfig()
    with prof("map.align"):
        las = align_store_pair(
            target_codes, target_offsets, target_lengths, reads, read_ids,
            config=cfg.aligner, mask_intervals=mask_intervals,
            query_store=query_store, group=group,
        )
    with prof("map.chain"):
        all_chains, las = chain_local_alignments(las, cfg.chaining)
    if not all_chains:
        return las.select(np.zeros(len(las), dtype=bool)), []

    # best-fraction selection per (read, read-region) group: damapper's -n
    # competes chains claiming the SAME part of a read (repeat-induced
    # alternatives), not disjoint parts — a gap-spanning read legitimately
    # has one chain per flank contig with very different scores.
    read_len = {rid: len(r) for rid, r in zip(read_ids or range(1, len(reads) + 1), reads)}

    def b_fwd(ch: Chain):
        f, l = ch.indices[0], ch.indices[-1]
        bb, be = int(las.b_begin[f]), int(las.b_end[l])
        if ch.complement:
            L = read_len[ch.b_id]
            return L - be, L - bb
        return bb, be

    by_read: dict[int, list[Chain]] = {}
    for ch in all_chains:
        by_read.setdefault(ch.b_id, []).append(ch)
    survivors = []
    for rid, chs in by_read.items():
        chs.sort(key=lambda c: b_fwd(c)[0])
        group: list[Chain] = []
        group_end = -1
        for ch in chs + [None]:
            if ch is not None:
                b, e = b_fwd(ch)
                # chains compete only when they claim substantially the
                # same read region (repeat-induced alternatives); a short
                # boundary overlap — e.g. the two flank chains of an
                # overlapping-contigs join — is NOT competition
                ov = group_end - b
                substantial = group and ov > 0 and (
                    ov * 2 > min(e - b, group_end - b_fwd(group[-1])[0]))
                if not group or substantial:
                    group.append(ch)
                    group_end = max(group_end, e)
                    continue
            best = max(c.score for c in group)
            survivors.extend(c for c in group if c.score >= cfg.best_frac * best)
            if ch is not None:
                group = [ch]
                group_end = b_fwd(ch)[1]

    # rebuild LAS restricted to surviving chains, with chain ids
    # (alternate chains may share prefix LAs — keep each LA once)
    keep_idx = np.unique(np.concatenate([ch.indices for ch in survivors]))
    new_pos = np.empty(len(las), dtype=np.int64)
    new_pos[keep_idx] = np.arange(len(keep_idx))
    sub = las.select(keep_idx)
    chain_id = np.full(len(sub), -1, dtype=np.int64)
    out_chains = []
    for k, ch in enumerate(survivors):
        idx_new = new_pos[ch.indices]
        chain_id[idx_new] = k
        out_chains.append(
            Chain(indices=idx_new, a_id=ch.a_id, b_id=ch.b_id,
                  complement=ch.complement, score=ch.score, alternate=ch.alternate)
        )
    sub.chain_id = chain_id
    log_json("diagnostic", event="mapReads", nReads=len(reads),
             nChains=len(out_chains), nAlignments=len(sub))
    return sub, out_chains
