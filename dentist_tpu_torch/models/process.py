"""Process stage: per-pile-up consensus → insertions ("process-pile-ups").

Port of ``dentist_tpu/models/process.py`` running the port's consensus.
One difference in behavior: the per-pile-up containment handlers
re-raise device errors (:data:`dentist_tpu_torch.errors.DEVICE_ERRORS`),
so a kernel fault stops the run instead of becoming a skipped pile-up.

Re-expression of ``source/dentist/commands/processPileUps/``:

1. **Crop** (``cropper.d:113-560``): per contig side, the common unmasked
   trace point of all the pile-up's alignments — back seeds take the
   first (deepest-anchor) candidate, front seeds the last; each read is
   cropped at that exact reference position via trace-point translation
   and *normalized to walk orientation* (the reference keeps native read
   strands and lets daccord sort it out; normalizing up front makes the
   consensus strand-free).  Short anchors are patched with contig
   sequence (``fetchSupportPatches``).
2. **Consensus** (:mod:`dentist_tpu_torch.ops.consensus` — the daccord
   replacement).
3. **Splice** (``alignConsensusToFlankingContigs``/
   ``getInsertionAlignment``, ``package.d:621-769``): the consensus must
   contain each flank's gap-facing edge anchor; the insertion is the
   consensus segment between the contig edges.  Quality gate: anchor
   alignment error ≤ ``max_insertion_error``.

Every failure skips the pile-up with a logged reason, mirroring the
reference's per-pile-up error containment
(``processPileUps/package.d:351-374``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..errors import DEVICE_ERRORS
from ..io.fasta import reverse_complement
from ..ops.consensus import consensus_batch, rank_reference_reads
from ..utils.log import log_json
from ..utils.regions import Region
from .alignments import TRACE_SPACING, LocalAlignmentSet
from .insertions import Insertion
from .pileups import ChainCtx, ReadAlignmentRep, Seed
from .scaffold import ContigPart, Node
from .sequences import SeqStore

__all__ = ["ProcessConfig", "process_pile_ups", "process_pile_up"]


@dataclass
class ProcessConfig:
    min_anchor_length: int = 500
    max_insertion_error: float = 0.1
    allow_single_reads: bool = False
    #: skip pile ups with fewer reads, unless allow_single_reads admits a
    #: singular one (``processPileUps/package.d:378-392``)
    min_reads_per_pile_up: int = 3
    consensus_rounds: int = 3
    band_width: int = 128
    anchor_probe: int = 64  # bases of contig edge located in the consensus
    #: max total edits tolerated when locating an edge anchor
    anchor_max_edits: int = 8
    #: consensus retries over QV-ranked reference-read candidates on
    #: splice failure (``processPileUps/package.d:600-619``)
    max_consensus_retries: int = 2
    #: error-profile tilt for cost-tied consensus polish edits:
    #: ``"delete"`` = insertion-biased reads (PacBio CLR, the default),
    #: ``"insert"`` = deletion-biased (older ONT), ``"none"`` = no tilt.
    #: daccord derives this from its error profile (``dazzler.d:4324``).
    consensus_tie_policy: str = "delete"


# ----------------------------------------------------------------------


def _side_seed(part: ContigPart) -> Seed:
    """Gap-facing side at contig END = back seed; at BEGIN = front seed."""
    return Seed.BACK if part == ContigPart.END else Seed.FRONT


def _common_trace_point(
    ctx: ChainCtx, chain_idxs: list[int], contig_id: int, seed: Seed,
    repeats: Region, contig_len: int,
) -> int | None:
    """``getCommonTracePoint`` (``cropper.d:446``)."""
    spans = []
    for k in chain_idxs:
        ab, ae, _, _ = ctx.spans(ctx.chains[k])
        spans.append((ab, ae))
    lo = max(s[0] for s in spans)
    hi = min(s[1] for s in spans)
    if hi <= lo:
        return None
    common = Region.single(contig_id, lo, hi)
    for region in (common - repeats, common):
        if region.empty:
            continue
        iv = region.for_tag(contig_id)
        r_lo, r_hi = int(iv[:, 0].min()), int(iv[:, 1].max())
        first = (r_lo + TRACE_SPACING - 1) // TRACE_SPACING * TRACE_SPACING
        cands = list(range(first, r_hi, TRACE_SPACING))
        if r_hi >= contig_len:
            cands.append(contig_len)
        # candidate must lie in the region (or be its sup)
        def ok(c):
            return region.contains_point(contig_id, c) or c == r_hi
        cands = [c for c in cands if ok(c)]
        if not cands:
            continue
        return max(cands) if seed == Seed.FRONT else min(cands)
    return None


#: sentinel: the anchor matches at more than one distinct consensus
#: placement — the reference requires a UNIQUE proper overlap per flank
#: (``getInsertionAlignment``, ``processPileUps/package.d:699-769``) and
#: fails the pile-up rather than risk splicing at the wrong repeat copy
AMBIGUOUS = "ambiguous"


def _locate_anchor(cons: np.ndarray, anchor: np.ndarray, max_edits: int):
    """Find `anchor` in `cons`; returns (start, end, edits), ``AMBIGUOUS``
    if more than one distinct placement qualifies, or None.

    Exact rolling match first; edit-tolerant scan as fallback.  Two
    placements are distinct when their starts differ by more than half
    the anchor length (heavily-overlapping hits of a periodic anchor are
    one alignment region, not an ambiguity).
    """
    la, lc = len(anchor), len(cons)
    if la == 0 or lc < la // 2:
        return None
    # exact search via rolling comparison
    if lc >= la:
        windows = np.lib.stride_tricks.sliding_window_view(cons, la)
        hits = np.flatnonzero((windows == anchor).all(axis=1))
        if len(hits):
            if _n_placements(hits, la) > 1:
                return AMBIGUOUS
            s = int(hits[0])
            return s, s + la, 0
    # fallback: banded NW of anchor against cons, free-shift on cons side
    prev = np.zeros(lc + 1, dtype=np.int64)  # free leading cons gap
    prev_start = np.arange(lc + 1)
    ar = np.arange(lc + 1)
    for i in range(1, la + 1):
        diag = prev[:-1] + (cons != anchor[i - 1])
        up = prev[1:] + 1
        take_diag = diag <= up
        cur = np.empty(lc + 1, dtype=np.int64)
        cur_start = np.empty(lc + 1, dtype=np.int64)
        cur[1:] = np.where(take_diag, diag, up)
        cur_start[1:] = np.where(take_diag, prev_start[:-1], prev_start[1:])
        cur[0] = i
        cur_start[0] = 0
        # left moves (gap in anchor) are a min-plus prefix scan:
        # fin[j] = min_{j'<=j} cur[j'] + (j-j'); source follows the
        # latest attaining j' (matching the former serial loop's ties)
        t = cur - ar
        m = np.minimum.accumulate(t)
        src = np.maximum.accumulate(np.where(t == m, ar, 0))
        prev = m + ar
        prev_start = cur_start[src]
    j_end = int(np.argmin(prev))
    edits = int(prev[j_end])
    if edits > max_edits:
        return None
    s0 = int(prev_start[j_end])
    # uniqueness: other qualifying placements far from the best one mean
    # the flank could splice at two sites — reject (reference rejects
    # non-unique proper overlaps, ``package.d:699-769``)
    starts_q = np.sort(prev_start[prev <= max_edits])
    if len(starts_q) and _n_placements(starts_q, la) > 1:
        return AMBIGUOUS
    return s0, j_end, edits


def _n_placements(sorted_starts: np.ndarray, la: int) -> int:
    """Number of distinct anchor placements among sorted start positions:
    chains of starts each within ``la``/2 of the previous (overlapping
    hits of a periodic anchor, or edit-noise around one site) form ONE
    placement; a jump beyond that opens a new one."""
    if len(sorted_starts) <= 1:
        return len(sorted_starts)
    return 1 + int((np.diff(sorted_starts) > la // 2).sum())


@dataclass
class _Prepared:
    """A cropped, oriented pile-up ready for consensus + splicing."""

    cropped: list[np.ndarray]
    read_ids: list[int]
    sides: list[Node]
    is_gap: bool
    start: Node
    end: Node
    #: index of the default (median-length) consensus template read
    median_idx: int = 0


def _prepare_pile_up(
    pile_up: list[ReadAlignmentRep],
    ctx: ChainCtx,
    contigs: SeqStore,
    reads: SeqStore,
    repeats: Region,
    cfg: ProcessConfig,
) -> _Prepared | None:
    """Crop + orient the pile-up's reads (with logged reason on failure)."""
    start, end = pile_up[0].make_join_nodes(ctx)
    if end < start:
        start, end = end, start
    is_gap = start[0] != end[0]
    sides: list[Node] = [start, end] if is_gap else [start if start[1].is_real else end]
    if not is_gap:
        # extension: the real node is the contig side
        real = start if start[1].is_real else end
        sides = [real]

    # group each read's chains by side
    side_chains: list[list[int]] = [[] for _ in sides]
    per_read: list[list[int | None]] = []  # read -> chain_idx per side
    for rep in pile_up:
        row: list[int | None] = [None] * len(sides)
        for part in rep.parts:
            ch = ctx.chains[part.chain_idx]
            for si, node in enumerate(sides):
                if ch.a_id == node[0]:
                    row[si] = part.chain_idx
                    side_chains[si].append(part.chain_idx)
        per_read.append(row)

    # crop points
    crop: list[int] = []
    for si, node in enumerate(sides):
        contig_id, part = node
        p = _common_trace_point(
            ctx, side_chains[si], contig_id, _side_seed(part), repeats,
            int(ctx.contig_lengths[contig_id - 1]),
        )
        if p is None:
            log_json("warn", event="pileUpSkipped", reason="noCommonTracePoint",
                     node=list(node))
            return None
        crop.append(p)

    # crop + orient reads
    cropped: list[np.ndarray] = []
    read_ids: list[int] = []
    two_anchored: list[int] = []
    start_node = sides[0]
    part1 = start_node[1]
    for rep, row in zip(pile_up, per_read):
        k1 = row[0]
        if k1 is None:
            # merged-extension read anchored only on the entering side —
            # it would cover a *suffix* of the consensus template, which
            # the prefix-anchored consensus cannot place; skip it.
            continue
        ch1 = ctx.chains[k1]
        read_codes = reads.get(ch1.b_id)
        flip = bool(ch1.complement) != (part1 == ContigPart.BEGIN)

        def norm_coord(k, p_ref):
            """Reference coord → normalized read coord via trace points."""
            ch = ctx.chains[k]
            b = _translate_chain(ctx.las, ch, p_ref)
            if b is None:
                return None
            fwd = len(read_codes) - b if ch.complement else b
            return len(read_codes) - fwd if flip else fwd

        n1 = norm_coord(k1, crop[0])
        if n1 is None:
            continue
        oriented = reverse_complement(read_codes) if flip else read_codes
        if is_gap and row[1] is not None:
            n2 = norm_coord(row[1], crop[1])
            if n2 is None or n2 <= n1:
                continue
            cropped.append(oriented[n1:n2])
            two_anchored.append(len(cropped) - 1)
        else:
            # extension pile-up, or a merged-extension read anchored on
            # the leaving side: prefix read reaching into the gap
            cropped.append(oriented[n1:])
        read_ids.append(ch1.b_id)

    if is_gap and two_anchored:
        # one-anchored reads in a gap pile-up keep only the prefix the
        # gap-spanning template can cover: their tails cannot vote and
        # would force read buckets (and band slopes) far beyond the
        # template length
        bound = max(len(cropped[i]) for i in two_anchored)
        bound += bound // 4 + 2 * TRACE_SPACING
        cropped = [r if i in set(two_anchored) else r[:bound]
                   for i, r in enumerate(cropped)]

    if not cropped or (len(cropped) == 1 and not cfg.allow_single_reads):
        log_json("warn", event="pileUpSkipped", reason="tooFewCroppedReads",
                 n=len(cropped), start=list(start), end=list(end))
        return None

    # support patches (anchor shorter than min_anchor_length)
    pre, post = _support_patches(sides, crop, contigs, ctx, cfg)
    if len(pre) or len(post):
        cropped = [np.concatenate([pre, r, post]) for r in cropped]

    order = sorted(range(len(cropped)), key=lambda i: len(cropped[i]))
    median_idx = order[len(order) // 2]
    return _Prepared(cropped, read_ids, sides, is_gap, start, end, median_idx)


def _splice(prep: _Prepared, cons, contigs: SeqStore,
            cfg: ProcessConfig) -> Insertion | None:
    """Locate each contig's gap-facing edge anchor in the consensus and cut
    the insertion out (``getInsertionAlignment``, ``package.d:699-769``)."""
    sides, is_gap = prep.sides, prep.is_gap
    seq = cons.sequence
    if len(seq) == 0:
        log_json("warn", event="pileUpSkipped", reason="emptyConsensus")
        return None

    q: list[tuple[int, int, int]] = []
    for si, node in enumerate(sides):
        contig_id, part = node
        cseq = contigs.get(contig_id)
        probe = cfg.anchor_probe
        if si == 0:
            anchor = cseq[-probe:] if part == ContigPart.END else reverse_complement(cseq[:probe])
        else:
            anchor = cseq[:probe] if part == ContigPart.BEGIN else reverse_complement(cseq[-probe:])
        loc = _locate_anchor(seq, anchor, cfg.anchor_max_edits)
        if loc is AMBIGUOUS:
            # the contig edge recurs inside the consensus (repeat copy):
            # splicing at either site could be wrong — skip, never guess
            log_json("warn", event="pileUpSkipped",
                     reason="ambiguousFlankAnchor", node=list(node))
            return None
        if loc is None:
            log_json("warn", event="pileUpSkipped", reason="flankAnchorNotFound",
                     node=list(node))
            return None
        if loc[2] / max(len(anchor), 1) > cfg.max_insertion_error:
            log_json("warn", event="pileUpSkipped", reason="insertionError",
                     error=loc[2] / len(anchor))
            return None
        q.append(loc)

    if is_gap:
        q1, q2 = q[0][1], q[1][0]
        err = max(q[0][2], q[1][2]) / max(cfg.anchor_probe, 1)
        if q2 < q1:
            # The consensus implies the flank contigs overlap: the entering
            # contig's gap-facing edge lies (q1 - q2) bases before the
            # leaving contig's edge.  The reference crops the contigs at
            # the overlap boundaries instead of dropping the join
            # (``processPileUps/package.d:621-769``, ``insertions.d:107-284``);
            # here the entering flank is trimmed by the overlap and the
            # insertion is empty.
            overlap = q1 - q2
            entering_len = int(len(contigs.get(sides[1][0])))
            if overlap >= entering_len - cfg.anchor_probe:
                log_json("warn", event="pileUpSkipped",
                         reason="contigFullyCropped", overlap=overlap,
                         start=list(prep.start), end=list(prep.end))
                return None
            log_json("info", event="contigsOverlapCropped", overlap=overlap,
                     start=list(prep.start), end=list(prep.end))
            return Insertion(sides[0], sides[1], np.empty(0, np.uint8),
                             prep.read_ids, error=err,
                             n_reads=len(prep.cropped),
                             crop_end_node=overlap)
        ins_seq = seq[q1:q2]
        return Insertion(sides[0], sides[1], ins_seq, prep.read_ids, error=err,
                         n_reads=len(prep.cropped))
    else:
        q1 = q[0][1]
        ins_seq = seq[q1:]
        contig_id, part = sides[0]
        trans = (contig_id, ContigPart.POST if part == ContigPart.END else ContigPart.PRE)
        err = q[0][2] / max(cfg.anchor_probe, 1)
        return Insertion(sides[0], trans, ins_seq, prep.read_ids, error=err,
                         n_reads=len(prep.cropped))


def _support_patches(sides, crop, contigs, ctx, cfg):
    """Contig-sequence patches when the anchor beyond the crop point is
    short (``fetchSupportPatches``, ``cropper.d:222-261``)."""
    pre = np.empty(0, dtype=np.uint8)
    post = np.empty(0, dtype=np.uint8)
    for si, node in enumerate(sides):
        contig_id, part = node
        cseq = contigs.get(contig_id)
        L = len(cseq)
        p = crop[si]
        if part == ContigPart.END:
            anchor_len = L - p
            patch = cseq[max(0, L - cfg.min_anchor_length) : p]
        else:
            anchor_len = p
            patch = cseq[p : cfg.min_anchor_length]
        if anchor_len >= cfg.min_anchor_length or len(patch) == 0:
            continue
        if si == 0:
            # leaving side: patch precedes the crop point in walk orientation
            pre = patch if part == ContigPart.END else reverse_complement(patch)
        else:
            # entering side: patch follows the crop point in walk orientation
            post = patch if part == ContigPart.BEGIN else reverse_complement(patch)
    return pre, post


def _translate_chain(las: LocalAlignmentSet, ch, a_coord: int) -> int | None:
    """Translate an A coordinate to B via the chain's trace points.

    Uses the LA of the chain whose A span contains the coordinate.
    """
    for i in ch.indices:
        if las.a_begin[i] <= a_coord <= las.a_end[i]:
            _, b = las.translate_a_to_b(int(i), a_coord)
            return int(b)
    # coordinate in a chain gap: use nearest LA boundary
    best, bestd = None, None
    for i in ch.indices:
        for a_ref, b_ref in ((int(las.a_begin[i]), int(las.b_begin[i])),
                             (int(las.a_end[i]), int(las.b_end[i]))):
            d = abs(a_ref - a_coord)
            if bestd is None or d < bestd:
                bestd, best = d, b_ref + (a_coord - a_ref)
    return best


def process_pile_up(
    pile_up: list[ReadAlignmentRep],
    ctx: ChainCtx,
    contigs: SeqStore,
    reads: SeqStore,
    repeats: Region,
    cfg: ProcessConfig,
) -> Insertion | None:
    """Produce the insertion for one pile-up, or None (with logged reason)."""
    out = process_pile_ups([pile_up], ctx, contigs, reads, repeats, cfg)
    return out[0] if out else None


def process_pile_ups(
    pile_ups: list[list[ReadAlignmentRep]],
    ctx: ChainCtx,
    contigs: SeqStore,
    reads: SeqStore,
    repeats: Region,
    cfg: ProcessConfig | None = None,
    batch: tuple[int, int] | None = None,
    group=None,
) -> list[Insertion]:
    """Process pile-ups (optionally a ``--batch from..to`` slice).

    Consensus runs BATCHED across pile-ups — one set of bucketed device
    dispatches per realign round serves every pile-up (the reference
    thread-parallelizes pile-ups, ``processPileUps/package.d:146-159``).
    With a data-parallel ``group`` consensus lanes split over its ranks
    with gathered results — the equivalent of the reference's
    ``--batch`` cluster slices + ``merge-insertions``
    (``snakemake/Snakefile:1315-1358``).  On splice
    failure a pile-up's consensus is retried with the next QV-ranked
    reference-read candidate as the template
    (``findReferenceReadCandidates`` + retry, ``package.d:518-619``);
    per-pile-up failures are contained with logged reasons; device
    errors are not contained.
    """
    cfg = cfg or ProcessConfig()
    lo, hi = batch if batch else (0, len(pile_ups))

    from ..utils.prof import prof

    prepared: list[_Prepared] = []
    for i in range(lo, min(hi, len(pile_ups))):
        singular_ok = cfg.allow_single_reads and len(pile_ups[i]) == 1
        if len(pile_ups[i]) < cfg.min_reads_per_pile_up and not singular_ok:
            log_json("warn", event="pileUpSkipped", reason="minReadsPerPileUp",
                     pileUpId=i, numReads=len(pile_ups[i]))
            continue
        try:
            with prof("process.prepare"):
                prep = _prepare_pile_up(pile_ups[i], ctx, contigs, reads,
                                        repeats, cfg)
        except DEVICE_ERRORS:
            raise
        except Exception as exc:  # per-pile-up containment (reference behavior)
            log_json("warn", event="pileUpSkipped", reason="exception",
                     error=str(exc), pileUp=i)
            prep = None
        if prep is not None:
            prepared.append(prep)

    insertions: list[Insertion] = []
    pending = list(range(len(prepared)))
    tmpl_idx: dict[int, int] = {k: prepared[k].median_idx for k in pending}
    tried: dict[int, set] = {k: {prepared[k].median_idx} for k in pending}
    for attempt in range(cfg.max_consensus_retries + 1):
        if not pending:
            break
        try:
            conss = consensus_batch(
                [prepared[k].cropped for k in pending],
                rounds=cfg.consensus_rounds, W=cfg.band_width,
                template_idxs=[tmpl_idx[k] for k in pending],
                tie_policy=cfg.consensus_tie_policy, group=group,
            )
        except DEVICE_ERRORS:
            raise
        except Exception as exc:
            # containment fallback: batch failed — run pile-ups one by one.
            # The fallback hides order-of-magnitude perf cliffs, so strict
            # mode (tests) re-raises instead.
            if os.environ.get("DENTIST_TPU_STRICT"):
                raise
            log_json("warn", event="consensusBatchFailed", error=str(exc))
            conss = []
            for k in pending:
                try:
                    conss.append(consensus_batch(
                        [prepared[k].cropped], rounds=cfg.consensus_rounds,
                        W=cfg.band_width, template_idxs=[tmpl_idx[k]],
                        tie_policy=cfg.consensus_tie_policy)[0])
                except DEVICE_ERRORS:
                    raise
                except Exception as exc2:
                    log_json("warn", event="pileUpSkipped", reason="exception",
                             error=str(exc2))
                    conss.append(None)

        retry: list[int] = []
        for k, cons in zip(pending, conss):
            if cons is None:
                continue
            try:
                with prof("process.splice"):
                    ins = _splice(prepared[k], cons, contigs, cfg)
            except DEVICE_ERRORS:
                raise
            except Exception as exc:
                log_json("warn", event="pileUpSkipped", reason="exception",
                         error=str(exc))
                continue
            if ins is not None:
                insertions.append(ins)
                continue
            # QV-ranked reference-read retry
            if attempt < cfg.max_consensus_retries:
                ranked = rank_reference_reads(cons.win_diffs, cons.read_spans)
                nxt = next((int(r) for r in ranked if int(r) not in tried[k]), None)
                if nxt is not None:
                    tmpl_idx[k] = nxt
                    tried[k].add(nxt)
                    retry.append(k)
                    log_json("info", event="consensusRetry",
                             templateRead=prepared[k].read_ids[nxt],
                             attempt=attempt + 1)
        pending = retry

    log_json("info", event="processPileUps", numPileUps=hi - lo,
             numInsertions=len(insertions))
    insertions.sort(key=lambda x: (x.start_node, x.end_node))
    return insertions
