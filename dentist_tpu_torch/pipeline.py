"""The end-to-end gap-closing pipeline — the Snakemake workflow replacement.

Port of ``dentist_tpu/pipeline.py``: the same stages, calling the port's
tandem mask, aligner, mapper, collect and process stages, which run on
the device chosen with :func:`dentist_tpu_torch.device.set_device`.

One in-process run replaces the reference's 43-rule DAG
(``snakemake/Snakefile:924-1532``), preserving its stage structure:

1. dust + tandem masks on the assembly,
2. masked self-alignment → coverage repeat mask (``dentist mask``),
3. masked read mapping → reads repeat mask, mask homogenization
   (assembly→reads→assembly propagation round trip, ``Snakefile:1218-1287``),
4. collect pile-ups → process (consensus) → insertions,
5. preliminary output,
6. second pass (unless disabled): re-map reads to the preliminary
   assembly, validate closed-gap regions (coverage + spanning reads),
   derive the skip-gaps list from invalid regions (``skip_gaps.py``),
7. final purged output (FASTA + AGP + BED).

All intermediate state stays in memory; ``workdir`` (optional) persists
the stage artifacts in the framework's container formats for inspection
and restart — the checkpoint/resume model of the reference, where "the
filesystem is the checkpoint" (SURVEY §5).

When the environment describes a process group
(:func:`dentist_tpu_torch.parallel.dp.default_group`), the pipeline
joins it and every alignment and consensus dispatch splits its lanes
over the ranks.  Every rank computes the same result; rank 0 alone
writes the output files, the event log and the checkpoints, and a
resumed run on every rank follows the checkpoints rank 0 finds (the
workdir must be on a filesystem every rank sees).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .io.fasta import FastaRecord
from .models.alignments import TRACE_SPACING
from .models.mask import (
    coverage_mask,
    dust_mask,
    pack_chain_intervals,
    propagate_mask,
    propagate_mask_b_to_a,
    repeat_coverage_bounds_improper,
    repeat_coverage_bounds_reads,
    tandem_mask,
    validation_min_coverage,
)
from .models.output import OutputConfig, build_output, write_output
from .models.pileups import ChainCtx, CollectConfig, collect_pile_ups
from .models.process import ProcessConfig, process_pile_ups
from .models.sequences import (SeqStore, load_assembly, load_reads,
                               split_scaffolds)
from .models.validate import ValidateConfig, validate_regions
from .ops.aligner import AlignerConfig, align_store_pair
from .ops.mapper import MapperConfig, map_reads
from .parallel.dp import barrier, default_group
from .utils.log import (STAGE_SECONDS, log_json,  # noqa: F401
                        reset_stage_seconds, trace_execution)
from .utils.regions import Region


def _chain_spans(las, chains):
    """Per-chain (a_begin, a_end, b_begin, b_end, a_id, b_id) arrays.

    One pass of attribute gathers replacing per-chain ``first_last``
    method calls in the pipeline's host scans (round-4 verdict: these
    loops surface at the reference's "few 100 Mbp" scale)."""
    n = len(chains)
    f = np.fromiter((ch.indices[0] for ch in chains), np.int64, n)
    g = np.fromiter((ch.indices[-1] for ch in chains), np.int64, n)
    aid = np.fromiter((ch.a_id for ch in chains), np.int64, n)
    bid = np.fromiter((ch.b_id for ch in chains), np.int64, n)
    return (las.a_begin[f].astype(np.int64), las.a_end[g].astype(np.int64),
            las.b_begin[f].astype(np.int64), las.b_end[g].astype(np.int64),
            aid, bid)

__all__ = ["PipelineConfig", "run_pipeline", "close_gaps"]


@dataclass
class PipelineConfig:
    read_coverage: float | None = None
    max_coverage_self: int = 4
    min_spanning_reads: int = 3
    min_anchor_length: int = 500
    join_policy: str = "scaffoldGaps"
    max_insertion_error: float = 0.1
    no_validation: bool = False
    allow_single_reads: bool = False
    workdir: str | None = None
    ploidy: int = 1
    # collect/process knobs (reference: collect-pile-ups/process-pile-ups
    # options the workflow config drives, ``snakemake/Snakefile:686-753``)
    max_alignment_error: float = 0.3
    best_pileup_margin: float = 3.0
    existing_gap_bonus: float = 6.0
    #: None = the reference's default: follow min_spanning_reads
    #: (``commandline.d:2131-2136``)
    min_reads_per_pile_up: int | None = None
    proper_allowance: int = 126
    #: with ``workdir``: reuse stage artifacts from a previous run on the
    #: same inputs (the reference's "execute the same command again to
    #: continue", README Usage; ``Snakefile:193-229`` checkpoint DAG)
    resume: bool = True


@trace_execution
def run_pipeline(assembly_path, reads_path, out_path, cfg: PipelineConfig | None = None):
    cfg = cfg or PipelineConfig()
    writer = _is_writer(default_group())
    if cfg.workdir and writer:  # persist the event log for lost-gaps analysis
        from .utils.log import tee_log_file

        os.makedirs(cfg.workdir, exist_ok=True)
        tee_log_file(os.path.join(cfg.workdir, "pipeline.log"))
    contigs, structure = load_assembly(assembly_path)
    reads = load_reads(reads_path)
    read_list = [reads.get(i + 1) for i in range(len(reads))]
    if cfg.read_coverage is None:
        cfg.read_coverage = reads.total_length / max(contigs.total_length, 1)
        log_json("info", event="derivedReadCoverage", coverage=round(cfg.read_coverage, 2))

    result = close_gaps(contigs, structure, reads, read_list, cfg)
    if writer:
        agp = os.path.splitext(out_path)[0] + ".agp"
        bed = os.path.splitext(out_path)[0] + ".closed-gaps.bed"
        write_output(result, out_path, agp_path=agp, bed_path=bed)
    log_json("info", event="pipelineDone", out=out_path,
             numClosedGaps=result.n_closed_gaps)
    return result


def _is_writer(group) -> bool:
    """Whether this process writes files: rank 0 of a group, or a
    process outside one."""
    return group is None or group.rank == 0


@trace_execution
def masks_for(contigs: SeqStore, read_list, cfg: PipelineConfig,
              reads_store: SeqStore | None = None):
    """Stages 1-3: dust, tandem, self-repeat, reads-repeat, homogenized.

    Under a process group the self-alignment and read-mapping dispatches
    split over the ranks (the reference's per-block Snakemake jobs,
    ``Snakefile:998-1037,1143-1170``)."""
    group = default_group()
    c, o, l = contigs.codes, contigs.offsets, contigs.lengths
    # dust is host-CPU, tandem is device-bound: true overlap
    from concurrent.futures import ThreadPoolExecutor

    with trace_execution("masks.dust+tandem"):
        with ThreadPoolExecutor(max_workers=2) as ex:
            tan_f = ex.submit(tandem_mask, c, o, l)
            dust = dust_mask(c, o, l)
            tan = tan_f.result()
    with trace_execution("masks.selfAlignment"):
        # stride-4 seeding: repeat discovery needs ~tens of seeds/kb at
        # ≥500 bp / ≤30 % divergence, which stride 4 retains with 4×
        # headroom (k=14 at 15 % divergence still yields ~25 seeds/kb);
        # halves the dominant host cost of the self-alignment scan
        self_las = align_store_pair(
            c, o, l, [contigs.get(i + 1) for i in range(len(contigs))],
            config=AlignerConfig(query_stride=4), self_alignment=True,
            mask_intervals=(dust | tan).iv,
            query_store=(contigs.codes, contigs.offsets), group=group,
        )
    self_las.check_invariants()  # contracts on in production (dub.sdl:26-28)
    self_mask = coverage_mask(pack_chain_intervals(self_las), l, 0, cfg.max_coverage_self)
    repeats = self_mask | tan

    with trace_execution("masks.mapReads"):
        las, chains = map_reads(
            c, o, l, read_list, config=MapperConfig(),
            mask_intervals=(dust | repeats).iv,
            query_store=(reads_store.codes, reads_store.offsets)
            if reads_store is not None else None, group=group,
        )
    las.check_invariants()
    _, hi_reads = repeat_coverage_bounds_reads(cfg.read_coverage)
    reads_mask = coverage_mask(pack_chain_intervals(las), l, 0, hi_reads)
    # improper-coverage mask: regions where chains that do NOT properly
    # reach a sequence end pile up (maskRepetitiveRegions.d improperOnly).
    # Vectorized over the chain arrays — the per-chain Python loop was
    # O(chains) method calls per run, which surfaces at genome scale.
    read_lengths = np.array([len(r) for r in read_list], dtype=np.int64)
    ab, ae, bb, be, aid, bid = _chain_spans(las, chains)
    allow = np.int64(TRACE_SPACING)
    proper = (((ab <= allow) | (bb <= allow))
              & ((ae >= l[aid - 1] - allow)
                 | (be >= read_lengths[bid - 1] - allow)))
    improper_iv = np.stack(
        [aid[~proper], ab[~proper], ae[~proper]], axis=1)
    _, hi_improper = repeat_coverage_bounds_improper(cfg.read_coverage)
    improper_mask = coverage_mask(
        improper_iv.reshape(-1, 3), l, 0, hi_improper)
    repeats = repeats | reads_mask | improper_mask

    # homogenization round trip (mask-H): assembly → reads → assembly
    with trace_execution("masks.homogenize"):
        on_reads = propagate_mask(repeats, las, read_lengths)
        homogenized = repeats | propagate_mask_b_to_a(on_reads, las, l,
                                                      read_lengths)
    return dust, repeats, homogenized, las, chains


@trace_execution
def close_gaps(contigs, structure, reads: SeqStore, read_list, cfg: PipelineConfig):
    resume = _ResumeState(cfg, contigs, reads, structure, default_group())
    loaded = resume.load_masks()
    if loaded is not None:
        dust, repeats, homogenized, las, chains = loaded
    else:
        dust, repeats, homogenized, las, chains = masks_for(
            contigs, read_list, cfg, reads_store=reads)
        _checkpoint(cfg, masks={"dust": dust, "repeats": repeats,
                                "repeats-H": homogenized}, las=(las, chains))

    ctx = ChainCtx(las, chains, contigs.lengths, reads.lengths)
    collect_cfg = CollectConfig(
        max_alignment_error=cfg.max_alignment_error,
        proper_allowance=cfg.proper_allowance,
        min_anchor_length=cfg.min_anchor_length,
        best_pileup_margin=cfg.best_pileup_margin,
        existing_gap_bonus=cfg.existing_gap_bonus,
        min_spanning_reads=cfg.min_spanning_reads,
    )
    pile_ups = resume.load_pile_ups()
    if pile_ups is None:
        with trace_execution("stage.collect"):
            pile_ups = collect_pile_ups(ctx, structure.gaps, homogenized,
                                        collect_cfg, contigs=contigs,
                                        reads=reads)
        _checkpoint(cfg, pile_ups=pile_ups)
    insertions = resume.load_insertions()
    if insertions is None:
        with trace_execution("stage.process"):
            insertions = process_pile_ups(
                pile_ups, ctx, contigs, reads, homogenized,
                ProcessConfig(allow_single_reads=cfg.allow_single_reads,
                              max_insertion_error=cfg.max_insertion_error,
                              min_anchor_length=cfg.min_anchor_length,
                              # the reference defaults minReadsPerPileUp to
                              # defaultMinSpanningReads (commandline.d:2131-2136)
                              min_reads_per_pile_up=(
                                  cfg.min_reads_per_pile_up
                                  if cfg.min_reads_per_pile_up is not None
                                  else cfg.min_spanning_reads)),
                group=default_group(),
            )
        _checkpoint(cfg, insertions=insertions)
    out_cfg = OutputConfig(join_policy=cfg.join_policy,
                           max_insertion_error=cfg.max_insertion_error)
    with trace_execution("stage.output"):
        result = build_output(contigs, structure, insertions, out_cfg)

    if cfg.no_validation:
        return result

    # ---- second pass: validate closed gaps on the preliminary assembly
    skip = resume.load_validation()
    if skip is None:
        skip = _validation_pass(result, read_list, reads, cfg,
                                primary=(las, chains, contigs.lengths,
                                         insertions))
        resume.save_validation(skip)
    if skip:
        out_cfg.skip_gaps = skip
        result = build_output(contigs, structure, insertions, out_cfg)
    return result


@trace_execution
def _validation_pass(result, read_list, reads: SeqStore, cfg: PipelineConfig,
                     primary=None):
    """Re-map reads to the preliminary assembly and validate closed gaps.

    Returns the skip-gaps set (pairs of input contig ids) for invalid
    regions (``Snakefile:1380-1493`` + ``skip_gaps.py``).

    ``primary`` (las, chains, contig_lengths, insertions) prefilters the
    re-mapped read set: validation regions are gap ± ``pad``, so only
    reads whose primary chain reaches within ``pad`` of a contig end,
    unmapped reads (they may align across a now-closed gap), and the
    insertions' supporting reads can contribute evidence — interior
    reads (the large majority at genome scale) cannot and are skipped.
    This also matches the reference's semantics more closely than
    re-mapping everything against gap sub-stores: damapper competes a
    read's placements genome-wide (``-n`` best chains), so a repeat read
    whose best placement is interior never votes in a gap region.
    """
    prelim_records = [FastaRecord(h, _str_codes(s)) for h, s in result.records]
    prelim, prelim_structure = split_scaffolds(prelim_records)
    if len(prelim) == 0 or not result.bed_rows:
        return set()

    # closed-gap regions on preliminary contigs (bed2mask semantics).
    # Contig lookup per BED row is a vectorized mask over the contig
    # arrays (the per-row Python walk over every contig was
    # O(rows x contigs) — round-4 verdict host-scan item).
    name_to_sid = {h.split("\t")[0]: i for i, h in enumerate(prelim_structure.headers)}
    pcs = prelim_structure.contigs
    c_sid = np.fromiter((c.scaffold_id for c in pcs), np.int64, len(pcs))
    c_beg = np.fromiter((c.begin for c in pcs), np.int64, len(pcs))
    c_end = np.fromiter((c.end for c in pcs), np.int64, len(pcs))
    triples = []
    region_ids = {}
    for row in result.bed_rows:
        name, b, e, data = row.split("\t")
        b, e = int(b), int(e)
        sid = name_to_sid.get(name)
        if sid is None:
            continue
        pair = None
        for field in data.split(";"):
            if field.startswith("contigIds="):
                a_, b_ = field.split("=")[1].split("-")
                pair = (int(a_), int(b_))
        for ci in np.flatnonzero((c_sid == sid) & (c_beg < e) & (b < c_end)):
            c = pcs[ci]
            tb, te = max(0, b - c.begin), min(c.length, e - c.begin)
            triples.append((c.global_contig_id, tb, te))
            region_ids[(c.global_contig_id, tb, te)] = pair
    if not triples:
        return set()

    # Re-map against gap-region *sub-stores* instead of the whole
    # preliminary assembly: validation only needs local coverage and
    # spanning evidence around each closed gap, and most reads (no
    # seeds in the sub-index) are rejected at the lookup stage.
    # NB: iterate the raw per-BED-row triples (no Region normalization):
    # adjacent closed-gap intervals on one contig must NOT merge, or the
    # interval→contig-id-pair association is lost and purging is skipped.
    pad = 25_000
    # candidate-read prefilter from the primary mapping (see docstring)
    val_reads = read_list
    val_ids = None
    if primary is not None:
        p_las, p_chains, contig_lens, p_insertions = primary
        n_reads = len(read_list)
        near_end = np.zeros(n_reads + 1, dtype=bool)
        has_chain = np.zeros(n_reads + 1, dtype=bool)
        slack = 5_000
        ab, ae, _bb, _be, aid, bid = _chain_spans(p_las, p_chains)
        has_chain[bid] = True
        a_len = np.asarray(contig_lens, dtype=np.int64)[aid - 1]
        near = (ae > a_len - pad - slack) | (ab < pad + slack)
        near_end[bid[near]] = True
        keep = near_end.copy()
        keep[1:] |= ~has_chain[1 : n_reads + 1]  # unmapped: may span a closed gap
        for ins in p_insertions:
            for rid in ins.read_ids:
                if rid <= n_reads:
                    keep[rid] = True
        val_ids = [i + 1 for i in range(n_reads) if keep[i + 1]]
        val_reads = [read_list[i - 1] for i in val_ids]
        log_json("info", event="validationReadPrefilter",
                 nCandidates=len(val_ids), nReads=n_reads)
    sub_seqs, sub_regions, sub_region_ids = [], [], {}
    for (cid, b, e), pair in [((int(t), int(bb), int(ee)), region_ids.get((int(t), int(bb), int(ee))))
                              for t, bb, ee in triples]:
        contig_seq = prelim.get(cid)
        lo = max(0, b - pad)
        hi = min(len(contig_seq), e + pad)
        sub_seqs.append(contig_seq[lo:hi])
        sid = len(sub_seqs)  # 1-based sub-contig id
        sub_regions.append((sid, b - lo, e - lo))
        sub_region_ids[(sid, b - lo, e - lo)] = pair
    sub_lens = np.array([len(s) for s in sub_seqs], dtype=np.int64)
    sub_offs = np.concatenate([[0], np.cumsum(sub_lens)])[:-1]
    sub_codes = np.concatenate(sub_seqs)
    p_dust = dust_mask(sub_codes, sub_offs, sub_lens)
    p_tan = tandem_mask(sub_codes, sub_offs, sub_lens)
    from .ops.aligner import AlignerConfig

    p_las, p_chains = map_reads(
        sub_codes, sub_offs, sub_lens, val_reads, read_ids=val_ids,
        # stride-4 seeding: validation needs coverage/spanning EVIDENCE
        # (20× deep regions, thresholds far from the margin), not
        # maximal sensitivity — ~45 seeds/kb at stride 3 leaves 3×
        # headroom over the density floor even at stride 4
        config=MapperConfig(aligner=AlignerConfig(max_candidates=12,
                                                  query_stride=4)),
        mask_intervals=(p_dust | p_tan).iv,
        group=default_group(),
        # the resident read store is already on device from the primary
        # mapping; validation ids index the same store
        query_store=(reads.codes, reads.offsets) if val_ids else None,
    )
    p_las.check_invariants()  # contracts on in production (dub.sdl:26-28)
    vcfg = ValidateConfig(
        min_coverage_reads=validation_min_coverage(cfg.read_coverage, cfg.ploidy),
        min_spanning_reads=cfg.min_spanning_reads,
    )
    reports, _weak = validate_regions(
        p_las, p_chains, Region.from_triples(sub_regions), sub_lens,
        reads.lengths, vcfg, region_contig_ids=sub_region_ids,
    )
    skip = set()
    for r in reports:
        if not r.is_valid and r.contig_ids:
            log_json("warn", event="gapPurged", contigIds=list(r.contig_ids),
                     numSpanning=r.n_spanning, weakWindows=len(r.weak_windows))
            skip.add(tuple(sorted(r.contig_ids)))
    return skip


#: the stage artifacts a workdir holds besides ``manifest.json``
_ARTIFACTS = ("dust.mask.npz", "repeats.mask.npz", "repeats-H.mask.npz",
              "reads.las.npz", "pile-ups.npz", "insertions.npz",
              "validation.json")


class _ResumeState:
    """Stage-artifact reuse from a previous run's ``workdir``.

    The reference's headline restart behavior — "If something fails, you
    can execute the same command again [and it] will continue"
    (the reference's ``README.md``, Usage) — rests on Snakemake's
    checkpoint DAG re-evaluation (``snakemake/Snakefile:193-229``): a
    rule re-runs only when its inputs are newer than its outputs.  Here
    the equivalent guard is a content fingerprint: ``manifest.json``
    records a hash of the assembly, the reads, and every
    computation-affecting config field; artifacts are reused ONLY when
    the stored fingerprint matches the current inputs, so a changed
    FASTA or option can never silently reuse stale state.

    Under a process group rank 0 alone checks the manifest, removes stale
    artifacts and writes the manifest; the other ranks wait for it, then
    read the same manifest.  Every rank decides from the artifacts that
    exist then (``present``), so artifacts rank 0 writes during the run
    change no rank's path.
    """

    def __init__(self, cfg: PipelineConfig, contigs, reads, structure=None,
                 group=None):
        import hashlib
        import json as _json

        self.dir = cfg.workdir if (cfg.workdir and cfg.resume) else None
        self.valid = False
        self.present: set = set()
        self.writer = writer = _is_writer(group)
        if not cfg.workdir:
            return
        if writer:
            os.makedirs(cfg.workdir, exist_ok=True)
        h = hashlib.blake2b(digest_size=16)
        for arr in (contigs.codes, contigs.lengths, reads.codes, reads.lengths):
            h.update(np.ascontiguousarray(arr).tobytes())
        if structure is not None:
            # the scaffold structure (gap positions/sizes, contig->scaffold
            # grouping) drives collect and output; contig codes alone do
            # not capture a changed N-run length
            for g in structure.gaps:
                h.update(np.asarray(
                    [g.begin_global_contig_id, g.end_global_contig_id,
                     g.scaffold_id, g.begin, g.end], np.int64).tobytes())
            for c in structure.contigs:
                h.update(np.asarray(
                    [c.scaffold_id, c.begin, c.end], np.int64).tobytes())
        for f in ("read_coverage", "max_coverage_self", "min_spanning_reads",
                  "min_anchor_length", "join_policy", "max_insertion_error",
                  "allow_single_reads", "ploidy", "max_alignment_error",
                  "best_pileup_margin", "existing_gap_bonus",
                  "min_reads_per_pile_up", "proper_allowance"):
            h.update(repr(getattr(cfg, f)).encode())
        self.token = h.hexdigest()
        mpath = os.path.join(cfg.workdir, "manifest.json")

        def manifest_valid() -> bool:
            try:
                with open(mpath) as fh:
                    return _json.load(fh).get("fingerprint") == self.token
            except (OSError, ValueError):
                return False

        if self.dir and writer:
            self.valid = manifest_valid()
        if writer and not self.valid:
            # inputs or options changed (or resume disabled): stale
            # artifacts must not mix with the fresh ones this run's
            # checkpoints write (pile-ups index into their own run's las),
            # and the manifest must describe THIS run's artifacts so a
            # later resumed run cannot adopt mismatched state
            for name in _ARTIFACTS:
                try:
                    os.remove(os.path.join(cfg.workdir, name))
                except OSError:
                    pass
            with open(mpath, "w") as fh:
                _json.dump({"fingerprint": self.token}, fh)
        barrier(group)
        if self.dir and not writer:
            self.valid = manifest_valid()
        if self.valid:
            self.present = {n for n in _ARTIFACTS
                            if os.path.exists(os.path.join(self.dir, n))}
        barrier(group)  # every rank has looked before rank 0 writes more

    def _have(self, *names) -> bool:
        return self.valid and all(n in self.present for n in names)

    def load_masks(self):
        if not self._have("dust.mask.npz", "repeats.mask.npz",
                          "repeats-H.mask.npz", "reads.las.npz"):
            return None
        from .io.store import load_alignments, load_mask

        with trace_execution("resume.masks"):
            dust = load_mask(os.path.join(self.dir, "dust.mask.npz"))
            repeats = load_mask(os.path.join(self.dir, "repeats.mask.npz"))
            homog = load_mask(os.path.join(self.dir, "repeats-H.mask.npz"))
            las, chains = load_alignments(os.path.join(self.dir, "reads.las.npz"))
        log_json("info", event="resumeStage", stage="masks+mapping")
        return dust, repeats, homog, las, chains

    def load_pile_ups(self):
        if not self._have("pile-ups.npz"):
            return None
        from .io.store import load_pile_ups

        pile_ups = load_pile_ups(os.path.join(self.dir, "pile-ups.npz"))
        log_json("info", event="resumeStage", stage="collect",
                 numPileUps=len(pile_ups))
        return pile_ups

    def load_insertions(self):
        if not self._have("insertions.npz"):
            return None
        from .io.store import load_insertions

        insertions = load_insertions(os.path.join(self.dir, "insertions.npz"))
        log_json("info", event="resumeStage", stage="process",
                 numInsertions=len(insertions))
        return insertions

    def load_validation(self):
        import json as _json

        if not self._have("validation.json"):
            return None
        with open(os.path.join(self.dir, "validation.json")) as fh:
            skip = {tuple(p) for p in _json.load(fh)["skip_gaps"]}
        log_json("info", event="resumeStage", stage="validation",
                 numPurged=len(skip))
        return skip

    def save_validation(self, skip: set):
        import json as _json

        if not self.dir or not self.writer:
            return
        with open(os.path.join(self.dir, "validation.json"), "w") as fh:
            _json.dump({"skip_gaps": sorted(list(p) for p in skip)}, fh)


def _checkpoint(cfg: PipelineConfig, masks=None, las=None, pile_ups=None,
                insertions=None):
    """Persist stage artifacts to ``cfg.workdir`` (the reference's
    filesystem-is-the-checkpoint model, SURVEY §5) in the framework's
    container formats — inspectable with the ``show-*`` commands and
    reusable by the staged CLI path.  Rank 0 of a process group writes;
    the other ranks write nothing."""
    if not cfg.workdir or not _is_writer(default_group()):
        return
    from .io.store import (save_alignments, save_insertions,
                           save_mask, save_pile_ups)

    os.makedirs(cfg.workdir, exist_ok=True)
    if masks:
        for name, region in masks.items():
            save_mask(os.path.join(cfg.workdir, f"{name}.mask.npz"), region)
    if las:
        save_alignments(os.path.join(cfg.workdir, "reads.las.npz"), las[0], las[1])
    if pile_ups is not None:
        save_pile_ups(os.path.join(cfg.workdir, "pile-ups.npz"), pile_ups)
    if insertions is not None:
        save_insertions(os.path.join(cfg.workdir, "insertions.npz"), insertions)


def _str_codes(s: str) -> np.ndarray:
    from .io.fasta import seq_to_codes

    return seq_to_codes(s.lower())
