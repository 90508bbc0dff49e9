"""Command-line interface of the port.

The JAX package's CLI (``dentist_tpu/cli.py``), sub-command for
sub-command: the same names, unambiguous-prefix matching, argument
definitions, ``--config`` files with ``__default__`` sections,
``--revert``, log levels and handlers (each handler's source equals the
JAX package's, imports aside).  The handlers call the port's modules, so
the six sub-commands in :data:`DEVICE_COMMANDS` run their kernels on the
GPU: ``tandem``, ``align``, ``map`` and ``collect-pile-ups`` the
extension DP, ``process-pile-ups`` the consensus kernels, ``pipeline``
all of them.  The others run on the host and need no GPU.

:func:`main` runs the device commands on ``device`` when the Python
caller passes one (the CPU tests pass ``"cpu"``), and otherwise on this
process's card (:func:`~dentist_tpu_torch.parallel.dp.rank_device`): a
machine without a GPU refuses them.  ``python -m dentist_tpu_torch``
calls :func:`main`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import __version__
from .config import load_config, apply_config, validate_config
from .utils.log import log_json, set_log_level

COMMANDS: dict[str, callable] = {}


def command(name):
    def register(fn):
        COMMANDS[name] = fn
        return fn
    return register


ALIASES = {
    "mask": "mask-repetitive-regions",  # reference short name; `mask2bed`
    "generate": "generate-config",      # would otherwise make it ambiguous
}


def resolve_command(name: str) -> str:
    """Unambiguous-prefix command matching (``commandline.d:500-514``)."""
    if name in COMMANDS:
        return name
    if name in ALIASES and ALIASES[name] in COMMANDS:
        return ALIASES[name]
    matches = [c for c in COMMANDS if c.startswith(name)]
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise SystemExit(f"unknown command: {name!r} (see --commands)")
    raise SystemExit(f"ambiguous command {name!r}: matches {', '.join(sorted(matches))}")


def _load_assembly(path):
    from .models.sequences import load_assembly

    return load_assembly(path)


def _load_reads(path):
    from .models.sequences import load_reads

    return load_reads(path)


def _read_masks(paths):
    from .io.store import load_mask
    from .utils.regions import Region

    region = Region()
    for p in paths or []:
        region = region | load_mask(p)
    return region


# ----------------------------------------------------------------------
# masking stages


@command("dust")
def cmd_dust(args):
    """Low-complexity mask (DBdust replacement)."""
    from .io.store import save_mask
    from .models.mask import dust_mask

    store, _ = _load_assembly(args.sequences)
    mask = dust_mask(store.codes, store.offsets, store.lengths)
    save_mask(args.out_mask, mask)
    log_json("info", event="dust", intervals=len(mask), maskedBp=mask.size)


@command("tandem")
def cmd_tandem(args):
    """Tandem-repeat mask (datander + TANmask replacement)."""
    from .io.store import save_mask
    from .models.mask import tandem_mask

    store, _ = _load_assembly(args.sequences)
    mask = tandem_mask(store.codes, store.offsets, store.lengths)
    save_mask(args.out_mask, mask)
    log_json("info", event="tandem", intervals=len(mask), maskedBp=mask.size)


@command("align")
def cmd_align(args):
    """Assembly self-alignment (daligner replacement)."""
    from .io.store import save_alignments
    from .ops.aligner import AlignerConfig, align_store_pair

    store, _ = _load_assembly(args.assembly)
    masks = _read_masks(args.mask)
    las = align_store_pair(
        store.codes, store.offsets, store.lengths,
        [store.get(i + 1) for i in range(len(store))],
        config=AlignerConfig(max_error=args.max_alignment_error + 0.02,
                             min_length=args.min_anchor_length),
        mask_intervals=masks.iv if len(masks) else None,
        self_alignment=True,
    )
    save_alignments(args.out_alignments, las)


@command("map")
def cmd_map(args):
    """Read-to-assembly mapping (damapper replacement)."""
    from .io.store import save_alignments
    from .ops.mapper import MapperConfig, map_reads

    store, _ = _load_assembly(args.assembly)
    reads = _load_reads(args.reads)
    masks = _read_masks(args.mask)
    las, chains = map_reads(
        store.codes, store.offsets, store.lengths,
        [reads.get(i + 1) for i in range(len(reads))],
        config=MapperConfig(),
        mask_intervals=masks.iv if len(masks) else None,
    )
    save_alignments(args.out_alignments, las, chains)


@command("mask-repetitive-regions")
def cmd_mask(args):
    """Coverage-based repeat mask (``maskRepetitiveRegions.d``)."""
    from .io.store import load_alignments, save_mask
    from .models.mask import (
        coverage_mask, pack_chain_intervals,
        repeat_coverage_bounds_improper, repeat_coverage_bounds_reads,
    )

    store, _ = _load_assembly(args.assembly)
    las, chains = load_alignments(args.alignments)
    intervals = pack_chain_intervals(las)
    if args.reads_db:  # reads alignment
        if args.max_coverage_reads is not None and args.read_coverage is not None:
            raise SystemExit("must not provide both --read-coverage and --max-coverage-reads")
        if args.max_coverage_reads is not None:
            hi = args.max_coverage_reads
        elif args.read_coverage is not None:
            _, hi = repeat_coverage_bounds_reads(args.read_coverage)
        else:
            raise SystemExit("must provide either --read-coverage or --max-coverage-reads")
        mask = coverage_mask(intervals, store.lengths, 0, hi)
        if args.read_coverage is not None:
            _, hi_imp = repeat_coverage_bounds_improper(args.read_coverage)
            read_lengths = _load_reads(args.reads_db).lengths
            improper = _improper_intervals(las, chains, store.lengths, read_lengths)
            mask = mask | coverage_mask(improper, store.lengths, 0, hi_imp)
    else:  # self alignment
        mask = coverage_mask(intervals, store.lengths, 0, args.max_coverage_self)
    save_mask(args.out_mask, mask)
    log_json("info", event="mask", intervals=len(mask), maskedBp=mask.size)


def _improper_intervals(las, chains, contig_lengths, read_lengths):
    """A-intervals of improper chains (``maskRepetitiveRegions.d:183``).

    Uses the full two-sided properness test (``base.d:537``) — the same
    definition the in-process pipeline applies — so the staged CLI and
    ``pipeline`` paths produce identical improper-coverage masks.
    """
    out = []
    for ch in chains or []:
        a_len = int(contig_lengths[ch.a_id - 1])
        b_len = int(read_lengths[ch.b_id - 1])
        if not ch.is_proper(las, a_len, b_len):
            ab, ae, _, _ = ch.first_last(las)
            out.append((ch.a_id, ab, ae))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


@command("propagate-mask")
def cmd_propagate_mask(args):
    from .io.store import load_alignments, load_mask, save_mask
    from .models.mask import propagate_mask, propagate_mask_b_to_a

    mask = load_mask(args.mask)
    las, _ = load_alignments(args.alignments)
    reads = _load_reads(args.reads)
    if getattr(args, "direction", "assembly2reads") == "reads2assembly":
        # the homogenization return leg (``Snakefile:1218-1287``): the
        # mask is tagged by read ids, the output by assembly contig ids
        if not getattr(args, "assembly", None):
            raise SystemExit("--assembly is required with "
                             "--direction reads2assembly")
        contigs, _ = _load_assembly(args.assembly)
        out = propagate_mask_b_to_a(mask, las, contigs.lengths, reads.lengths)
    else:
        out = propagate_mask(mask, las, reads.lengths)
    save_mask(args.out_mask, out)


@command("merge-masks")
def cmd_merge_masks(args):
    from .io.store import load_mask, save_mask

    merged = _read_masks(args.masks)
    save_mask(args.out_mask, merged)


@command("filter-mask")
def cmd_filter_mask(args):
    from .io.store import load_mask, save_mask

    mask = load_mask(args.mask)
    if args.min_gap_size:
        mask = mask.close_gaps(args.min_gap_size)
    if args.min_interval_size:
        mask = mask.filter_min_size(args.min_interval_size)
    save_mask(args.out_mask, mask)


@command("show-mask")
def cmd_show_mask(args):
    from .io.store import load_mask

    mask = load_mask(args.mask)
    if args.json:
        print(json.dumps({
            "numIntervals": len(mask),
            "maskedBp": mask.size,
            "intervals": mask.iv.tolist(),
        }))
    else:
        print(f"intervals: {len(mask)}  masked bp: {mask.size}")
        for tag, b, e in mask.iv:
            print(f"  contig {tag}: {b}..{e}")


def _parse_data_comment(comment: str) -> tuple[list[int], list[int]]:
    """DENTIST BED data comment (``bed2mask.d:229``): ``|``-joined parts,
    ``contigs-<a>-<b>`` and ``reads-<id>-<id>-...``; later parts of the
    same type overwrite earlier ones."""
    contig_ids: list[int] = []
    read_ids: list[int] = []
    for part in comment.split("|"):
        fields = part.split("-")
        if fields[0] == "contigs" and len(fields) == 3:
            contig_ids = [int(fields[1]), int(fields[2])]
        elif fields[0] == "reads" and len(fields) >= 2:
            read_ids = [int(f) for f in fields[1:]]
    return contig_ids, read_ids


@command("bed2mask")
def cmd_bed2mask(args):
    from .io.store import save_mask
    from .utils.log import log_json
    from .utils.regions import Region

    store, structure = _load_assembly(args.assembly)
    name_to_sid = {h.split()[0]: i for i, h in enumerate(structure.headers)}
    triples = []
    extra_contigs: list[list[int]] = []
    extra_reads: list[list[int]] = []
    with open(args.bed) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            name, b, e = fields[0], int(fields[1]), int(fields[2])
            sid = name_to_sid.get(name)
            if sid is None:
                continue
            contig_ids, read_ids = ([], [])
            if args.data_comments and len(fields) >= 4:
                contig_ids, read_ids = _parse_data_comment(fields[3])
            # scaffold coords → contig coords
            for c in structure.contigs:
                if c.scaffold_id == sid and c.begin < e and b < c.end:
                    triples.append((c.global_contig_id,
                                    max(0, b - c.begin),
                                    min(c.length, e - c.begin)))
                    extra_contigs.append(contig_ids)
                    extra_reads.append(read_ids)
    if not args.data_comments:
        save_mask(args.out_mask, Region.from_triples(triples))
        return
    # keep the per-row interval ↔ id-list association: sort like the
    # Region normalizer and require disjoint rows (closed-gap BED rows
    # are); the id lists ride along as DazzExtra-equivalent mask extras
    iv = np.array(triples, dtype=np.int64).reshape(-1, 3)
    order = np.lexsort((iv[:, 2], iv[:, 1], iv[:, 0]))
    iv = iv[order]
    disjoint = np.all((iv[1:, 0] != iv[:-1, 0]) | (iv[1:, 1] >= iv[:-1, 2])) \
        if len(iv) > 1 else True
    if not disjoint:
        log_json("warn", event="bed2mask",
                 message="overlapping BED rows: dropping data comments")
        save_mask(args.out_mask, Region.from_triples(triples))
        return
    save_mask(args.out_mask, Region(iv, _normalized=True), extras={
        "contig_ids": [extra_contigs[i] for i in order],
        "read_ids": [extra_reads[i] for i in order],
    })


@command("mask2bed")
def cmd_mask2bed(args):
    from .io.store import load_mask

    store, structure = _load_assembly(args.assembly)
    mask = load_mask(args.mask)
    contig_by_id = {c.global_contig_id: c for c in structure.contigs}
    with open(args.out_bed, "w") as fh:
        for tag, b, e in mask.iv:
            c = contig_by_id.get(int(tag))
            if c is None:
                continue
            name = structure.headers[c.scaffold_id].split()[0]
            fh.write(f"{name}\t{c.begin + b}\t{c.begin + e}\n")


# ----------------------------------------------------------------------
# core pipeline commands


@command("chain-local-alignments")
def cmd_chain(args):
    import sys
    import time

    from .io.store import load_alignments, save_alignments
    from .ops.chain import ChainingOptions, chain_local_alignments

    las, _ = load_alignments(args.alignments)
    progress = None
    if getattr(args, "progress", False):
        # live progress reporting (the reference's --progress family,
        # docs/list-of-commandline-options.md:171-178): human = a
        # carriage-return percent meter, json = one line per tick
        every_s = max(getattr(args, "progress_every", 500), 1) / 1000.0
        fmt = getattr(args, "progress_format", "human")
        state = {"last": 0.0, "t0": time.monotonic()}

        def progress(done, total):
            now = time.monotonic()
            if now - state["last"] < every_s and done < total:
                return
            state["last"] = now
            if fmt == "json":
                log_json("info", event="progress", step=int(done),
                         total=int(total),
                         elapsedSecs=round(now - state["t0"], 3))
            else:
                pct = 100.0 * done / max(total, 1)
                end = "\n" if done >= total else "\r"
                print(f"chaining: {done}/{total} ({pct:5.1f}%)",
                      end=end, file=sys.stderr, flush=True)

    chains, las = chain_local_alignments(las, ChainingOptions(),
                                         progress=progress)
    save_alignments(args.out_alignments, las, chains)
    log_json("info", event="chain", numChains=len(chains))


@command("collect-pile-ups")
def cmd_collect(args):
    from .io.store import load_alignments, save_pile_ups
    from .models.pileups import ChainCtx, CollectConfig, collect_pile_ups

    store, structure = _load_assembly(args.assembly)
    reads = _load_reads(args.reads)
    las, chains = load_alignments(args.alignments)
    if chains is None:
        raise SystemExit("collect requires chained alignments (run `map` first)")
    repeats = _read_masks(args.mask)
    ctx = ChainCtx(las, chains, store.lengths, reads.lengths)
    cfg = CollectConfig(
        min_anchor_length=args.min_anchor_length,
        best_pileup_margin=args.best_pile_up_margin,
        existing_gap_bonus=args.existing_gap_bonus,
        min_spanning_reads=args.min_spanning_reads,
        proper_allowance=args.proper_alignment_allowance,
        debug_pile_ups_stem=args.debug_pile_ups,
    )
    pile_ups = collect_pile_ups(ctx, structure.gaps, repeats, cfg,
                                contigs=store, reads=reads)
    save_pile_ups(args.out_pile_ups, pile_ups)


@command("show-pile-ups")
def cmd_show_pile_ups(args):
    from .io.store import load_pile_ups

    pile_ups = load_pile_ups(args.pile_ups)
    info = {
        "numPileUps": len(pile_ups),
        "numReadAlignments": sum(len(p) for p in pile_ups),
    }
    print(json.dumps(info) if args.json else
          f"pile ups: {info['numPileUps']}  read alignments: {info['numReadAlignments']}")


@command("process-pile-ups")
def cmd_process(args):
    from .io.store import load_alignments, load_pile_ups, save_insertions
    from .models.pileups import ChainCtx
    from .models.process import ProcessConfig, process_pile_ups

    store, structure = _load_assembly(args.assembly)
    reads = _load_reads(args.reads)
    las, chains = load_alignments(args.alignments)
    pile_ups = load_pile_ups(args.pile_ups)
    repeats = _read_masks(args.mask)
    ctx = ChainCtx(las, chains, store.lengths, reads.lengths)
    batch = None
    if args.batch:
        lo, hi = args.batch.split("..")
        batch = (int(lo), int(hi))
    cfg = ProcessConfig(allow_single_reads=args.allow_single_reads,
                        min_reads_per_pile_up=args.min_reads_per_pile_up)
    insertions = process_pile_ups(pile_ups, ctx, store, reads, repeats, cfg, batch=batch)
    save_insertions(args.out_insertions, insertions)


@command("show-insertions")
def cmd_show_insertions(args):
    from .io.store import load_insertions

    ins = load_insertions(args.insertions)
    info = {
        "numInsertions": len(ins),
        "numGapClosings": sum(1 for i in ins if i.is_gap),
        "numExtensions": sum(1 for i in ins if i.is_extension),
        "totalInsertedBp": int(sum(len(i.sequence) for i in ins)),
    }
    print(json.dumps(info) if args.json else json.dumps(info, indent=2))


@command("merge-insertions")
def cmd_merge_insertions(args):
    from .io.store import load_insertions, save_insertions

    merged = []
    for p in args.partial_insertions:
        merged.extend(load_insertions(p))
    merged.sort(key=lambda i: (i.start_node, i.end_node))
    save_insertions(args.out_insertions, merged)
    log_json("info", event="mergeInsertions", numInsertions=len(merged))


@command("output")
def cmd_output(args):
    from .io.store import load_insertions
    from .models.output import OutputConfig, build_output, write_output

    store, structure = _load_assembly(args.assembly)
    insertions = load_insertions(args.insertions)
    skip = set()
    if args.skip_gaps_file:
        with open(args.skip_gaps_file) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    a, b = line.split("-")
                    skip.add(tuple(sorted((int(a), int(b)))))
    for pair in args.skip_gaps or []:
        a, b = pair.split("-")
        skip.add(tuple(sorted((int(a), int(b)))))
    cfg = OutputConfig(
        join_policy=args.join_policy,
        min_extension_length=args.min_extension_length,
        max_insertion_error=args.max_insertion_error,
        no_highlight_insertions=args.no_highlight_insertions,
        only=args.only,
        skip_gaps=skip,
    )
    result = build_output(store, structure, insertions, cfg)
    write_output(result, args.out_assembly, agp_path=args.agp,
                 bed_path=args.closed_gaps_bed, line_width=args.fasta_line_width)
    # persist the coordinate maps for translate-coords
    if args.scaffolding:
        with open(args.scaffolding, "w") as fh:
            json.dump({k: [list(s) for s in v] for k, v in result.segment_maps.items()}, fh)


@command("translate-coords")
def cmd_translate_coords(args):
    with open(args.scaffolding) as fh:
        maps = json.load(fh)
    from .models.output import OutputResult

    result = OutputResult([], [], [], segment_maps={
        k: [tuple(s) for s in v] for k, v in maps.items()
    })
    for coord in args.coords:
        scaffold, pos = coord.rsplit("/", 1)
        kind, cid, c = result.translate_coord(scaffold, int(pos))
        print(json.dumps({"input": coord, "kind": kind, "contigId": cid, "coord": c}))


@command("validate-regions")
def cmd_validate_regions(args):
    from .io.store import load_alignments, load_mask, save_mask
    from .models.validate import ValidateConfig, validate_regions
    from .models.mask import validation_min_coverage

    store, _ = _load_assembly(args.assembly)
    reads = _load_reads(args.reads)
    las, chains = load_alignments(args.alignments)
    # regions mask may carry bed2mask --data-comments id lists (the
    # reference's DazzExtra side channel, validateRegions.d:208-253)
    regions, extras = load_mask(args.regions, with_extras=True)
    region_cids, region_rids = None, None
    cid_lists = extras.get("contig_ids")
    rid_lists = extras.get("read_ids")
    if cid_lists is not None and len(cid_lists) == len(regions.iv):
        region_cids = {
            (int(t), int(b), int(e)): tuple(int(x) for x in ids)
            for (t, b, e), ids in zip(regions.iv, cid_lists) if len(ids) == 2
        }
    if rid_lists is not None and len(rid_lists) == len(regions.iv):
        region_rids = {
            (int(t), int(b), int(e)): tuple(int(x) for x in ids)
            for (t, b, e), ids in zip(regions.iv, rid_lists) if len(ids)
        }
    min_cov = args.min_coverage_reads
    if min_cov is None:
        if args.read_coverage is None:
            raise SystemExit("must provide --read-coverage or --min-coverage-reads")
        min_cov = validation_min_coverage(args.read_coverage, args.ploidy)
    cfg = ValidateConfig(min_coverage_reads=min_cov,
                         min_spanning_reads=args.min_spanning_reads)
    reports, weak = validate_regions(las, chains or [], regions, store.lengths,
                                     reads.lengths, cfg,
                                     region_contig_ids=region_cids,
                                     region_read_ids=region_rids)
    for r in reports:
        print(json.dumps(r.to_json()))
    if args.weak_coverage_mask:
        save_mask(args.weak_coverage_mask, weak)


@command("export-las")
def cmd_export_las(args):
    """Write alignments in Dazzler ``.las`` format (golden comparison edge)."""
    from .io.dazzler import write_las
    from .io.store import load_alignments

    las, _ = load_alignments(args.alignments)
    write_las(args.out_las, las)
    log_json("info", event="exportLas", numLocalAlignments=len(las))


@command("import-las")
def cmd_import_las(args):
    """Read a Dazzler ``.las`` file into the framework container format."""
    from .io.dazzler import read_las
    from .io.store import save_alignments

    las, spacing = read_las(args.las)
    if spacing != 126:
        log_json("warn", event="importLas", info="trace spacing != 126",
                 spacing=spacing)
    save_alignments(args.out_alignments, las)
    log_json("info", event="importLas", numLocalAlignments=len(las))


@command("export-mask")
def cmd_export_mask(args):
    """Write a mask as a Dazzler track (``.anno``/``.data``).

    Carries ``bed2mask --data-comments`` id lists as ``DazzExtra``
    records named ``contigs`` / ``reads`` with the reference's exact
    encoding (``bed2mask.d:316-331``: contig ids flat, read ids
    length-prefixed per interval), so ``validate-regions`` of the
    reference toolchain can consume the track.
    """
    import numpy as np

    from .io.dazzler import write_dazz_extra, write_mask
    from .io.store import load_mask

    store, _ = _load_assembly(args.assembly)
    mask, extras = load_mask(args.mask, with_extras=True)
    write_mask(args.out_anno, args.out_data, mask, num_reads=len(store.lengths))
    if extras.get("contig_ids") is not None:
        flat = ([np.asarray(x, dtype=np.int64) for x in extras["contig_ids"]]
                or [np.empty(0, np.int64)])
        write_dazz_extra(args.out_anno, "contigs", np.concatenate(flat))
    if extras.get("read_ids") is not None:
        rows = [np.concatenate([[len(x)], np.asarray(x, dtype=np.int64)])
                for x in extras["read_ids"]] or [np.empty(0, np.int64)]
        write_dazz_extra(args.out_anno, "reads", np.concatenate(rows))
    log_json("info", event="exportMask", intervals=len(mask.iv),
             extras=sorted(extras))


@command("import-mask")
def cmd_import_mask(args):
    """Read a Dazzler track (``.anno``/``.data``) into the mask container.

    Recovers ``contigs``/``reads`` ``DazzExtra`` records (if present)
    into per-interval id lists, inverting the reference encoding.
    """
    from .io.dazzler import read_dazz_extra, read_mask
    from .io.store import save_mask

    mask = read_mask(args.anno, args.data)
    extras = {}
    contigs = read_dazz_extra(args.anno, "contigs")
    if contigs is not None:
        extras["contig_ids"] = [contigs[i : i + 2] for i in
                                range(0, len(contigs), 2)]
    reads = read_dazz_extra(args.anno, "reads")
    if reads is not None:
        lists, i = [], 0
        while i < len(reads):
            n = int(reads[i])
            lists.append(reads[i + 1 : i + 1 + n])
            i += 1 + n
        extras["read_ids"] = lists
    for name, lists in list(extras.items()):
        if len(lists) != len(mask.iv):
            log_json("warn", event="importMask",
                     info=f"extra {name} misaligned with intervals; dropped")
            del extras[name]
    save_mask(args.out_mask, mask, extras=extras or None)
    log_json("info", event="importMask", intervals=len(mask.iv),
             extras=sorted(extras))


@command("intrinsic-qv")
def cmd_intrinsic_qv(args):
    """Intrinsic QVs + coverage per read window (DASqv/DAScover roles).

    Reads the alignment container, computes per-126bp-window intrinsic
    QVs (mean diffs of the best half of covering alignments) and
    coverage, saves them as an npz track, and prints the summary
    (QV + coverage histograms) as JSON.
    """
    import numpy as np

    from .io.store import load_alignments
    from .models.sequences import load_reads
    from .ops.qv import compute_intrinsic_qv

    las, _ = load_alignments(args.alignments)
    reads = load_reads(args.reads)
    qv = compute_intrinsic_qv(las, reads.lengths)
    if args.out:
        np.savez_compressed(args.out, offsets=qv.offsets, qv=qv.qv,
                            coverage=qv.coverage)
    print(json.dumps(qv.to_json(), indent=None if args.json else 2))


@command("lost-gaps")
def cmd_lost_gaps(args):
    """Explain why potentially closable gaps were not closed.

    Reads the pipeline's JSON event log(s) (``<workdir>/pipeline.log`` or
    explicit files), groups ``pileUpSkipped``/``insertionSkipped`` events
    by phase and reason, and prints a markdown report — the reference's
    ``scripts/lost-gaps.py``.
    """
    import glob as _glob
    import os as _os

    paths = []
    for p in args.logs:
        if _os.path.isdir(p):
            paths.extend(sorted(_glob.glob(_os.path.join(p, "*.log"))))
        else:
            paths.append(p)
    events = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("event") in ("pileUpSkipped", "insertionSkipped"):
                    events.append(rec)
    by_reason: dict[str, list] = {}
    for e in events:
        by_reason.setdefault(e.get("reason", "other"), []).append(e)

    def gap_of(e):
        ids = e.get("contigIds") or e.get("contig_ids") or e.get("gap")
        return "-".join(str(c) for c in ids) if isinstance(ids, (list, tuple)) \
            else str(ids) if ids is not None else "?"

    print(f"In this run {len(events)} potentially closable gaps were not "
          f"closed. More details:\n")
    phases = [
        ("collect", ["minSpanningReads", "scaffoldingConflict"]),
        ("process", ["noCommonTracePoint", "tooFewCroppedReads",
                     "emptyConsensus", "flankAnchorNotFound",
                     "insertionError", "minReadsPerPileUp", "contigsOverlap",
                     "exception"]),
        ("output", ["maxInsertionError", "minExtensionLength", "skipGaps"]),
    ]
    for phase, reasons in phases:
        present = [r for r in reasons if r in by_reason]
        n = sum(len(by_reason[r]) for r in present)
        print(f"- lost {n} in `{phase}` phase")
        for r in present:
            evs = by_reason.pop(r)
            print(f"    - lost {len(evs)} gap(s): {r}")
            for e in evs:
                print(f"        - skipped {gap_of(e)}")
    for r, evs in by_reason.items():
        print(f"- {len(evs)} event(s) with unhandled reason `{r}`")


@command("fasta2db")
def cmd_fasta2db(args):
    """Build a Dazzler read database (.db + hidden .idx/.bps).

    The native equivalent of DAZZ_DB ``fasta2DB``
    (``dazzler.d:6327,6389``): read sets prepared for the reference
    toolchain and ours become interchangeable on disk.
    """
    from .io.dazzdb import write_db
    from .io.fasta import read_fasta

    records = read_fasta(args.fasta)
    write_db(args.db, [r.codes for r in records],
             prolog=args.prolog, source_name=args.fasta)
    log_json("info", event="fasta2db", numReads=len(records))


@command("fasta2dam")
def cmd_fasta2dam(args):
    """Build a Dazzler assembly map (.dam + hidden .idx/.bps/.hdr).

    The native equivalent of DAZZ_DB ``fasta2DAM`` (``dazzler.d:6186``):
    scaffolds split into contigs at N runs, gap offsets in ``fpulse``.
    """
    from .io.dazzdb import write_dam
    from .io.fasta import read_fasta

    records = read_fasta(args.fasta)
    write_dam(args.dam, [(r.header, r.codes) for r in records],
              source_name=args.fasta)
    log_json("info", event="fasta2dam", numScaffolds=len(records))


@command("dbshow")
def cmd_dbshow(args):
    """Print a .db/.dam back as FASTA (native DAZZ_DB ``DBshow``,
    ``dazzler.d:6233``); .dam scaffolds are reassembled with N gaps."""
    import sys

    from .io.dazzdb import read_dazz
    from .io.fasta import codes_to_seq, write_fasta

    db = read_dazz(args.db)
    recs = ((name, codes_to_seq(codes)) for name, codes in
            db.scaffold_records())
    write_fasta(sys.stdout, recs, line_width=args.width)


@command("generate-config")
def cmd_generate_config(args):
    """Print the effective pipeline parameter set.

    The analogue of ``generate-dazzler-options``
    (``commands/generateDazzlerOptions.d``): where the reference prints
    exact daligner/damapper command lines for the workflow to run, the
    in-process pipeline prints the derived stage parameters (coverage
    thresholds, chaining/collection/consensus defaults) as a config
    skeleton that can be edited and passed back via ``--config``.

    ``--schema`` prints the config JSON schema instead (equivalent of
    the reference's generated ``config-schema.json``); ``--preset
    greedy`` emits the sensitivity-over-specificity preset mirroring
    ``snakemake/dentist.greedy.yml``.
    """
    from .models.mask import (repeat_coverage_bounds_improper,
                              repeat_coverage_bounds_reads,
                              validation_min_coverage)

    if args.schema:
        from .config import config_schema

        print(json.dumps(config_schema(build_parser().subparser_registry), indent=2))
        return
    if args.preset == "greedy":
        # snakemake/dentist.greedy.yml: maximum sensitivity; always
        # validate the closed gaps (e.g. by manual inspection)
        print(json.dumps({
            "__default__": {
                "verbose": 2,
                "allow-single-reads": True,
                "best-pile-up-margin": 1.5,
                "existing-gap-bonus": 3.0,
                "join-policy": "contigs",
                "min-reads-per-pile-up": 1,
                "min-spanning-reads": 1,
                "proper-alignment-allowance": 500,
            },
        }, indent=2))
        return
    cfg = {
        "__default__": {
            "min-anchor-length": 500,
            "min-spanning-reads": 3,
            "max-alignment-error": 0.3,
            "trace-spacing": 126,
        },
        "mask-repetitive-regions": {"max-coverage-self": 4},
        "collect-pile-ups": {
            "best-pile-up-margin": 3.0,
            "existing-gap-bonus": 6.0,
        },
        "output": {
            "max-insertion-error": 0.1,
            "min-extension-length": 100,
            "join-policy": "scaffoldGaps",
        },
    }
    if args.read_coverage:
        c = args.read_coverage
        cfg["mask-repetitive-regions"]["max-coverage-reads"] = int(
            repeat_coverage_bounds_reads(c)[1])
        cfg["mask-repetitive-regions"]["max-improper-coverage-reads"] = int(
            repeat_coverage_bounds_improper(c)[1])
        cfg["validate-regions"] = {
            "min-coverage-reads": validation_min_coverage(c, args.ploidy),
        }
    print(json.dumps(cfg, indent=2))


@command("check-scaffolding")
def cmd_check_scaffolding(args):
    """Evaluate join correctness of the scaffolding
    (``commands/checkScaffolding.d``): every pair of input contigs
    adjacent on the same result contig is classified
    correct/novel/broken against the true assembly (see
    :mod:`dentist_tpu.eval.check_scaffolding`)."""
    from .eval.check_scaffolding import check_scaffolding
    from .io.fasta import read_fasta

    true_records = [r.codes for r in read_fasta(args.true_assembly)]
    store, structure = _load_assembly(args.test_assembly)
    result_records = [r.codes for r in read_fasta(args.result_assembly)]
    report = check_scaffolding(true_records, structure, store, result_records)
    print(json.dumps(report.to_json()))


@command("validate-config")
def cmd_validate_config(args):
    from .config import config_schema

    cfg = load_config(args.config_file)
    schema = config_schema(build_parser().subparser_registry)
    errors = validate_config(cfg, list(COMMANDS), schema=schema)
    for e in errors:
        print(e, file=sys.stderr)
    if errors:
        raise SystemExit(1)
    print("config is valid")


# ----------------------------------------------------------------------
# testing / simulation commands


@command("simulate-reads")
def cmd_simulate(args):
    from .io.fasta import codes_to_seq, read_fasta, write_fasta
    from .sim.reads import simulate_reads

    records = read_fasta(args.genome)
    reads, truths = simulate_reads(
        [r.codes for r in records], coverage=args.coverage,
        mean_length=args.mean_length, sd_length=args.sd_length,
        error=args.error, seed=args.seed,
    )
    write_fasta(args.out_reads,
                ((t.header(), codes_to_seq(r)) for r, t in zip(reads, truths)))
    log_json("info", event="simulateReads", numReads=len(reads),
             totalBp=int(sum(len(r) for r in reads)))


@command("build-partial-assembly")
def cmd_build_partial(args):
    from .io.fasta import codes_to_seq, read_fasta, write_fasta
    from .sim.partial import build_partial_assembly, random_gaps

    records = read_fasta(args.true_assembly)
    seqs = [r.codes for r in records]
    gaps = random_gaps(seqs, n_gaps=args.num_gaps, min_size=args.min_gap_size,
                       max_size=args.max_gap_size, seed=args.seed)
    out = build_partial_assembly(seqs, gaps)
    write_fasta(args.out_assembly,
                ((r.header, codes_to_seq(s)) for r, s in zip(records, out)))
    log_json("info", event="buildPartialAssembly", numGaps=len(gaps))


@command("find-closable-gaps")
def cmd_find_closable(args):
    from .eval.closable import find_closable_gaps
    from .io.fasta import read_fasta

    store, structure = _load_assembly(args.assembly)
    reads = read_fasta(args.reads)
    closable = find_closable_gaps(structure, reads,
                                  min_spanning_reads=args.min_spanning_reads)
    for g in closable:
        print(json.dumps(g))


@command("check-results")
def cmd_check_results(args):
    from .eval.check_results import check_results
    from .io.fasta import read_fasta

    true_records = [r.codes for r in read_fasta(args.true_assembly)]
    store, structure = _load_assembly(args.test_assembly)
    result_records = [r.codes for r in read_fasta(args.result_assembly)]
    stats = check_results(true_records, structure, store, result_records,
                          bucket_size=args.bucket_size)
    print(json.dumps(stats.to_json(), indent=None if args.json else 2))


# ----------------------------------------------------------------------
# the end-to-end pipeline (Snakemake replacement)


@command("pipeline")
def cmd_pipeline(args):
    from .pipeline import PipelineConfig, run_pipeline

    cfg = PipelineConfig(
        read_coverage=args.read_coverage,
        max_coverage_self=args.max_coverage_self,
        min_spanning_reads=args.min_spanning_reads,
        min_anchor_length=args.min_anchor_length,
        join_policy=args.join_policy,
        max_insertion_error=args.max_insertion_error,
        no_validation=args.no_validation,
        allow_single_reads=args.allow_single_reads,
        workdir=args.workdir,
        ploidy=args.ploidy,
        max_alignment_error=args.max_alignment_error,
        best_pileup_margin=args.best_pile_up_margin,
        existing_gap_bonus=args.existing_gap_bonus,
        min_reads_per_pile_up=args.min_reads_per_pile_up,
        proper_allowance=args.proper_alignment_allowance,
        resume=not args.no_resume,
    )
    run_pipeline(args.assembly, args.reads, args.out_assembly, cfg)


# ----------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dentist-tpu",
        description="TPU-native genome assembly gap closer (capabilities of DENTIST)",
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("--commands", action="store_true", help="list sub-commands")
    p.add_argument("--config-schema", action="store_true",
                   help="print the JSON schema for --config files "
                        "(reference: generated config-schema.json)")
    sub = p.add_subparsers(dest="command")
    p.subparser_registry = {}

    def add(name, *specs, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--config", help="YAML/JSON config file")
        sp.add_argument("-v", "--verbose", action="count", default=0,
                        help="increase output to help identify problems; "
                             "use up to three times")
        sp.add_argument("-q", "--quiet", action="store_true",
                        help="reduce output as much as possible, reporting "
                             "only fatal errors; overrides --verbose")
        sp.add_argument("--revert", action="append", metavar="<option>[,<option>...]",
                        help="revert named option to its default value; useful "
                             "to revert specific options of a config file")
        for spec in specs:
            flags, skw = spec
            sp.add_argument(*flags, **skw)
        p.subparser_registry[name] = sp
        return sp

    A = lambda *flags, **kw: (flags, kw)

    add("dust", A("sequences"), A("out_mask"))
    add("tandem", A("sequences"), A("out_mask"))
    add("align", A("assembly"), A("out_alignments"),
        A("--mask", nargs="*"), A("--max-alignment-error", type=float, default=0.3),
        A("--min-anchor-length", type=int, default=500))
    add("map", A("assembly"), A("reads"), A("out_alignments"), A("--mask", nargs="*"))
    add("mask-repetitive-regions", A("assembly"), A("alignments"), A("out_mask"),
        A("--reads-db"), A("--read-coverage", type=float),
        A("--max-coverage-reads", type=int), A("--max-coverage-self", type=int, default=4))
    add("propagate-mask", A("mask"), A("alignments"), A("reads"), A("out_mask"),
        A("--direction", choices=["assembly2reads", "reads2assembly"],
          default="assembly2reads",
          help="which way to transfer intervals through the alignments "
               "(reads2assembly is the homogenization return leg)"),
        A("--assembly", help="assembly FASTA/store (required with "
                             "--direction reads2assembly)"))
    add("merge-masks", A("out_mask"), A("masks", nargs="+"))
    add("filter-mask", A("mask"), A("out_mask"),
        A("--min-interval-size", type=int, default=0),
        A("--min-gap-size", type=int, default=0))
    add("show-mask", A("mask"), A("--json", "-j", action="store_true"))
    add("bed2mask", A("assembly"), A("bed"), A("out_mask"),
        A("--data-comments", action="store_true"))
    add("mask2bed", A("assembly"), A("mask"), A("out_bed"))
    add("chain-local-alignments", A("alignments"), A("out_alignments"),
        A("--progress", action="store_true",
          help="report progress while chaining"),
        A("--progress-every", type=int, default=500, metavar="MSECS",
          help="progress report interval (default: 500 ms)"),
        A("--progress-format", choices=["human", "json"], default="human"))
    add("collect-pile-ups", A("assembly"), A("reads"), A("alignments"), A("out_pile_ups"),
        A("--mask", nargs="*"), A("--min-anchor-length", type=int, default=500),
        A("--best-pile-up-margin", type=float, default=3.0),
        A("--existing-gap-bonus", type=float, default=6.0),
        A("--min-spanning-reads", type=int, default=3),
        A("--proper-alignment-allowance", type=int, default=126,
          help="consider chains proper if begin/end within <num> bp of "
               "the contig/read ends (default: trace spacing)"),
        A("--debug-pile-ups", help="dump pile-ups after each sub-stage to <stem>.<stage>.npz"))
    add("show-pile-ups", A("pile_ups"), A("--json", "-j", action="store_true"))
    add("process-pile-ups", A("assembly"), A("reads"), A("alignments"),
        A("pile_ups"), A("out_insertions"), A("--mask", nargs="*"),
        A("--batch", help="from..to slice of pile ups"),
        A("--min-reads-per-pile-up", type=int, default=3,
          help="skip pile ups with fewer than <num> reads "
               "(processPileUps/package.d:383)"),
        A("--allow-single-reads", action="store_true"))
    add("show-insertions", A("insertions"), A("--json", "-j", action="store_true"))
    add("merge-insertions", A("out_insertions"), A("partial_insertions", nargs="+"))
    add("output", A("assembly"), A("insertions"), A("out_assembly"),
        A("--agp"), A("--closed-gaps-bed"), A("--scaffolding"),
        A("--join-policy", default="scaffoldGaps",
          choices=["scaffoldGaps", "scaffolds", "contigs"]),
        A("--min-extension-length", type=int, default=100),
        A("--max-insertion-error", type=float, default=0.1),
        A("--fasta-line-width", type=int, default=50),
        A("--no-highlight-insertions", "-H", action="store_true"),
        A("--only", choices=["gaps", "extensions"]),
        A("--skip-gaps", nargs="*"), A("--skip-gaps-file"))
    add("translate-coords", A("scaffolding"), A("coords", nargs="+"),
        A("--json", "-j", action="store_true"))
    add("validate-regions", A("assembly"), A("reads"), A("alignments"), A("regions"),
        A("--read-coverage", type=float), A("--ploidy", type=int, default=1),
        A("--min-coverage-reads", type=int), A("--min-spanning-reads", type=int, default=3),
        A("--weak-coverage-mask"))
    add("export-las", A("alignments"), A("out_las"))
    add("import-las", A("las"), A("out_alignments"))
    add("export-mask", A("assembly"), A("mask"), A("out_anno"), A("out_data"))
    add("import-mask", A("anno"), A("data"), A("out_mask"))
    add("intrinsic-qv", A("alignments"), A("reads"), A("--out", default=None),
        A("--json", "-j", action="store_true"))
    add("lost-gaps", A("logs", nargs="+",
                       help="pipeline log file(s) or a --workdir directory"))
    add("fasta2db", A("fasta"), A("db"), A("--prolog", default="reads"))
    add("fasta2dam", A("fasta"), A("dam"))
    add("dbshow", A("db"), A("--width", type=int, default=50))
    add("generate-config", A("--read-coverage", type=float),
        A("--ploidy", type=int, default=1),
        A("--schema", action="store_true",
          help="print the config JSON schema instead of a config skeleton"),
        A("--preset", choices=["default", "greedy"], default="default",
          help="greedy: sensitivity-over-specificity preset "
               "(snakemake/dentist.greedy.yml)"))
    add("check-scaffolding", A("true_assembly"), A("test_assembly"),
        A("result_assembly"))
    add("validate-config", A("config_file"))
    add("simulate-reads", A("genome"), A("out_reads"),
        A("--coverage", type=float, default=20.0),
        A("--mean-length", type=int, default=25000),
        A("--sd-length", type=int, default=12500),
        A("--error", type=float, default=0.13),
        A("--seed", type=int, default=19339))
    add("build-partial-assembly", A("true_assembly"), A("out_assembly"),
        A("--num-gaps", type=int, default=3),
        A("--min-gap-size", type=int, default=50),
        A("--max-gap-size", type=int, default=500),
        A("--seed", type=int, default=7))
    add("find-closable-gaps", A("assembly"), A("reads"),
        A("--min-spanning-reads", type=int, default=3))
    add("check-results", A("true_assembly"), A("test_assembly"), A("result_assembly"),
        A("--json", "-j", action="store_true"),
        A("--bucket-size", type=int, default=500))
    add("pipeline", A("assembly"), A("reads"), A("out_assembly"),
        A("--read-coverage", type=float, default=None),
        A("--max-coverage-self", type=int, default=4),
        A("--min-spanning-reads", type=int, default=3),
        A("--min-anchor-length", type=int, default=500),
        A("--join-policy", default="scaffoldGaps",
          choices=["scaffoldGaps", "scaffolds", "contigs"]),
        A("--max-insertion-error", type=float, default=0.1),
        A("--no-validation", action="store_true"),
        A("--allow-single-reads", action="store_true"),
        A("--ploidy", type=int, default=1),
        A("--max-alignment-error", type=float, default=0.3),
        A("--best-pile-up-margin", type=float, default=3.0),
        A("--existing-gap-bonus", type=float, default=6.0),
        A("--min-reads-per-pile-up", type=int, default=None,
          help="default: follow --min-spanning-reads"),
        A("--proper-alignment-allowance", type=int, default=126),
        A("--no-resume", action="store_true",
          help="recompute even when --workdir holds stage artifacts"),
        A("--workdir", default=None))
    return p


#: sub-commands that reach the GPU; :func:`main` sets their device
DEVICE_COMMANDS = frozenset({"tandem", "align", "map", "collect-pile-ups",
                             "process-pile-ups", "pipeline"})


def main(argv=None, *, device=None):
    """Run one sub-command (``argv``, default ``sys.argv[1:]``).  A
    device command runs on ``device`` if given, else on this process's
    card; host commands ignore ``device``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and not argv[0].startswith("-"):
        argv[0] = resolve_command(argv[0])
    parser = build_parser()
    parser.prog = "python -m dentist_tpu_torch"
    args = parser.parse_args(argv)
    if getattr(args, "config_schema", False):
        from .config import config_schema

        print(json.dumps(config_schema(parser.subparser_registry), indent=2))
        return 0
    if args.commands or not args.command:
        for name in sorted(COMMANDS):
            print(name)
        return 0
    if getattr(args, "quiet", False):
        set_log_level("error")
    elif getattr(args, "verbose", 0) >= 2:
        set_log_level("debug")
    elif getattr(args, "verbose", 0) == 1:
        set_log_level("diagnostic")
    sp = parser.subparser_registry[args.command]
    positional_dests = {a.dest for a in sp._get_positional_actions()}
    config = load_config(args.config) if getattr(args, "config", None) else {}
    if config:
        explicit = {a.split("=")[0].lstrip("-").replace("-", "_") for a in argv}
        apply_config(args, config, args.command, explicit, positional_dests)
    # --revert (CLI) and `revert:` (config section) reset options to their
    # built-in defaults after the merge (commandline.d:2415-2435)
    revert_names = list(getattr(args, "revert", None) or [])
    section = config.get(args.command, {})
    if isinstance(section, dict) and "revert" in section:
        rv = section["revert"]
        revert_names.extend([rv] if isinstance(rv, str) else rv)
    if revert_names:
        from .config import ConfigError, revert_options

        defaults = {a.dest: a.default for a in sp._actions
                    if a.dest != argparse.SUPPRESS}
        try:
            revert_options(args, revert_names, defaults)
        except ConfigError as exc:
            raise SystemExit(str(exc))
    if args.command in DEVICE_COMMANDS:
        from .device import set_device
        from .parallel.dp import rank_device

        set_device(device or rank_device())
    return COMMANDS[args.command](args) or 0


if __name__ == "__main__":
    sys.exit(main())
