"""Output stage: emit the gap-closed assembly (FASTA + AGP + BED).

Re-expression of ``source/dentist/commands/output.d`` and the graph
transforms of ``common/scaffold.d``:

- Build the output scaffold graph from contigs, unknown joins for the
  input assembly's existing gaps, and the accepted insertions
  (``buildAssemblyGraph``, ``output.d:305-361``).
- Filters: ``--only``, min extension length (default 100), max insertion
  error (default 0.1), skip-gaps blacklist (``output.d:363-410``,
  ``removeBlacklisted``).
- Join policy ``scaffoldGaps`` (default) / ``scaffolds`` / ``contigs``
  (``enforceJoinPolicy``, ``scaffold.d:642``) and unknown-join
  normalization (``normalizeUnkownJoins``, ``scaffold.d:373``).
- Linear walk per scaffold emitting FASTA (inserted sequence
  upper-cased unless disabled), AGP v2.1 rows and a closed-gaps BED
  (``writeNewScaffold``/``writeAGP``, ``output.d:454-931``).

Scaffold headers follow the reference format
``<original scaffold name>\\tscaffold-<first contig id>`` (``output.d:743``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import codes_to_seq, write_fasta
from ..utils.log import log_json
from .insertions import Insertion
from .scaffold import ContigPart, Join, Node, ScaffoldGraph
from .sequences import ScaffoldStructure, SeqStore

__all__ = ["OutputConfig", "OutputResult", "build_output", "write_output"]


@dataclass
class OutputConfig:
    join_policy: str = "scaffoldGaps"  # scaffoldGaps | scaffolds | contigs
    min_extension_length: int = 100
    max_insertion_error: float = 0.1
    fasta_line_width: int = 50
    no_highlight_insertions: bool = False
    only: str | None = None  # None | "gaps" | "extensions"
    skip_gaps: set[tuple[int, int]] = field(default_factory=set)


@dataclass
class _Payload:
    kind: str  # "contig" | "unknown" | "insertion"
    contig_id: int = 0
    gap_length: int = 0
    insertion: Insertion | None = None


@dataclass
class OutputResult:
    #: (header, sequence string) per output scaffold
    records: list[tuple[str, str]]
    #: AGP v2.1 rows (tab-joined strings)
    agp_rows: list[str]
    #: closed-gaps BED rows: (scaffold, begin, end, data comment)
    bed_rows: list[str]
    n_closed_gaps: int = 0
    n_extensions: int = 0
    #: per output scaffold: list of (out_begin, out_end, kind, contig_id,
    #: contig_begin, forward) — the coordinate map for translate-coords
    segment_maps: dict[str, list[tuple]] = field(default_factory=dict)

    def translate_coord(self, scaffold: str, position: int):
        """Output coordinate → input-assembly location.

        Returns ``("contig", contig_id, contig_coord)`` for positions in
        existing contigs, ``("insertion"|"gap", None, offset)`` otherwise.
        Mirrors ``translate-coords`` (``commands/translateCoords.d``).
        """
        segs = self.segment_maps.get(scaffold)
        if segs is None:
            raise KeyError(f"unknown output scaffold {scaffold!r}")
        for ob, oe, kind, cid, cbeg, fwd in segs:
            if ob <= position < oe:
                if kind == "contig":
                    off = position - ob
                    coord = cbeg + off if fwd else cbeg + (oe - ob) - 1 - off
                    return ("contig", cid, coord)
                return (kind, None, position - ob)
        raise ValueError(f"position {position} outside scaffold {scaffold!r}")


def build_output(
    contigs: SeqStore,
    structure: ScaffoldStructure,
    insertions: list[Insertion],
    cfg: OutputConfig | None = None,
) -> OutputResult:
    cfg = cfg or OutputConfig()
    graph = ScaffoldGraph.build(len(contigs), [], lambda a, b: b)
    for key, j in graph.edges.items():
        j.payload = _Payload("contig", contig_id=j.start[0])

    # unknown joins for existing scaffold gaps
    for gap in structure.gaps:
        graph.add(
            Join(
                (gap.begin_global_contig_id, ContigPart.POST),
                (gap.end_global_contig_id, ContigPart.PRE),
                _Payload("unknown", gap_length=gap.length),
            ),
            lambda a, b: b,
        )

    # insertion filters (output.d:363-410)
    kept: list[Insertion] = []
    for ins in insertions:
        if ins.error > cfg.max_insertion_error:
            log_json("info", event="insertionSkipped", reason="maxInsertionError",
                     error=ins.error)
            continue
        if ins.is_extension and len(ins.sequence) < cfg.min_extension_length:
            log_json("info", event="insertionSkipped", reason="minExtensionLength",
                     length=len(ins.sequence))
            continue
        if cfg.only == "gaps" and not ins.is_gap:
            continue
        if cfg.only == "extensions" and not ins.is_extension:
            continue
        pair = tuple(sorted((ins.start_node[0], ins.end_node[0])))
        if ins.is_gap and pair in cfg.skip_gaps:
            log_json("info", event="insertionSkipped", reason="skipGaps", gap=pair)
            continue
        kept.append(ins)

    for ins in kept:
        graph.add(
            Join(ins.start_node, ins.end_node, _Payload("insertion", insertion=ins)),
            _prefer_better_insertion,
        )

    _enforce_join_policy(graph, cfg.join_policy)
    _normalize_unknown_joins(graph)
    return _walk_and_emit(graph, contigs, structure, cfg)


def _prefer_better_insertion(a: Join, b: Join) -> Join:
    ia, ib = a.payload.insertion, b.payload.insertion
    return a if (ia.n_reads, -ia.error) >= (ib.n_reads, -ib.error) else b


def _enforce_join_policy(graph: ScaffoldGraph, policy: str) -> None:
    """``enforceJoinPolicy`` (``scaffold.d:642``)."""
    if policy == "contigs":
        return
    assert policy in ("scaffoldGaps", "scaffolds"), policy
    allowed: set[tuple[Node, Node]] = set()
    for j in graph.joins():
        if j.is_unknown:
            c1, c2 = j.start[0], j.end[0]
            allowed.add(Join((c1, ContigPart.END), (c2, ContigPart.BEGIN)).key)
    forbidden = [
        j for j in graph.joins()
        if j.is_gap and j.key not in allowed
    ]
    for j in forbidden:
        graph.remove(j.key)
    if policy == "scaffolds":
        _normalize_unknown_joins(graph)
        for j in forbidden:
            if graph.degree(j.start) == 1 and graph.degree(j.end) == 1:
                graph.edges[j.key] = j


def _normalize_unknown_joins(graph: ScaffoldGraph) -> None:
    """``normalizeUnkownJoins`` (``scaffold.d:373``)."""
    inc = graph.incidence_map()
    deg = {n: len(e) for n, e in inc.items()}
    to_add: list[Join] = []
    to_remove: list[tuple[Node, Node]] = []
    for j in graph.joins():
        if not j.is_unknown:
            continue
        pre_end = (j.start[0], ContigPart.END)
        post_begin = (j.end[0], ContigPart.BEGIN)
        pre_unconnected = deg.get(pre_end, 0) == 1
        pre_has_ext = Join(pre_end, j.start).key in graph.edges
        pre_has_gap = not pre_unconnected and not pre_has_ext
        post_unconnected = deg.get(post_begin, 0) == 1
        post_has_ext = Join(j.end, post_begin).key in graph.edges
        post_has_gap = not post_unconnected and not post_has_ext
        if pre_unconnected and post_unconnected:
            to_add.append(Join(pre_end, post_begin, j.payload))
            to_remove.append(j.key)
        elif pre_unconnected and post_has_ext:
            to_add.append(Join(pre_end, j.end, j.payload))
            to_remove.append(j.key)
        elif pre_has_ext and post_unconnected:
            to_add.append(Join(j.start, post_begin, j.payload))
            to_remove.append(j.key)
        elif pre_has_gap or post_has_gap:
            to_remove.append(j.key)
    for key in to_remove:
        graph.remove(key)
    for j in to_add:
        graph.edges[j.key] = j


def _walk_and_emit(
    graph: ScaffoldGraph,
    contigs: SeqStore,
    structure: ScaffoldStructure,
    cfg: OutputConfig,
) -> OutputResult:
    contig_by_id = {c.global_contig_id: c for c in structure.contigs}
    used_headers: dict[str, int] = {}
    records: list[tuple[str, str]] = []
    agp_rows: list[str] = []
    bed_rows: list[str] = []
    n_closed = 0
    n_ext = 0

    # contig crop requests from overlap-implying insertions (the
    # reference's ``fixCropping``, ``output.d:931``): bases trimmed from
    # a contig's gap-facing physical side
    crops: dict[Node, int] = {}
    for j in graph.joins():
        p = j.payload
        if p.kind == "insertion" and p.insertion is not None:
            ins = p.insertion
            if ins.crop_start_node:
                crops[ins.start_node] = max(crops.get(ins.start_node, 0),
                                            ins.crop_start_node)
            if ins.crop_end_node:
                crops[ins.end_node] = max(crops.get(ins.end_node, 0),
                                          ins.crop_end_node)

    segment_maps: dict[str, list[tuple]] = {}
    for start in graph.scaffold_starts():
        parts: list[tuple[str, str]] = []  # (kind, sequence-string)
        agp_parts: list[tuple] = []
        segs: list[tuple] = []
        pos_acc = 0
        node = start
        first_contig = start[0]
        for join in graph.linear_walk(start):
            p: _Payload = join.payload
            if p.kind == "contig":
                seq = contigs.get(p.contig_id)
                crop_b = crops.get((p.contig_id, ContigPart.BEGIN), 0)
                crop_e = crops.get((p.contig_id, ContigPart.END), 0)
                seq = seq[crop_b : len(seq) - crop_e]
                forward = node[1] == ContigPart.BEGIN
                s = codes_to_seq(seq if forward else _rc(seq))
                parts.append(("contig", s))
                segs.append((pos_acc, pos_acc + len(s), "contig", p.contig_id,
                             crop_b, forward))
                agp_parts.append(("W", p.contig_id, crop_b, len(seq),
                                  "+" if forward else "-"))
            elif p.kind == "unknown":
                parts.append(("gap", "n" * p.gap_length))
                segs.append((pos_acc, pos_acc + p.gap_length, "gap", 0, 0, True))
                agp_parts.append(("N", p.gap_length))
            else:  # insertion
                ins = p.insertion
                seq = ins.oriented(node)
                upper = not cfg.no_highlight_insertions
                s = codes_to_seq(seq, upper=upper)
                parts.append(("insertion", s))
                segs.append((pos_acc, pos_acc + len(s), "insertion", 0, 0, True))
                agp_parts.append(("I", len(seq)))
                if ins.is_gap:
                    n_closed += 1
                    bed_rows.append((node, ins, pos_acc, len(s)))
                else:
                    n_ext += 1
            pos_acc += len(parts[-1][1])
            node = join.other(node)

        if not parts:
            continue
        # header: original scaffold name + unique suffix (output.d:743)
        orig = structure.headers[contig_by_id[first_contig].scaffold_id].split("\t")[0]
        count = used_headers.get(orig, 0)
        used_headers[orig] = count + 1
        uniq = orig if count == 0 else f"{orig}-{count}"
        header = f"{uniq}\tscaffold-{first_contig}"
        seq_str = "".join(x[1] for x in parts)
        records.append((header, seq_str))
        segment_maps[uniq] = segs
        # AGP rows
        pos = 1
        part_number = 0
        obj = uniq
        for ap in agp_parts:
            part_number += 1
            if ap[0] == "W":
                _, cid, crop_b, ln, orient = ap
                agp_rows.append("\t".join(map(str, (
                    obj, pos, pos + ln - 1, part_number, "W",
                    contigs.names[cid - 1], crop_b + 1, crop_b + ln, orient,
                ))))
                pos += ln
            elif ap[0] == "N":
                ln = ap[1]
                agp_rows.append("\t".join(map(str, (
                    obj, pos, pos + ln - 1, part_number, "N", ln,
                    "scaffold", "yes", "na",
                ))))
                pos += ln
            else:
                ln = ap[1]
                agp_rows.append("\t".join(map(str, (
                    obj, pos, pos + ln - 1, part_number, "W",
                    f"insertion-{part_number}", 1, ln, "+",
                ))))
                pos += ln
        # resolve BED rows for this scaffold
        for k, row in enumerate(bed_rows):
            if isinstance(row, tuple) and len(row) == 4 and isinstance(row[0], tuple):
                nd, ins, beg, ln = row
                reads = ",".join(str(r) for r in ins.read_ids)
                bed_rows[k] = "\t".join(map(str, (
                    uniq, beg, beg + ln,
                    f"contigIds={ins.start_node[0]}-{ins.end_node[0]};nReads={ins.n_reads};readIds={reads}",
                )))

    log_json("info", event="output", numScaffolds=len(records),
             numClosedGaps=n_closed, numExtensions=n_ext)
    return OutputResult(records, agp_rows, bed_rows, n_closed, n_ext, segment_maps)


def _rc(codes: np.ndarray) -> np.ndarray:
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    return comp[codes][::-1]


def write_output(result: OutputResult, fasta_path, agp_path=None, bed_path=None,
                 line_width: int = 50):
    write_fasta(fasta_path, result.records, line_width=line_width)
    if agp_path:
        with open(agp_path, "w") as fh:
            fh.write("##agp-version\t2.1\n")
            for row in result.agp_rows:
                fh.write(row + "\n")
    if bed_path:
        with open(bed_path, "w") as fh:
            for row in result.bed_rows:
                fh.write(row + "\n")
