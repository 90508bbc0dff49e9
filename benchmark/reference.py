"""The plain reference that decides ``correct``: a gap closer's outputs
judged against the truth the generator drew them from.

Plain NumPy.  It imports nothing of the program and takes nothing the
program made but the outputs it judges: the true genome, the gaps and
each read's origin come from ``truth.npz`` (``benchmark/gen.py``), the
contigs are the truth cut at the gaps, the reads are parsed from the
same ``reads.fasta`` the program read.

Per unit of work it reads the program's outputs (``out.fasta``,
``out.agp``, ``out.closed-gaps.bed`` and, in the workdir,
``reads.las.npz`` and ``insertions.npz``) and counts:

Output layer (FASTA, AGP, BED):
- ``contigs_lost``: contigs whose unique 64-mer anchor, taken near
  their middle, is not found exactly once in the output FASTA.
- ``false_joins``: two anchors in one output record with no ``n``
  between them whose contigs are not neighbours in the truth, in the
  same orientation.
- ``gaps_open``: gaps whose two neighbouring contigs are not joined.
- ``gaps_wrong``: gaps left open or closed more than ``GAP_TOLERANCE``
  edits off the truth.
- ``gap_errors``: for each joined gap, the edit distance between the
  output from one anchor to the next and the truth between them: the
  closure's inserted bases and every flank base the output changed.
- ``agp_bed_mismatches``: AGP rows that do not tile their record, a
  contig row whose bases differ from that contig's, an ``N`` row over
  bases that are not ``n``, an insertion row over ``n``; BED rows whose
  contig pair the FASTA does not join, or that lie outside the two
  anchors; joined pairs no BED row names.

Mapping layer (``reads.las.npz``):
- ``alignments_invalid``: alignments whose trace intervals do not
  follow the 126-base grid, whose trace diffs do not sum to their diffs
  or whose B advances to their B span, whose coordinates leave their
  contig or read, and chains that mix contigs, reads or strands.
- ``alignments_below_optimal``: sampled alignments whose diffs are
  fewer than the edit distance of the two spans they align (no path
  between them can have fewer).  ``ALN_SAMPLES`` are drawn from those
  spanning at most ``ALN_MAX_SPAN`` contig bases and ``ALN_LONG_SAMPLES``
  from the longer ones.  Single trace intervals are not held so: the
  aligner takes each trace point from the best cell of its row, so one
  interval's diffs may fall below its two segments' distance while the
  whole alignment's may not.
- ``diffs_excess_pct``: over the same samples, the diffs above the edit
  distance, as a share of the edit distance: how far the alignments the
  mapping layer returns lie above the best.
- ``reads_unmapped_pct``: of the (read, contig) pairs whose true
  overlap is ``MAP_MIN_OVERLAP`` bases or more, the share with no valid
  alignment on that contig, on the read's true strand, that covers a
  base of the overlap.
- ``overlap_unaligned_pct``: of those pairs' overlap bases, the share
  that no such alignment covers: alignments cut short count here.
- ``chains_off_origin``: chains spanning ``LONG_CHAIN`` bases or more of
  a contig (longer than any repeat the generator plants) that do not
  overlap their read's true origin, or lie on the other strand.

Consensus layer (``insertions.npz``):
- ``insertion_errors``: for each insertion between neighbouring contigs
  that the output FASTA joins, the edit distance between its bases and
  the truth between the two contigs' kept ends.  Insertions the
  validation pass purged are not held: rejecting a poor consensus is
  that pass's job (a sound run's purged insertion read 17 edits).

:func:`judge` turns the units' counts into the run's numbers and holds
each against its limit.
"""

from __future__ import annotations

import os

import numpy as np

#: anchor length and the step between anchor candidates
ANCHOR = 64
ANCHOR_STEP = 997
#: trace spacing of the alignments (DALIGNER's, forced by DENTIST)
TRACE = 126
#: a chain this long on its contig lies at its read's origin
LONG_CHAIN = 10_000
#: alignments sampled per unit for ``alignments_below_optimal`` and
#: ``diffs_excess_pct``: ``ALN_SAMPLES`` of those spanning at most
#: ``ALN_MAX_SPAN`` contig bases, ``ALN_LONG_SAMPLES`` of the longer ones
#: (the distance's cost grows with the square of the span: ~0.4 s at
#: 25 kb)
ALN_SAMPLES = 6
ALN_LONG_SAMPLES = 3
ALN_MAX_SPAN = 12_000
#: a read whose true origin overlaps a contig by this many bases has to
#: align there (the aligner keeps alignments from 500 bases)
MAP_MIN_OVERLAP = 5_000
#: a closed gap this many edits or fewer off the truth is closed right
GAP_TOLERANCE = 3

_LUT = np.full(256, 4, dtype=np.uint8)
for _c, _v in zip(b"AaCcGgTt", [0, 0, 1, 1, 2, 2, 3, 3]):
    _LUT[_c] = _v


def revcomp(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.uint8)[::-1]
    out = (3 - codes).astype(np.uint8)
    out[codes > 3] = codes[codes > 3]
    return out


def read_fasta(path: str) -> list[tuple[str, np.ndarray]]:
    """(header, codes) per record; any non-ACGT letter is code 4."""
    with open(path, "rb") as fh:
        data = fh.read()
    out = []
    for block in data.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        out.append((head.decode(), _LUT[np.frombuffer(seq, dtype=np.uint8)]))
    return out


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance of two code arrays (unit costs): the common
    prefix and suffix trimmed, then Myers's bit-vector recurrence (global
    form: every column of the first row adds one) over the rest, the
    shorter one as the bit vector."""
    a = np.minimum(np.asarray(a, dtype=np.uint8), 4)
    b = np.minimum(np.asarray(b, dtype=np.uint8), 4)
    m = min(len(a), len(b))
    diff = np.flatnonzero(a[:m] != b[:m])
    p = int(diff[0]) if len(diff) else m
    a, b = a[p:], b[p:]
    m = min(len(a), len(b))
    if m:
        diff = np.flatnonzero(a[::-1][:m] != b[::-1][:m])
        s = int(diff[0]) if len(diff) else m
        a, b = a[: len(a) - s], b[: len(b) - s]
    if len(a) == 0 or len(b) == 0:
        return max(len(a), len(b))
    if len(a) > len(b):
        a, b = b, a
    m = len(a)
    # peq[c]: bit i set where a[i] == c
    peq = [int.from_bytes(np.packbits((a == c)[::-1]).tobytes(), "big") >> (-m % 8)
           for c in range(5)]
    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in b.tolist():
        eq = peq[c]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def contig_bounds(truth_len: int, gaps: np.ndarray) -> np.ndarray:
    """(n_contigs, 2) [begin, end) of the contigs the gaps cut the truth
    into; contig k (1-based) is row k - 1."""
    starts = np.concatenate([[0], gaps[:, 1]])
    ends = np.concatenate([gaps[:, 0], [truth_len]])
    return np.stack([starts, ends], axis=1).astype(np.int64)


def _anchor(truth: np.ndarray, tb: bytes, lo: int, hi: int) -> int:
    """Start of a 64-mer near the middle of [lo, hi) that occurs once in
    the truth on both strands together; -1 if none does."""
    mid = (lo + hi) // 2
    for k in range(64):
        for pos in (mid + k * ANCHOR_STEP, mid - (k + 1) * ANCHOR_STEP):
            if pos < lo or pos + ANCHOR > hi:
                continue
            kmer = tb[pos : pos + ANCHOR]
            rc = revcomp(truth[pos : pos + ANCHOR]).tobytes()
            if tb.count(kmer) + tb.count(rc) == 1:
                return pos
    return -1


def _find_all(hay: bytes, needle: bytes) -> list[int]:
    out, i = [], hay.find(needle)
    while i >= 0:
        out.append(i)
        i = hay.find(needle, i + 1)
    return out


def check_output(truth: np.ndarray, gaps: np.ndarray, out_dir: str) -> dict:
    """The output layer's counts for one unit (see the module doc)."""
    bounds = contig_bounds(len(truth), gaps)
    tb = truth.tobytes()
    records = read_fasta(os.path.join(out_dir, "out.fasta"))
    names = [h.split("\t")[0].split(" ")[0] for h, _ in records]
    rec_bytes = [c.tobytes() for _, c in records]
    n_cum = [np.concatenate([[0], np.cumsum(c == 4)]) for _, c in records]
    counts = {"contigs_lost": 0, "false_joins": 0, "gaps_open": 0,
              "agp_bed_mismatches": 0}
    gap_errors: list[int] = []
    anchors = np.array([_anchor(truth, tb, b, e) for b, e in bounds])
    hits = []  # (record, position, strand, contig 1-based)
    for k, pos in enumerate(anchors, start=1):
        if pos < 0:
            counts["contigs_lost"] += 1
            continue
        kmer = tb[pos : pos + ANCHOR]
        rc = revcomp(truth[pos : pos + ANCHOR]).tobytes()
        found = [(r, i, "+") for r, h in enumerate(rec_bytes)
                 for i in _find_all(h, kmer)]
        found += [(r, i, "-") for r, h in enumerate(rec_bytes)
                  for i in _find_all(h, rc)]
        if len(found) != 1:
            counts["contigs_lost"] += 1
            continue
        hits.append((*found[0], k))
    hits.sort()
    joined: dict[tuple[int, int], tuple[int, int, int]] = {}
    for x, y in zip(hits, hits[1:]):
        r, px, sx, kx = x
        r2, py, sy, ky = y
        if r != r2 or n_cum[r][py] - n_cum[r][px] > 0:
            continue  # different records, or an open gap between them
        if sx != sy or ky - kx != (1 if sx == "+" else -1):
            counts["false_joins"] += 1
            continue
        k = min(kx, ky)
        seg = records[r][1][px : py + ANCHOR]
        if sx == "-":
            seg = revcomp(seg)
        want = truth[anchors[k - 1] : anchors[k] + ANCHOR]
        gap_errors.append(edit_distance(seg, want))
        joined[(k, k + 1)] = (r, px, py)
    counts["gaps_open"] = len(gaps) - len(joined)
    counts["gaps_wrong"] = counts["gaps_open"] + sum(e > GAP_TOLERANCE for e in gap_errors)
    counts["agp_bed_mismatches"] = (
        _agp_mismatches(os.path.join(out_dir, "out.agp"), names, records, truth,
                        bounds)
        + _bed_mismatches(os.path.join(out_dir, "out.closed-gaps.bed"), names,
                          joined))
    counts["gap_errors"] = gap_errors
    counts["joined"] = set(joined)
    return counts


def _agp_mismatches(path: str, names, records, truth, bounds) -> int:
    rows: dict[str, list[list[str]]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            rows.setdefault(f[0], []).append(f)
    bad = 0
    for name, (_, codes) in zip(names, records):
        pos = 1
        for f in rows.pop(name, []):
            beg, end = int(f[1]), int(f[2])
            if beg != pos or end > len(codes) or end < beg:
                bad += 1
                break
            seg = codes[beg - 1 : end]
            pos = end + 1
            if f[4] in ("N", "U"):
                bad += int(not np.all(seg == 4))
            elif f[5].isdigit():
                b, e = bounds[int(f[5]) - 1]
                contig = truth[b:e][int(f[6]) - 1 : int(f[7])]
                want = contig if f[8] == "+" else revcomp(contig)
                bad += int(not np.array_equal(seg, want))
            else:
                bad += int(bool(np.any(seg == 4)))
        bad += int(pos != len(codes) + 1)
    return bad + sum(len(v) for v in rows.values())


def _bed_mismatches(path: str, names, joined) -> int:
    bad, named = 0, set()
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            name, beg, end, data = line.rstrip("\n").split("\t")[:4]
            pair = None
            for field in data.split(";"):
                if field.startswith("contigIds="):
                    a, b = field.split("=")[1].split("-")
                    pair = tuple(sorted((int(a), int(b))))
            hit = joined.get(pair)
            if (hit is None or name not in names or names.index(name) != hit[0]
                    or not (hit[1] + ANCHOR <= int(beg) <= int(end) <= hit[2])):
                bad += 1
            named.add(pair)
    return bad + len(set(joined) - named)


def _trace_counts(a_begin, a_end) -> np.ndarray:
    first = (a_begin // TRACE + 1) * TRACE
    return np.maximum(0, -(-(a_end - first) // TRACE)) + 1


def check_alignments(truth, gaps, origins, reads: list[np.ndarray],
                     las_path: str, rng: np.random.Generator) -> dict:
    """The mapping layer's counts for one unit (see the module doc)."""
    z = np.load(las_path, allow_pickle=False)
    bounds = contig_bounds(len(truth), gaps)
    c_len = bounds[:, 1] - bounds[:, 0]
    r_len = np.array([len(r) for r in reads], np.int64)
    a_id = z["a_id"].astype(np.int64)
    b_id = z["b_id"].astype(np.int64)
    ab, ae = z["a_begin"].astype(np.int64), z["a_end"].astype(np.int64)
    bb, be = z["b_begin"].astype(np.int64), z["b_end"].astype(np.int64)
    comp = z["complement"].astype(bool)
    offs = z["trace_offsets"].astype(np.int64)
    t_diffs = z["trace_diffs"].astype(np.int64)
    t_badv = z["trace_b_adv"].astype(np.int64)
    n = len(a_id)
    counts = {"alignments_invalid": 0, "alignments_below_optimal": 0,
              "chains_off_origin": 0, "alignments_sampled": 0,
              "diffs_excess": 0, "diffs_optimal": 0, "long_chains": 0}
    if n == 0:
        ok = np.zeros(0, bool)
        counts.update(_unmapped(bounds, origins, a_id, b_id, comp, ab, ae, ok))
        return counts
    ids_ok = (a_id >= 1) & (a_id <= len(c_len)) & (b_id >= 1) & (b_id <= len(r_len))
    ai = np.clip(a_id - 1, 0, len(c_len) - 1)
    bi = np.clip(b_id - 1, 0, len(r_len) - 1)
    ok = (ids_ok & (ab >= 0) & (ab < ae) & (ae <= c_len[ai])
          & (bb >= 0) & (bb < be) & (be <= r_len[bi]))
    n_tr = np.diff(offs)
    ok &= (len(offs) == n + 1) & (n_tr == _trace_counts(ab, ae))
    starts = offs[:-1]
    nz = n_tr > 0
    sum_d = np.zeros(n, np.int64)
    sum_b = np.zeros(n, np.int64)
    sum_d[nz] = np.add.reduceat(t_diffs, starts[nz])
    sum_b[nz] = np.add.reduceat(t_badv, starts[nz])
    ok &= (sum_d == z["diffs"]) & (sum_b == be - bb)
    counts["alignments_invalid"] = int((~ok).sum())

    # sampled whole alignments of valid records, short and long
    span = ae - ab
    for pool, size in ((ok & (span <= ALN_MAX_SPAN), ALN_SAMPLES),
                       (ok & (span > ALN_MAX_SPAN), ALN_LONG_SAMPLES)):
        cand = np.flatnonzero(pool)
        for j in rng.choice(cand, size=min(size, len(cand)), replace=False):
            c0 = bounds[a_id[j] - 1, 0]
            read = reads[b_id[j] - 1]
            bseq = revcomp(read) if comp[j] else read
            ed = edit_distance(truth[c0 + ab[j] : c0 + ae[j]], bseq[bb[j] : be[j]])
            counts["alignments_sampled"] += 1
            counts["diffs_excess"] += int(z["diffs"][j]) - ed
            counts["diffs_optimal"] += ed
            counts["alignments_below_optimal"] += int(z["diffs"][j] < ed)
    counts.update(_unmapped(bounds, origins, a_id, b_id, comp, ab, ae, ok))

    if "chain_lens" in z.files:
        lens = z["chain_lens"].astype(np.int64)
        idx = z["chain_indices"].astype(np.int64)
        empty = lens <= 0
        counts["alignments_invalid"] += int(empty.sum())
        lens = lens[~empty]
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        if len(lens) and len(idx) == int(lens.sum()):
            member_ok = (idx >= 0) & (idx < n)
            m = np.where(member_ok, idx, 0)
            f = np.repeat(m[starts], lens)
            same = (member_ok & (a_id[m] == a_id[f]) & (b_id[m] == b_id[f])
                    & (comp[m] == comp[f]))
            chain_ok = np.logical_and.reduceat(same, starts)
            counts["alignments_invalid"] += int((~chain_ok).sum())
            lo = np.minimum.reduceat(ab[m], starts)
            hi = np.maximum.reduceat(ae[m], starts)
            first = m[starts]
            long = chain_ok & (hi - lo >= LONG_CHAIN) & ids_ok[first]
            c0 = bounds[a_id[first[long]] - 1, 0]
            o = origins[b_id[first[long]] - 1]
            off = ~((c0 + lo[long] < o[:, 1]) & (o[:, 0] < c0 + hi[long])) \
                | (o[:, 2].astype(bool) != comp[first[long]])
            counts["long_chains"] += int(long.sum())
            counts["chains_off_origin"] += int(off.sum())
        elif len(lens):
            counts["alignments_invalid"] += len(lens)
    return counts


def _unmapped(bounds, origins, a_id, b_id, comp, ab, ae, ok) -> dict:
    """``reads_unmapped_pct``'s and ``overlap_unaligned_pct``'s counts:
    the (read, contig) pairs whose true overlap is ``MAP_MIN_OVERLAP``
    bases or more, those with no valid alignment on the read's true
    strand over a base of it, their overlap bases and those no such
    alignment covers."""
    by_pair: dict[tuple[int, int, bool], list[tuple[int, int]]] = {}
    for j in np.flatnonzero(ok).tolist():
        by_pair.setdefault((int(b_id[j]), int(a_id[j]), bool(comp[j])), []).append(
            (int(ab[j]), int(ae[j])))
    c0, c1 = bounds[:, 0], bounds[:, 1]
    out = {"map_pairs": 0, "map_pairs_missing": 0, "map_bases": 0,
           "map_bases_missing": 0}
    for r, (o0, o1, oc) in enumerate(np.asarray(origins, np.int64).tolist()):
        k_lo = int(np.searchsorted(c1, o0, side="right"))
        k_hi = int(np.searchsorted(c0, o1, side="left"))
        for k in range(k_lo, k_hi):
            lo, hi = max(o0, int(c0[k])), min(o1, int(c1[k]))
            if hi - lo < MAP_MIN_OVERLAP:
                continue
            lo, hi = lo - int(c0[k]), hi - int(c0[k])
            covered, end = 0, lo
            for b, e in sorted(by_pair.get((r + 1, k + 1, bool(oc)), [])):
                b, e = max(b, end), min(e, hi)
                if e > b:
                    covered += e - b
                    end = e
            out["map_pairs"] += 1
            out["map_pairs_missing"] += int(covered == 0)
            out["map_bases"] += hi - lo
            out["map_bases_missing"] += hi - lo - covered
    return out


def check_insertions(truth, gaps, ins_path: str, joined) -> dict:
    """The consensus layer's counts for one unit (see the module doc):
    ``joined`` holds the (k, k + 1) contig pairs the output joins."""
    z = np.load(ins_path, allow_pickle=False)
    bounds = contig_bounds(len(truth), gaps)
    errors, other = [], 0
    so = 0
    for k in range(len(z["seq_lens"])):
        sl = int(z["seq_lens"][k])
        seq = z["sequences"][so : so + sl]
        so += sl
        (ca, pa), (cb, pb) = z["start"][k], z["end"][k]
        crop_a, crop_b = (int(x) for x in z["crop"][k])
        if not (cb == ca + 1 and pa == 2 and pb == 1 and 1 <= ca < len(bounds)):
            other += 1  # not a join of truth neighbours end -> begin
            continue
        if (int(ca), int(cb)) not in joined:
            continue
        lo = bounds[ca - 1, 1] - crop_a
        hi = bounds[cb - 1, 0] + crop_b
        errors.append(edit_distance(seq, truth[lo:hi]) if lo <= hi
                      else max(sl, lo - hi))
    return {"insertion_errors": errors, "insertions_other": other}


def check_unit(unit_dir: str, out_dir: str, rng: np.random.Generator) -> dict:
    """Every count of one unit: its inputs and truth in ``unit_dir``, the
    program's outputs in ``out_dir`` (workdir ``out_dir/work``)."""
    t = np.load(os.path.join(unit_dir, "truth.npz"), allow_pickle=False)
    truth, gaps = t["truth"], t["gaps"]
    reads = [c for _, c in read_fasta(os.path.join(unit_dir, "reads.fasta"))]
    counts = check_output(truth, gaps, out_dir)
    counts.update(check_alignments(truth, gaps, t["origins"], reads,
                                   os.path.join(out_dir, "work", "reads.las.npz"),
                                   rng))
    counts.update(check_insertions(truth, gaps,
                                   os.path.join(out_dir, "work", "insertions.npz"),
                                   counts.pop("joined")))
    counts["n_gaps"] = int(len(gaps))
    return counts


def numbers(units: list[dict]) -> dict:
    """The run's numbers from its units' counts."""
    n_gaps = sum(u["n_gaps"] for u in units)
    gap_err = [e for u in units for e in u["gap_errors"]]
    ins_err = [e for u in units for e in u["insertion_errors"]]
    total = {k: sum(u[k] for u in units) for k in (
        "contigs_lost", "false_joins", "agp_bed_mismatches",
        "alignments_invalid", "alignments_below_optimal", "chains_off_origin")}
    def pct(part: str, whole: str) -> float:
        return 100.0 * sum(u[part] for u in units) / max(sum(u[whole] for u in units), 1)

    return {
        **total,
        "reads_unmapped_pct": pct("map_pairs_missing", "map_pairs"),
        "overlap_unaligned_pct": pct("map_bases_missing", "map_bases"),
        "diffs_excess_pct": pct("diffs_excess", "diffs_optimal"),
        "gaps_wrong_pct": 100.0 * sum(u["gaps_wrong"] for u in units) / max(n_gaps, 1),
        "gap_errors_max": max(gap_err, default=0),
        "insertion_errors_max": max(ins_err, default=0),
    }


def info(units: list[dict]) -> dict:
    """Readings beside the numbers, not compared: counts behind them."""
    errs = [e for u in units for e in u["gap_errors"]]
    return {"units": len(units), "gaps": sum(u["n_gaps"] for u in units),
            "gaps_open": sum(u["gaps_open"] for u in units),
            "gap_errors": {str(e): errs.count(e) for e in sorted(set(errs)) if e},
            "insertions_other": sum(u["insertions_other"] for u in units),
            "alignments_sampled": sum(u["alignments_sampled"] for u in units),
            "map_pairs": sum(u["map_pairs"] for u in units),
            "long_chains": sum(u["long_chains"] for u in units)}


def judge(nums: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """``correct`` and (name, number, limit) for every limit: a number
    passes when it is at most its limit; a missing number fails."""
    rows = [(name, nums.get(name, float("inf")), float(lim))
            for name, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
