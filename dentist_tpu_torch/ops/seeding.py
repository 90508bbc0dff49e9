"""K-mer seeding: index construction, lookup, diagonal clustering.

Replaces daligner/damapper's k-mer (k=14) seed detection
(``SURVEY.md §2.3``: "k-mer seed → diagonal-band merge").  Design:

- The target ("A") side is one concatenated code array (the assembly
  contig store or a read store).  Its k-mers are encoded as 28-bit ints
  and sorted once — a *sorted-array index* rather than a hash table, so
  lookup is ``searchsorted`` (binary search), which vectorizes on both
  NumPy and TPU (``jnp.searchsorted`` = batched binary-search gathers).
- Query k-mers probe the sorted array; over-represented k-mers
  (``max_occ``) are dropped, which both bounds work and suppresses
  repeat-induced seed storms (daligner's masking serves this role).
- Seeds ``(a_pos, b_pos)`` are clustered by consistent diagonal drift
  into alignment candidates (daligner's diagonal-band merge): one sort
  over (query, strand, a_pos) and vectorized break-flag computation — no
  per-seed Python.

Positions in the index are *global* concatenated coordinates; candidates
are split at contig boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["KmerIndex", "SeedCandidate", "cluster_seeds",
           "cluster_seeds_batched", "kmer_codes"]

DEFAULT_K = 14


def kmer_codes(codes: np.ndarray, k: int = DEFAULT_K,
               stride: int = 1) -> np.ndarray:
    """Encode every ``stride``-th k-mer of a code array as an int.

    Positions sampled are 0, stride, 2·stride, …  ≤ len − k.  Uses int32
    when 2k ≤ 31 bits (k ≤ 15): half the memory traffic of int64 in the
    host seeding hot loop.
    """
    codes = np.asarray(codes)
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64 if 2 * k > 31 else np.int32)
    dt = np.int64 if 2 * k > 31 else np.int32
    m = (n + stride - 1) // stride
    out = np.zeros(m, dtype=dt)
    for t in range(k):
        out <<= 2
        out += codes[t : t + n : stride]
    return out


def _composite_sort(km: np.ndarray, pos: np.ndarray, n_total: int):
    """Sort (kmer, position) pairs by packing both into ONE int64 key.

    Equivalent to ``argsort(km, kind="stable")`` + two gathers (positions
    ascend within equal k-mers because the position occupies the low
    bits), but a single direct ``np.sort`` runs ~3× faster at genome
    scale — the index build was a measured ~12 s of the 28 Mb pipeline's
    masks+mapping stage.  Keys fit int64 for any 2k ≤ 31-bit k-mer and
    positions below 2^32.
    """
    if len(km) == 0:
        return km[:0], pos[:0]
    pos_bits = max(int(n_total).bit_length(), 1)
    keys = (km.astype(np.int64) << pos_bits) | pos
    keys.sort()
    # keep the original k-mer dtype (int32 for k ≤ 15 — the native
    # lookup kernel's expected layout)
    return (keys >> pos_bits).astype(km.dtype), keys & ((1 << pos_bits) - 1)


class KmerIndex:
    """Sorted k-mer index over a concatenated sequence store."""

    def __init__(
        self,
        codes: np.ndarray,
        offsets: np.ndarray,
        lengths: np.ndarray,
        k: int = DEFAULT_K,
        mask_intervals: np.ndarray | None = None,
        presorted: tuple[np.ndarray, np.ndarray] | None = None,
    ):
        """`mask_intervals`: (M, 3) region triples (contig_tag 1-based,
        local begin, local end) — the ``Region.iv`` layout every mask in
        the framework uses — or (M, 2) begin/end intervals already in
        *global* concatenated coordinates.  Seeds inside are suppressed
        (soft masking — daligner ``-m`` track semantics).

        ``presorted``: the content-only ``(sorted_kmers, sorted_pos)`` of
        the UNMASKED sequence (see :meth:`presort`) — the expensive
        argsort is shared across mask variants (the pipeline indexes the
        same assembly for self-alignment, mapping, and re-mapping with
        three different masks); stable filtering of a stable sort gives
        bit-identical index arrays.
        """
        self.k = k
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.ends = self.offsets + self.lengths
        n_km = max(len(codes) - k + 1, 0)
        # position validity: contig bounds + soft masking
        valid = np.ones(n_km, dtype=bool)
        for o in self.offsets[1:]:
            valid[max(0, o - k + 1) : o] = False
        if mask_intervals is not None and len(mask_intervals):
            mi = np.asarray(mask_intervals, dtype=np.int64)
            if mi.shape[1] == 3:
                # tagged LOCAL intervals → global concatenated coords
                # (previously the tag was dropped and local coordinates
                # were misread as global: masks on any contig but the
                # first landed at the wrong positions)
                base = self.offsets[mi[:, 0] - 1]
                mi = np.stack([mi[:, 1] + base, mi[:, 2] + base], axis=1)
            for b, e in mi:
                valid[max(0, b - k + 1) : e] = False
        if presorted is not None:
            km_s, pos_s = presorted
            keep = valid[pos_s]
            self.sorted_kmers = km_s[keep]
            self.sorted_pos = pos_s[keep]
        else:
            km = kmer_codes(codes, k)
            pos = np.arange(n_km, dtype=np.int64)
            km_s, pos_s = _composite_sort(km[valid], pos[valid], n_km)
            self.sorted_kmers = km_s
            self.sorted_pos = pos_s
        self._build_bucket_table()

    @staticmethod
    def presort(codes: np.ndarray, k: int = DEFAULT_K):
        """Content-only sorted (kmers, positions) for ``presorted=``."""
        n_km = max(len(codes) - k + 1, 0)
        km = kmer_codes(codes, k)
        return _composite_sort(km, np.arange(n_km, dtype=np.int64), n_km)

    def _build_bucket_table(self):
        """Direct-address acceleration for lookup.

        Binary search into the full sorted array is cache-miss bound
        (~24 ms per read); instead, unique k-mers are bucketed by their
        high 24 bits — each bucket holds ≤ 2^(2k−24) distinct k-mers
        (16 for k=14), so a fixed-width vectorized scan resolves a query
        in a handful of gathers.
        """
        sk = self.sorted_kmers
        if len(sk):  # already sorted: unique via run-boundary mask
            first = np.empty(len(sk), dtype=bool)
            first[0] = True
            np.not_equal(sk[1:], sk[:-1], out=first[1:])
            first = np.flatnonzero(first)
        else:
            first = np.empty(0, dtype=np.int64)
        self.unique_kmers = sk[first]
        self.unique_start = np.concatenate([first, [len(sk)]]).astype(np.int64)
        total_bits = 2 * self.k
        self._bucket_bits = min(24, total_bits)
        self._low_span = 1 << (total_bits - self._bucket_bits)
        if len(self.unique_kmers) < 1 << 17:
            self._bucket_start = None  # small index: plain searchsorted is fine
            return
        n_buckets = 1 << self._bucket_bits
        high = (self.unique_kmers >> (total_bits - self._bucket_bits)).astype(np.int64)
        # bincount beats np.add.at ~5× at genome scale (measured 1.7 s →
        # 0.3 s on 26 M uniques)
        self._bucket_start = np.zeros(n_buckets + 1, dtype=np.int64)
        counts = np.bincount(high, minlength=n_buckets)
        np.cumsum(counts, out=self._bucket_start[1:])

    def _lookup_ranges(self, qk: np.ndarray):
        """(start, count) into sorted_pos for each query k-mer."""
        if self._bucket_start is None:
            lo = np.searchsorted(self.unique_kmers, qk, side="left")
            lo = np.minimum(lo, len(self.unique_kmers) - 1) if len(self.unique_kmers) else lo
            found = (len(self.unique_kmers) > 0) & (self.unique_kmers[lo] == qk) if len(self.unique_kmers) else np.zeros(len(qk), bool)
            start = self.unique_start[lo]
            count = np.where(found, self.unique_start[lo + 1] - start, 0)
            return start, count
        total_bits = 2 * self.k
        # sort queries by k-mer so bucket-table gathers walk memory in
        # order (at 100 Mb+ index sizes the tables exceed cache and random
        # gathers become latency-bound)
        order = np.argsort(qk, kind="stable")
        qs = qk[order]
        b = (qs >> (total_bits - self._bucket_bits)).astype(np.int64)
        lo_u = self._bucket_start[b]
        hi_u = self._bucket_start[b + 1]
        U = len(self.unique_kmers)
        u_idx = np.zeros(len(qs), dtype=np.int64)
        found = np.zeros(len(qs), dtype=bool)
        for t in range(self._low_span):
            cand = lo_u + t
            ok = cand < hi_u
            safe = np.minimum(cand, U - 1)
            hit = ok & (self.unique_kmers[safe] == qs) & ~found
            u_idx = np.where(hit, cand, u_idx)
            found |= hit
        start_s = self.unique_start[u_idx]
        count_s = np.where(found, self.unique_start[u_idx + 1] - start_s, 0)
        start = np.empty_like(start_s)
        count = np.empty_like(count_s)
        start[order] = start_s
        count[order] = count_s
        return start, count

    def seq_id_of(self, global_pos: np.ndarray) -> np.ndarray:
        """Global position → 1-based sequence id."""
        return np.searchsorted(self.offsets, global_pos, side="right").astype(np.int64)

    def lookup(self, query_codes: np.ndarray, max_occ: int = 32):
        """Find seed hits of a query sequence.

        Returns (a_pos global, b_pos in query) int64 arrays.
        """
        return self.lookup_batch([query_codes], max_occ)[0]

    def lookup_batch(self, queries: list[np.ndarray], max_occ: int = 32,
                     stride: int = 1):
        """Batched :meth:`lookup`: one vectorized pass over all queries.

        Amortizes the per-call overhead of k-mer encoding and the bucket
        scan across a chunk of reads (the host-side seeding hot spot).
        `stride` samples every stride-th query k-mer — at ≥500 bp minimum
        alignment length and ≤30 % error, stride 2 keeps seeds every
        ~50-100 bp while halving lookup and clustering work.
        """
        if len(self.sorted_kmers) == 0:
            return [(np.empty(0, np.int64), np.empty(0, np.int64)) for _ in queries]
        if 2 * self.k <= 31 and queries:
            # native path: encode + probe + expand in one C++ pass per
            # query (ctypes releases the GIL, so the seeding thread pool
            # parallelizes for real — the numpy path was the mapping
            # stage's host bottleneck)
            from ..native import seed_lookup

            qoffs = np.zeros(len(queries) + 1, dtype=np.int64)
            np.cumsum([len(q) for q in queries], out=qoffs[1:])
            qcodes = np.concatenate(
                [np.ascontiguousarray(q, dtype=np.uint8) for q in queries])
            res = seed_lookup(qcodes, qoffs, self.k, stride, max_occ,
                              self.unique_kmers, self.unique_start,
                              self._bucket_start, self._bucket_bits,
                              self.sorted_pos)
            if res is not None:
                offs, a_pos, b_pos = res
                return [(a_pos[offs[q] : offs[q + 1]],
                         b_pos[offs[q] : offs[q + 1]])
                        for q in range(len(queries))]
        kms = [kmer_codes(q, self.k, stride) for q in queries]
        lens = np.array([len(k) for k in kms], dtype=np.int64)
        bounds = np.concatenate([[0], np.cumsum(lens)])
        if bounds[-1] == 0:
            return [(np.empty(0, np.int64), np.empty(0, np.int64)) for _ in queries]
        qk = np.concatenate([k for k in kms if len(k)])
        start, occ = self._lookup_ranges(qk)
        use = (occ > 0) & (occ <= max_occ)
        lo, occ_u = start[use], occ[use]
        flat_bpos = np.flatnonzero(use)
        total = int(occ_u.sum())
        if total == 0:
            return [(np.empty(0, np.int64), np.empty(0, np.int64)) for _ in queries]
        rep_flat = np.repeat(flat_bpos, occ_u)
        starts = np.repeat(lo, occ_u)
        within = np.arange(total) - np.repeat(np.cumsum(occ_u) - occ_u, occ_u)
        a_pos = self.sorted_pos[starts + within]
        # split per query: rep_flat is nondecreasing
        cut = np.searchsorted(rep_flat, bounds)
        out = []
        for qi in range(len(queries)):
            s, e = cut[qi], cut[qi + 1]
            bpos = (rep_flat[s:e] - bounds[qi]).astype(np.int64) * stride
            out.append((a_pos[s:e], bpos))
        return out


@dataclass
class SeedCandidate:
    """A diagonal-consistent seed cluster = one alignment candidate."""

    a_seq: int  # 1-based id on the indexed side
    complement: bool  # query was reverse-complemented
    a_pos: np.ndarray  # seed positions, local to a_seq
    b_pos: np.ndarray  # seed positions in query (aligned strand)
    n_seeds: int = 0

    def __post_init__(self):
        self.n_seeds = len(self.a_pos)

    @property
    def a_span(self) -> tuple[int, int]:
        return int(self.a_pos.min()), int(self.a_pos.max())

    @property
    def b_span(self) -> tuple[int, int]:
        return int(self.b_pos.min()), int(self.b_pos.max())


def cluster_seeds(
    index: KmerIndex,
    a_pos: np.ndarray,
    b_pos: np.ndarray,
    complement: bool,
    max_gap: int = 2000,
    slope_slack: int = 80,
    slope_frac: float = 0.35,
    min_seeds: int = 3,
    min_span: int = 100,
    exclude_identity_seq: int | None = None,
    min_density_per_kb: float = 5.0,
) -> list[SeedCandidate]:
    """Group seeds of ONE query into diagonal-consistent candidates.

    Seeds sorted by a_pos are split whenever the next seed jumps more than
    `max_gap` in A, or its diagonal drifts more than
    ``slope_slack + slope_frac * Δa`` (indel drift tolerance at ≤30%
    error), or it crosses a contig boundary.  `exclude_identity_seq`
    drops the trivial self-identity diagonal when aligning a sequence
    store against itself (daligner skips the identity alignment).
    """
    return cluster_seeds_batched(
        index, [(a_pos, b_pos)], [complement],
        max_gap=max_gap, slope_slack=slope_slack, slope_frac=slope_frac,
        min_seeds=min_seeds, min_span=min_span,
        exclude_identity_seqs=[exclude_identity_seq],
        min_density_per_kb=min_density_per_kb,
    )[0]


def cluster_seeds_batched(
    index: KmerIndex,
    seeds: list[tuple[np.ndarray, np.ndarray]],
    complements: list[bool],
    max_gap: int = 2000,
    slope_slack: int = 80,
    slope_frac: float = 0.35,
    min_seeds: int = 3,
    min_span: int = 100,
    exclude_identity_seqs: list[int | None] | None = None,
    min_density_per_kb: float = 5.0,
) -> list[list[SeedCandidate]]:
    """:func:`cluster_seeds` over a whole chunk of (query, strand) groups.

    One concatenated sweep replaces per-query numpy passes — the host
    seeding hot spot is call overhead, not element count.  ``seeds[g]``
    is that group's ``(a_pos, b_pos)``; groups never merge (the group id
    is the senior sort key).  Returns one candidate list per group.
    """
    G = len(seeds)
    out: list[list[SeedCandidate]] = [[] for _ in range(G)]
    lens = np.array([len(ap) for ap, _ in seeds], dtype=np.int64)
    if lens.sum() == 0:
        return out
    gid = np.repeat(np.arange(G, dtype=np.int64), lens)
    a_pos = np.concatenate([np.asarray(ap) for ap, _ in seeds if len(ap)])
    b_pos = np.concatenate([np.asarray(bp) for _, bp in seeds if len(bp)])
    seq_ids = index.seq_id_of(a_pos)
    a_local = a_pos - index.offsets[seq_ids - 1]
    if exclude_identity_seqs is not None:
        excl = np.array([-1 if e is None or complements[g] else e
                         for g, e in enumerate(exclude_identity_seqs)],
                        dtype=np.int64)
        keep = ~((seq_ids == excl[gid]) & (a_local == b_pos))
        if not keep.all():
            gid, seq_ids, a_local, b_pos = (
                gid[keep], seq_ids[keep], a_local[keep], b_pos[keep])
            if len(a_local) == 0:
                return out
    diag = a_local - b_pos
    # Pass 1: vectorized sweep within (group, seq, coarse diagonal band)
    # buckets.  Indel drift can carry one true alignment across several
    # bands, so pass 2 merges band-local sub-clusters by endpoint
    # continuity (daligner's diagonal-band merge).
    band = diag // (4 * slope_slack)
    order = np.lexsort((a_local, band, seq_ids, gid))
    gid, seq_ids, a_local, b_pos, diag, band = (
        gid[order], seq_ids[order], a_local[order], b_pos[order],
        diag[order], band[order],
    )
    da = np.diff(a_local)
    ddiag = np.abs(np.diff(diag))
    brk = np.ones(len(a_local), dtype=bool)
    brk[1:] = (
        (gid[1:] != gid[:-1])
        | (seq_ids[1:] != seq_ids[:-1])
        | (band[1:] != band[:-1])
        | (np.abs(da) > max_gap)
        | (ddiag > slope_slack + slope_frac * np.abs(da))
    )
    starts = np.flatnonzero(brk)
    ends = np.concatenate([starts[1:], [len(a_local)]])
    big = (ends - starts) >= 2  # singleton hits are noise
    starts, ends = starts[big], ends[big]
    # per-sub-cluster summaries (seeds within a cluster are a-sorted by
    # the lexsort, so endpoints are first/last — no per-cluster argsort)
    lasts = ends - 1
    sub_g = gid[starts]
    sub_seq = seq_ids[starts]
    sub_a0, sub_a1 = a_local[starts], a_local[lasts]
    sub_b0, sub_b1 = b_pos[starts], b_pos[lasts]

    # Pass 2: greedy merge of sub-clusters sorted by (group, seq, a_start)
    # — native (GIL-released; the Python loop over millions of
    # sub-clusters serialized the seeding thread pool at genome scale),
    # with an identical pure-Python fallback.
    o2 = np.lexsort((sub_b0, sub_a0, sub_seq, sub_g))
    cols = np.stack([sub_g[o2], sub_seq[o2], sub_a0[o2], sub_a1[o2],
                     sub_b0[o2], sub_b1[o2]], axis=1)
    cs_all, ce_all = starts[o2], ends[o2]
    from ..native import seed_merge

    res = seed_merge(cols, max_gap, slope_slack, slope_frac)
    if res is not None:
        assign, bounds = res
    else:
        M = len(cols)
        assign = np.empty(M, dtype=np.int64)
        blist: list[list] = []  # [g, seq, a0, a1, b0, b1]
        for r, (g, sq, a0, a1, b0, b1) in enumerate(cols.tolist()):
            attached = False
            for mi in range(len(blist) - 1, max(len(blist) - 9, -1), -1):
                m = blist[mi]
                if m[0] != g or m[1] != sq:
                    continue
                gap_a = a0 - m[3]
                gap_b = b0 - m[5]
                if gap_a > max_gap:
                    continue
                if abs(gap_a - gap_b) <= slope_slack + slope_frac * max(
                        abs(gap_a), abs(gap_b)):
                    m[3] = max(m[3], a1)
                    m[5] = max(m[5], b1)
                    assign[r] = mi
                    attached = True
                    break
            if not attached:
                assign[r] = len(blist)
                blist.append([g, sq, a0, a1, b0, b1])
        bounds = (np.array(blist, dtype=np.int64).reshape(-1, 6)
                  if blist else np.empty((0, 6), np.int64))

    # vectorized filters over merged clusters (only survivors — a few
    # percent — materialize seed arrays and Python objects)
    K = len(bounds)
    if K == 0:
        return out
    n_m = np.bincount(assign, weights=(ce_all - cs_all),
                      minlength=K).astype(np.int64)
    span = bounds[:, 3] - bounds[:, 2]
    # seed-density filter: true alignments at ≤30 % error carry tens
    # of k=14 seeds per kb, while random k-mer triples that cluster
    # by chance are sparse over long spans — and their count grows
    # linearly with genome size, flooding the extension engine at
    # 100 Mb+ scale (daligner's hit-bases threshold serves this role)
    keep = ((n_m >= min_seeds) & (span >= min_span)
            & (n_m >= min_seeds + span * min_density_per_kb / 1000.0))
    if not keep.any():
        return out
    rows = np.flatnonzero(keep[assign])
    o3 = np.argsort(assign[rows], kind="stable")  # creation order
    rows = rows[o3]
    ids = assign[rows]
    cut = np.flatnonzero(np.diff(ids)) + 1
    for grp_rows in np.split(rows, cut):
        mid = int(assign[grp_rows[0]])
        g, sq = int(bounds[mid, 0]), int(bounds[mid, 1])
        if len(grp_rows) == 1:
            s, e = int(cs_all[grp_rows[0]]), int(ce_all[grp_rows[0]])
            ap, bp = a_local[s:e], b_pos[s:e]
        else:
            ap = np.concatenate([a_local[int(cs_all[r]) : int(ce_all[r])]
                                 for r in grp_rows])
            bp = np.concatenate([b_pos[int(cs_all[r]) : int(ce_all[r])]
                                 for r in grp_rows])
            o4 = np.argsort(ap, kind="stable")
            ap, bp = ap[o4], bp[o4]
        out[g].append(SeedCandidate(sq, complements[g], ap, bp))
    return out
