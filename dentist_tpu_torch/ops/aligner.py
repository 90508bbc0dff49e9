"""Alignment engine driver: seeds → banded extension → trace-point LAs.

Port of ``dentist_tpu/ops/aligner.py``: the host driver is the same —
window buckets, lane buckets, slope-binned flushes of ≤ 8 band schedules,
batch size and flush order are unchanged, because a lane's band schedule
is its bin's mean slope and the records therefore depend on which jobs
share a flush.  A flush runs K1 on windows gathered from the resident
device store (:func:`dentist_tpu_torch.ops.banded.extend`) or, when the
stores do not fit it or under a data-parallel group, on windows the
host assembled and 2-bit packed (K1p,
:func:`dentist_tpu_torch.ops.banded.extend_batch_packed`, whose lanes
split over the group's ranks).

The daligner/damapper/datander replacement (SURVEY §2.3).  One engine,
three drivers:

- :func:`align_store_pair` — generic "align every query against the
  indexed target" (self-alignment when query store *is* the target store,
  with the identity diagonal suppressed — daligner semantics).
- Mapping (damapper) and tandem (datander) behaviors are thin
  parameterizations built on top (see :mod:`dentist_tpu_torch.models.mask`
  and the pipeline stages).

Flow per query & strand: k-mer lookup → diagonal clustering
(:mod:`.seeding`) → per candidate, snap an anchor to a 126-multiple of A
and extend bidirectionally with the batched banded DP (:mod:`.banded`).
Jobs are bucketed by window length into power-of-two-ish row counts so
each bucket is one static-shape dispatch; buckets flush when full.

Trace points every 126 bp of A are extracted from the per-row DP output;
local-alignment ends are the score-argmax rows (daligner's ≤30 % error
model, see :data:`.banded.DIFF_PENALTY`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..io.fasta import reverse_complement
from ..models.alignments import TRACE_SPACING, LocalAlignmentSet
from ..parallel.dp import dispatch_workers, pad_lanes
from ..utils import trace
from ..utils.log import log_json
from .seeding import (KmerIndex, SeedCandidate, cluster_seeds,
                      cluster_seeds_batched)

__all__ = ["AlignerConfig", "Aligner", "align_store_pair"]

#: window-length buckets, the JAX package's (factor-3 steps, capped at
#: 32256): a job's bucket decides which jobs share a flush, and so its
#: band schedule and its records — parity needs the same buckets
_BUCKETS = [504, 1512, 4536, 13608, 32256]


@dataclass
class AlignerConfig:
    k: int = 14
    max_occ: int = 48  # drop k-mers with more index hits (repeat storm guard)
    #: band width around the shared linear band schedule; must absorb each
    #: lane's drift from the flush's common slope (σ ≈ √(0.1·L))
    band_width: int = 256
    min_seeds: int = 3
    min_span: int = 100
    max_seed_gap: int = 2000
    #: minimum seeds per kb of candidate A-span: random k-mer clusters
    #: grow linearly with genome size and would flood the extension
    #: engine; true alignments at ≤25 % error carry ≥10 seeds/kb
    min_seed_density: float = 4.0
    #: cap on extension candidates per query (both strands, largest
    #: A-spans kept; 0 = unlimited): reads from repeat loci seed against
    #: the unmasked edge stubs of every copy (coverage-mask ramps) —
    #: their true locus always carries the longest span, and damapper
    #: likewise reports only the best few chains.  Read mapping enables
    #: this (MapperConfig); self-alignment/datander must NOT (a whole
    #: contig legitimately yields one candidate per repeat-copy pair)
    max_candidates: int = 0
    #: minimum local alignment length, (a_len+b_len)/2 — daligner -l
    min_length: int = 500
    #: maximum error rate 2*diffs/(a_len+b_len) — daligner 1-e
    max_error: float = 0.32
    #: jobs per bucket flush: the extension scan's per-row latency is
    #: ~independent of the lane count (the op-chain dominates), so wide
    #: dispatches amortize it — 1024 lanes ≈ 4× the per-lane throughput
    #: of 128 (measured on v5e)
    batch_size: int = 1024
    #: sample every Nth query k-mer during seeding (2 halves host seeding
    #: cost; sensitivity unaffected at ≥500bp alignments)
    query_stride: int = 2
    #: overlap fraction (A and B) above which two LAs are duplicates
    dedup_overlap: float = 0.5
    #: host seeding thread-pool size (lookups release the GIL in native
    #: code and overlap device dispatches; scales with the host — a
    #: v5e-8 host has ~112 vCPUs vs this dev box's 4)
    seed_threads: int = max(2, min(16, (os.cpu_count() or 4)))


def _bucket_for(r: int) -> int:
    for b in _BUCKETS:
        if r <= b:
            return b
    return _BUCKETS[-1]


_SLOPE_MIN, _SLOPE_MAX = 0.7, 1.4
#: lane-count sub-buckets (the JAX package's): small flushes dispatch
#: with few padded lanes
_LANE_BUCKETS = (128, 1024)


def _slope_bin_width(bucket: int, W: int) -> float:
    """Jobs sharing a flush must deviate ≲ W/4 from its mean slope over
    the whole window; narrower bins for long windows fragment dispatches,
    so the width floors at 0.02 (seed-estimated slopes are tight and
    alignments rarely ride the band edge for the full window)."""
    return max(0.02, W / (4.0 * bucket))


@dataclass
class _Job:
    cand_idx: int
    direction: int  # +1 forward, -1 backward
    a_chars: np.ndarray  # (R_valid,) codes
    b_chars: np.ndarray  # full B-side strand sequence (view)
    b_anchor: int  # b0 for forward, b0 for backward (chars taken from there)
    b_rem: int  # valid B length in this direction
    slope: float  # seed-estimated b-advance per a-advance
    r_valid: int
    #: >0: self-alignment with this identity-diagonal offset (a0 − b0);
    #: the kernel excludes the identity diagonal for these lanes
    self_unit: int = 0
    #: device-resident dispatch coordinates (None when unavailable):
    #: absolute anchor in the flat target store, raw-read flat offset,
    #: raw-read length, and whether b_chars is the reverse complement
    a_abs0: int | None = None
    q_roff: int = 0
    q_len: int = 0
    comp: bool = False


@dataclass
class _CandState:
    a_id: int
    b_id: int
    complement: bool
    a0: int
    b0: int
    n_seeds: int
    fwd: tuple | None = None  # (r, j, d, score, trace_j, trace_d)
    bwd: tuple | None = None


class Aligner:
    """Aligns query sequences against an indexed target store."""

    def __init__(self, index: KmerIndex, target_codes: np.ndarray,
                 config: AlignerConfig | None = None, query_store=None,
                 group=None):
        self.index = index
        self.target_codes = target_codes
        self.cfg = config or AlignerConfig()
        #: :class:`~dentist_tpu_torch.parallel.dp.DPGroup` (or None): every
        #: flush's lanes split over its ranks, results gathered
        self.group = group
        #: (codes, offsets) of the flat query store: enables the
        #: device-resident dispatch path, where extension windows are
        #: gathered from the device store instead of being assembled on
        #: the host per lane.  Falls back to host windows without it,
        #: under a group (each rank ships its own lanes), or when disabled
        #: (``DENTIST_TPU_NO_RESIDENT``).
        self._query_store = query_store
        self._use_resident = (
            query_store is not None and group is None
            and not os.environ.get("DENTIST_TPU_NO_RESIDENT"))
        #: pending jobs keyed by (bucket, slope_bin)
        self._pending: dict[tuple[int, int], list[_Job]] = {}
        self._inflight: list[tuple[list[_Job], object]] = []  # async dispatches
        self._cands: list[_CandState] = []
        #: window building + dispatch run off the main thread: the numpy
        #: array assembly per flush is a few hundred ms at genome scale
        #: and the main thread is the clustering bottleneck
        from concurrent.futures import ThreadPoolExecutor

        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=dispatch_workers(2))

    # ------------------------------------------------------------------
    def _target_seq(self, a_id: int) -> np.ndarray:
        o = self.index.offsets[a_id - 1]
        return self.target_codes[o : o + self.index.lengths[a_id - 1]]

    def _make_jobs(self, cand: SeedCandidate, b_codes: np.ndarray, b_id: int,
                   self_tandem: bool = False):
        """Anchor a candidate and enqueue forward/backward extension jobs.

        ``self_tandem``: the query IS the target sequence (datander
        mode); jobs carry the identity-diagonal offset so the kernel
        cannot align the sequence to itself.
        """
        cfg = self.cfg
        W = cfg.band_width
        a_seq = self._target_seq(cand.a_seq)
        a_len, b_len = len(a_seq), len(b_codes)
        ap, bp = cand.a_pos, cand.b_pos
        ap_first, ap_last = int(ap[0]), int(ap[-1])
        # first occurrence of the last distinct a position (interpolation
        # nodes are first-occurrence (a, b) pairs; ap is sorted)
        j_last = int(np.searchsorted(ap, ap_last, side="left"))
        bp_first, bp_last = int(bp[0]), int(bp[j_last])

        # anchor: the multiple of TRACE_SPACING nearest the cluster middle
        # whose seed-interpolated b is valid.  Probing anchors outward from
        # the middle (nearer first; ties toward the smaller a0) finds the
        # same anchor as scoring every multiple in the cluster span, but
        # touches O(1) of them in the common all-valid case.
        a_mid = (ap_first + ap_last) // 2
        k_lo = max(ap_first // TRACE_SPACING, 0)
        k_hi = min(ap_last // TRACE_SPACING + 1, a_len // TRACE_SPACING)
        if k_lo > k_hi:
            return

        def b_at(a0: int) -> int:
            if a0 <= ap_first:  # slope-1 (diagonal) extrapolation
                return bp_first - (ap_first - a0)
            if a0 >= ap_last:
                return bp_last + (a0 - ap_last)
            i = int(np.searchsorted(ap, a0, side="left"))
            x1 = int(ap[i])
            if x1 == a0:
                return int(bp[i])
            x0 = int(ap[i - 1])
            j = int(np.searchsorted(ap, x0, side="left"))
            y0, y1 = int(bp[j]), int(bp[i])
            # float op order mirrors np.interp so truncation matches
            return int((y1 - y0) / (x1 - x0) * (a0 - x0) + y0)

        k_mid = min(max(int(round(a_mid / TRACE_SPACING)), k_lo), k_hi)
        a0 = b0 = None
        # fast path (the overwhelmingly common case): the middle anchor is
        # interior to the seed span, so its interpolated b lies between
        # seed b's and is always valid — one lookup, no ring probe.  The
        # ring would stop at step 0 with the same anchor (a probe hit at
        # step 0 bounds last_step to 1, and any step-1 tie loses on the
        # strict |Δ| comparison or the a0 tie-break only when equal —
        # equality at step 1 means k_mid was rounded, handled below).
        fast = ap_first <= k_mid * TRACE_SPACING <= ap_last
        if fast:
            cand_a0 = k_mid * TRACE_SPACING
            cand_b0 = b_at(cand_a0)
            if 0 <= cand_b0 <= b_len:
                a0, b0 = cand_a0, cand_b0
                # a step-1 neighbor can tie |Δa| only when a_mid sits
                # exactly between two multiples; prefer the smaller a0
                # (the ring's tie-break)
                alt = (k_mid - 1) * TRACE_SPACING
                if (k_mid - 1 >= k_lo and abs(alt - a_mid) == abs(cand_a0 - a_mid)
                        and alt < cand_a0):
                    alt_b0 = b_at(alt)
                    if 0 <= alt_b0 <= b_len:
                        a0, b0 = alt, alt_b0
        if a0 is None:
            last_step = k_hi - k_lo  # probe every ring until one past a hit
            for step in range(k_hi - k_lo + 1):
                if step > last_step:
                    break
                for k in ((k_mid - step, k_mid + step) if step else (k_mid,)):
                    if not k_lo <= k <= k_hi:
                        continue
                    cand_a0 = k * TRACE_SPACING
                    cand_b0 = b_at(cand_a0)
                    if 0 <= cand_b0 <= b_len:
                        if (
                            a0 is None
                            or abs(cand_a0 - a_mid) < abs(a0 - a_mid)
                            or (abs(cand_a0 - a_mid) == abs(a0 - a_mid) and cand_a0 < a0)
                        ):
                            a0, b0 = cand_a0, cand_b0
                        # adjacent ring may tie in |a0 − a_mid|; farther not
                        last_step = min(last_step, step + 1)
        if a0 is None:
            return

        self_unit = 0
        if self_tandem:
            self_unit = a0 - b0
            if self_unit < 1:
                return  # anchor on/past the identity diagonal: not a tandem

        ci = len(self._cands)
        self._cands.append(
            _CandState(cand.a_seq, b_id, cand.complement, a0, b0, cand.n_seeds)
        )

        # seed-estimated slope (b advance per a advance)
        if ap_last > ap_first:
            slope = (bp_last - bp_first) / (ap_last - ap_first)
        else:
            slope = 1.0
        slope = float(np.clip(slope, _SLOPE_MIN, _SLOPE_MAX))

        # device-resident dispatch coordinates (see _build_and_dispatch)
        a_abs0 = None
        q_roff = q_len = 0
        comp = bool(cand.complement)
        if self._use_resident:
            codes_q, offs_q = self._query_store
            a_abs0 = int(self.index.offsets[cand.a_seq - 1]) + a0
            q_roff = int(offs_q[b_id - 1])
            q_len = b_len

        # forward job (window capped at the largest bucket)
        a_rem, b_rem = a_len - a0, b_len - b0
        r_f = int(min(a_rem, b_rem / slope + W, _BUCKETS[-1]))
        if r_f > 0:
            self._enqueue(_Job(ci, +1, a_seq[a0 : a0 + r_f], b_codes, b0, b_rem,
                               slope, r_f, self_unit, a_abs0=a_abs0,
                               q_roff=q_roff, q_len=q_len, comp=comp))
        # backward job (mirrored coordinates)
        r_b = int(min(a0, b0 / slope + W, _BUCKETS[-1]))
        if r_b > 0:
            self._enqueue(_Job(ci, -1, a_seq[a0 - r_b : a0][::-1], b_codes, b0, b0,
                               slope, r_b, self_unit, a_abs0=a_abs0,
                               q_roff=q_roff, q_len=q_len, comp=comp))

    def _enqueue(self, job: _Job):
        key = _bucket_for(job.r_valid)
        self._pending.setdefault(key, []).append(job)
        if len(self._pending[key]) >= self.cfg.batch_size:
            self._flush_group(key)

    #: schedules per dispatch (the JAX package's; slope binning uses it)
    _KMAX = 8

    def _flush_group(self, key: int):
        all_jobs = self._pending.get(key, [])
        if not all_jobs:
            return
        cfg = self.cfg
        W = cfg.band_width
        R = bucket = key
        bin_w = _slope_bin_width(bucket, W)
        # group by quantized slope into ≤ KMAX schedules; overflow bins
        # stay pending for the next flush
        bins: dict[int, list[_Job]] = {}
        for j in all_jobs:
            bins.setdefault(int(round(j.slope / bin_w)), []).append(j)
        by_size = sorted(bins, key=lambda b: -len(bins[b]))
        taken = by_size[: self._KMAX]
        self._pending[key] = [j for b in by_size[self._KMAX :] for j in bins[b]]
        jobs = [j for b in taken for j in bins[b]]
        lane_k = np.concatenate([
            np.full(len(bins[b]), ki, dtype=np.int32) for ki, b in enumerate(taken)
        ])
        # K fixed at _KMAX, as in the JAX package.  Schedules travel as
        # rational slopes (num_k); the kernel expands them to
        # offs_k[r] = (r·num)//R − W/2.
        K = self._KMAX
        num_k = np.zeros(K, dtype=np.int32)
        for ki, b in enumerate(taken):
            slope = float(np.mean([j.slope for j in bins[b]]))
            num_k[ki] = int(round(slope * R))
        for ki in range(len(taken), K):
            num_k[ki] = num_k[0]

        # pad to the smallest lane sub-bucket: little padded compute on
        # fragmented flushes
        N = next((lb for lb in _LANE_BUCKETS if len(jobs) <= lb),
                 -(-len(jobs) // _LANE_BUCKETS[-1]) * _LANE_BUCKETS[-1])
        N = pad_lanes(N, self.group)  # lanes split evenly over the ranks
        trace.count("k1.lanes_live", len(jobs))
        trace.count("k1.lanes_launched", N)
        lane_k = np.concatenate([lane_k, np.zeros(N - len(jobs), dtype=np.int32)])
        # window assembly + device dispatch off-thread: the main thread
        # is the clustering bottleneck and the device queue is async
        out = self._dispatch_pool.submit(
            self._build_and_dispatch, jobs, lane_k, num_k, R, N, W)
        self._inflight.append((jobs, out))

    def _build_and_dispatch(self, jobs, lane_k, num_k, R, N, W):
        from .banded import DIAG_UNBOUNDED, bw_for, extend_batch_packed

        if self._use_resident:
            try:
                return self._dispatch_resident(jobs, lane_k, num_k, R, N, W)
            except MemoryError:
                # stores exceed the device store: host-window dispatch
                # gives identical records (the windows travel instead)
                self._use_resident = False
        BW = bw_for(R, W)
        a_win = np.zeros((N, R), dtype=np.uint8)
        b_win = np.zeros((N, BW), dtype=np.uint8)
        a_lens = np.zeros(N, dtype=np.int32)
        b_lens = np.zeros(N, dtype=np.int32)
        diag_lo = np.full(N, -DIAG_UNBOUNDED, dtype=np.int32)
        diag_hi = np.full(N, DIAG_UNBOUNDED, dtype=np.int32)
        for n, j in enumerate(jobs):
            if j.self_unit > 0:  # exclude the identity diagonal
                if j.direction > 0:
                    diag_hi[n] = j.self_unit - 1
                else:
                    diag_lo[n] = -(j.self_unit - 1)
            a_win[n, : j.r_valid] = j.a_chars
            a_lens[n] = j.r_valid
            b_span = int(num_k[lane_k[n]]) + W // 2  # offs_k[-1, lane] + W
            b_lens[n] = min(j.b_rem, b_span)
            # B chars for this direction: forward = b_chars[b0:], backward =
            # reversed b_chars[:b0]; columns j+W hold B[j] for j ≥ -W.
            if j.direction > 0:
                src = j.b_chars[max(0, j.b_anchor - W) : j.b_anchor + BW - W]
                lead = W - min(W, j.b_anchor)  # columns with no B char
                b_win[n, lead : lead + len(src)] = src
            else:
                rev = j.b_chars[max(0, j.b_anchor - (BW - W)) : j.b_anchor + W][::-1]
                lead = W - min(W, len(j.b_chars) - j.b_anchor)
                b_win[n, lead : lead + len(rev)] = rev
        # the windows go to the device 2-bit packed, one row per lane;
        # the launch is asynchronous, so the device computes while the
        # host seeds more (under a group the gather waits for it)
        return extend_batch_packed(a_win, b_win, a_lens, b_lens, num_k,
                                   lane_k, W=W, diag_lo=diag_lo,
                                   diag_hi=diag_hi, group=self.group)

    def _dispatch_resident(self, jobs, lane_k, num_k, R, N, W):
        """Metadata-only dispatch against the resident device store.

        Reproduces `_build_and_dispatch`'s window contents exactly —
        slice starts, per-lane reversal (backward jobs), complementation
        (reverse-strand queries), and zero masking outside the valid
        range are all computed here as coordinates and applied by the
        kernel, so it sees byte-identical inputs while the host ships 12
        int32s per lane instead of the assembled window chars.
        """
        from .banded import DIAG_UNBOUNDED, bw_for, device_store, extend

        BW = bw_for(R, W)
        q_codes = self._query_store[0]
        store = device_store()
        with store.lock:  # both offsets + array from one store state
            for _attempt in range(3):
                epoch0 = store.epoch
                tgt_base = store.offset_of(self.target_codes)
                q_base = (tgt_base if q_codes is self.target_codes
                          else store.offset_of(q_codes))
                # the second upload may reset a full store, invalidating
                # the first offset — redo both from the fresh store
                if store.epoch == epoch0:
                    break
            else:
                raise MemoryError("target + query stores do not fit the "
                                  "device store together")
            arena = store.array
        meta = np.zeros((12, N), dtype=np.int32)
        meta[10] = -DIAG_UNBOUNDED
        meta[11] = DIAG_UNBOUNDED
        for n, j in enumerate(jobs):
            if j.self_unit > 0:
                if j.direction > 0:
                    meta[11, n] = j.self_unit - 1
                else:
                    meta[10, n] = -(j.self_unit - 1)
            fwd = j.direction > 0
            # A window: rows consume target chars outward from the anchor
            meta[0, n] = (tgt_base + j.a_abs0 if fwd
                          else tgt_base + j.a_abs0 - R)
            meta[1, n] = 0 if fwd else 1
            meta[2, n] = j.r_valid
            # B window: column c holds oriented-query char jb(c); the
            # oriented index maps to the raw read as (L-1-jb) when the
            # query is the reverse complement
            anchor, L, roff = j.b_anchor, j.q_len, q_base + j.q_roff
            if fwd:
                c_lo = max(0, W - anchor)
                c_hi = c_lo + min(L, anchor + BW - W) - max(0, anchor - W)
                if j.comp:
                    f0, s2 = roff + L - 1 - anchor + W, -1
                else:
                    f0, s2 = roff + anchor - W, +1
            else:
                c_lo = max(0, W - L + anchor)
                c_hi = c_lo + min(L, anchor + W) - max(0, anchor - BW + W)
                if j.comp:
                    f0, s2 = roff + L - anchor - W, +1
                else:
                    f0, s2 = roff + anchor + W - 1, -1
            meta[3, n] = f0 if s2 > 0 else f0 - (BW - 1)
            meta[4, n] = 0 if s2 > 0 else 1
            meta[5, n] = 1 if j.comp else 0
            meta[6, n] = c_lo
            meta[7, n] = max(c_lo, c_hi)
            b_span = int(num_k[lane_k[n]]) + W // 2
            meta[8, n] = min(j.b_rem, b_span)
            meta[9, n] = lane_k[n]
        return extend(arena, torch.from_numpy(meta).to(arena.device), num_k,
                      R=R, W=W)

    def _drain(self):
        from concurrent.futures import ThreadPoolExecutor

        from .banded import unpack_extension

        # the fetch is the synchronization point with the device (and
        # with the dispatch pool's window assembly)
        with trace.span("wait.device"):
            with ThreadPoolExecutor(max_workers=4) as ex:
                results = list(ex.map(
                    lambda jf: unpack_extension(jf[1].result()), self._inflight))
        with trace.span("map.drain.summarize"):
            for (jobs, _), (r_end, j_end, d_end, s_end, trace_j, trace_d) in zip(
                    self._inflight, results):
                for n, j in enumerate(jobs):
                    res = _summarize(int(r_end[n]), int(j_end[n]), int(d_end[n]),
                                     int(s_end[n]), trace_j[:, n], trace_d[:, n])
                    cand = self._cands[j.cand_idx]
                    if j.direction > 0:
                        cand.fwd = res
                    else:
                        cand.bwd = res
        self._inflight = []

    # ------------------------------------------------------------------
    def align_query(self, b_codes: np.ndarray, b_id: int,
                    exclude_identity: bool = False,
                    strands: tuple = (False, True),
                    seeds: dict | None = None,
                    self_tandem: bool = False):
        """Enqueue all candidates of one query (both strands by default).

        `seeds` optionally supplies precomputed {strand: (a_pos, b_pos)}
        from a batched lookup.  ``self_tandem`` marks the query as the
        target sequence itself (datander mode: identity diagonal
        excluded in the extension kernel).
        """
        cfg = self.cfg
        for comp in strands:
            q = reverse_complement(b_codes) if comp else b_codes
            if seeds is not None and comp in seeds:
                a_pos, b_pos = seeds[comp]
            else:
                a_pos, b_pos = self.index.lookup(q, max_occ=cfg.max_occ)
            cands = cluster_seeds(
                self.index, a_pos, b_pos, comp,
                max_gap=cfg.max_seed_gap, min_seeds=cfg.min_seeds,
                min_span=cfg.min_span,
                exclude_identity_seq=b_id if exclude_identity else None,
                min_density_per_kb=cfg.min_seed_density,
            )
            cands, _ = _cap_candidates(cands, [], cfg.max_candidates)
            for cand in cands:
                self._make_jobs(cand, q, b_id, self_tandem=self_tandem)

    def align_queries(self, queries: list[np.ndarray], ids: list[int],
                      exclude_identity: bool = False, chunk: int = 32):
        """Batched enqueue: chunked two-strand lookup + clustering threads.

        Lookups AND diagonal clustering run batched per chunk on a small
        thread pool (NumPy releases the GIL in the sort/gather passes) so
        host seeding overlaps both itself and the in-flight device
        dispatches; the main thread only builds jobs and flushes.
        """
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg

        def do_chunk(qs, qids):
            fwd = self.index.lookup_batch(qs, max_occ=cfg.max_occ,
                                          stride=cfg.query_stride)
            rcs = [reverse_complement(q) for q in qs]
            rev = self.index.lookup_batch(rcs, max_occ=cfg.max_occ,
                                          stride=cfg.query_stride)
            excl = [qid if exclude_identity else None for qid in qids]
            cands = cluster_seeds_batched(
                self.index, fwd + rev,
                [False] * len(qs) + [True] * len(qs),
                max_gap=cfg.max_seed_gap, min_seeds=cfg.min_seeds,
                min_span=cfg.min_span, exclude_identity_seqs=excl + excl,
                min_density_per_kb=cfg.min_seed_density,
            )
            return rcs, cands

        chunks = [(queries[c0 : c0 + chunk], ids[c0 : c0 + chunk])
                  for c0 in range(0, len(queries), chunk)]
        ahead = 2 * cfg.seed_threads  # bound in-flight seed-array memory
        with ThreadPoolExecutor(max_workers=cfg.seed_threads) as ex:
            futures = [ex.submit(do_chunk, qs, qids) for qs, qids in chunks[:ahead]]
            for ci, (qs, qids) in enumerate(chunks):
                with trace.span("aligner.seed_wait"):
                    rcs, cands = futures[ci].result()
                futures[ci] = None
                if ci + ahead < len(chunks):
                    futures.append(ex.submit(do_chunk, *chunks[ci + ahead]))
                with trace.span("aligner.make_jobs"):
                    for i, (q, qid) in enumerate(zip(qs, qids)):
                        fwd_c, rev_c = cands[i], cands[len(qs) + i]
                        keep_f, keep_r = _cap_candidates(fwd_c, rev_c,
                                                         cfg.max_candidates)
                        for cand in keep_f:
                            self._make_jobs(cand, q, qid)
                        for cand in keep_r:
                            self._make_jobs(cand, rcs[i], qid)

    def finish(self) -> LocalAlignmentSet:
        """Flush pending jobs and assemble the alignment set.

        ``_flush_group`` dispatches at most ``_KMAX`` slope bins per call and
        returns the overflow to ``_pending``, so flush each bucket until it
        is empty — otherwise overflow-bin jobs would be silently dropped.
        """
        with trace.span("aligner.make_jobs"):
            for key in sorted(self._pending):
                while self._pending.get(key):
                    self._flush_group(key)
        self._drain()
        self._dispatch_pool.shutdown(wait=False)
        with trace.span("map.assemble"):
            las = _assemble(self._cands, self.cfg)
        self._cands = []
        return las


def _cap_candidates(fwd: list, rev: list, limit: int):
    """Keep the ``limit`` largest-A-span candidates across both strands."""
    total = len(fwd) + len(rev)
    if limit <= 0 or total <= limit:
        return fwd, rev
    spans = [(int(c.a_pos[-1] - c.a_pos[0]), 0, i) for i, c in enumerate(fwd)]
    spans += [(int(c.a_pos[-1] - c.a_pos[0]), 1, i) for i, c in enumerate(rev)]
    spans.sort(key=lambda t: -t[0])
    keep_f = sorted(i for _, s, i in spans[:limit] if s == 0)
    keep_r = sorted(i for _, s, i in spans[:limit] if s == 1)
    return [fwd[i] for i in keep_f], [rev[i] for i in keep_r]


def _interp_slope1(x, xp, fp):
    """np.interp with slope-1 (diagonal) extrapolation beyond the seeds."""
    x = np.asarray(x)
    y = np.interp(x, xp, fp)
    y = np.where(x < xp[0], fp[0] - (xp[0] - x), y)
    y = np.where(x > xp[-1], fp[-1] + (x - xp[-1]), y)
    return y.astype(np.int64)


def _summarize(r_end, j_end, d_end, score, trace_j_col, trace_d_col):
    """Device summary → (r_end, j_end, d_end, score, trace_j, trace_d).

    trace_* are the monotone-envelope samples at rows 126, 252, … < r_end;
    trace column k holds DP row (k+1)·126.
    """
    if score <= 0:
        return (0, 0, 0, 0, np.empty(0, np.int64), np.empty(0, np.int64))
    n_trace = max(0, (r_end - 1)) // TRACE_SPACING  # rows 126.. < r_end
    trace_j = np.minimum(trace_j_col[:n_trace].astype(np.int64), j_end)
    trace_d = np.minimum(trace_d_col[:n_trace].astype(np.int64), d_end)
    return (r_end, j_end, d_end, score, trace_j, trace_d)


def _assemble(cands: list[_CandState], cfg: AlignerConfig) -> LocalAlignmentSet:
    """Combine per-candidate direction results into a LocalAlignmentSet."""
    rec = {k: [] for k in ("a_id", "b_id", "comp", "ab", "ae", "bb", "be", "df", "sc")}
    traces: list[tuple[np.ndarray, np.ndarray]] = []
    for c in cands:
        fwd = c.fwd or (0, 0, 0, 0, np.empty(0, np.int64), np.empty(0, np.int64))
        bwd = c.bwd or (0, 0, 0, 0, np.empty(0, np.int64), np.empty(0, np.int64))
        r_f, j_f, d_f, s_f, tj_f, td_f = fwd
        r_b, j_b, d_b, s_b, tj_b, td_b = bwd
        a_begin, a_end = c.a0 - r_b, c.a0 + r_f
        b_begin, b_end = c.b0 - j_b, c.b0 + j_f
        a_len, b_len = a_end - a_begin, b_end - b_begin
        if (a_len + b_len) / 2 < cfg.min_length:
            continue
        diffs = d_f + d_b
        err = 2.0 * diffs / max(1, a_len + b_len)
        if err > cfg.max_error:
            continue
        # assemble cumulative (b, d) at every trace boundary of A
        # backward rows r=126k < r_b map to boundary a0-r with
        # b = b0 - tj_b[k], cumdiff-from-start = d_b - td_b[k]
        # (vectorized: the former per-trace-point appends were ~2M list
        # ops per genome-scale mapping pass)
        anchor = ([c.b0], [d_b]) if r_b > 0 else ([], [])
        b_pts = np.concatenate([
            [b_begin], c.b0 - tj_b[::-1], anchor[0], c.b0 + tj_f, [b_end],
        ]).astype(np.int64)
        d_pts = np.concatenate([
            [0], d_b - td_b[::-1], anchor[1], d_b + td_f, [diffs],
        ]).astype(np.int64)
        np.maximum.accumulate(b_pts, out=b_pts)
        np.maximum.accumulate(d_pts, out=d_pts)
        # boundaries: a_begin, mids(126), a0(=126k), mids, a_end — drop the
        # duplicated anchor entry when both directions exist; drop duplicate
        # first/last boundary when a_begin/a_end are themselves multiples.
        bounds = np.concatenate([
            [a_begin],
            np.arange(a_begin // TRACE_SPACING * TRACE_SPACING + TRACE_SPACING,
                      a_end, TRACE_SPACING, dtype=np.int64),
            [a_end],
        ])
        bounds = bounds[np.concatenate([[True], np.diff(bounds) > 0])]
        if len(b_pts) != len(bounds):
            # defensive: resample via linear interpolation on the collected pts
            full = np.linspace(0, 1, len(b_pts))
            want = (bounds - a_begin) / max(1, a_end - a_begin)
            b_pts = np.interp(want, full, b_pts).astype(np.int64)
            d_pts = np.interp(want, full, d_pts).astype(np.int64)
        tb = np.diff(b_pts)
        td_arr = np.diff(d_pts)
        rec["a_id"].append(c.a_id)
        rec["b_id"].append(c.b_id)
        rec["comp"].append(c.complement)
        rec["ab"].append(a_begin)
        rec["ae"].append(a_end)
        rec["bb"].append(b_begin)
        rec["be"].append(b_end)
        rec["df"].append(diffs)
        rec["sc"].append(s_f + s_b)
        traces.append((td_arr.astype(np.int32), tb.astype(np.int32)))

    if not rec["a_id"]:
        return LocalAlignmentSet.empty()
    las = _build_las(rec, traces)
    return _dedup(las, np.array(rec["sc"]), cfg)


def _build_las(rec, traces) -> LocalAlignmentSet:
    counts = np.array([len(t[0]) for t in traces], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return LocalAlignmentSet(
        a_id=np.array(rec["a_id"], dtype=np.int32),
        b_id=np.array(rec["b_id"], dtype=np.int32),
        complement=np.array(rec["comp"], dtype=bool),
        a_begin=np.array(rec["ab"], dtype=np.int32),
        a_end=np.array(rec["ae"], dtype=np.int32),
        b_begin=np.array(rec["bb"], dtype=np.int32),
        b_end=np.array(rec["be"], dtype=np.int32),
        diffs=np.array(rec["df"], dtype=np.int32),
        trace_offsets=offsets,
        trace_diffs=np.concatenate([t[0] for t in traces]) if traces else np.empty(0, np.int32),
        trace_b_adv=np.concatenate([t[1] for t in traces]) if traces else np.empty(0, np.int32),
    )


def _dedup(las: LocalAlignmentSet, scores: np.ndarray, cfg: AlignerConfig) -> LocalAlignmentSet:
    """Drop near-duplicate alignments (same pair/strand, high mutual overlap)."""
    n = len(las)
    if n <= 1:
        return las
    order = np.lexsort((-scores, las.a_begin, las.complement, las.b_id, las.a_id))
    keep = np.ones(n, dtype=bool)
    for ii in range(n):
        i = order[ii]
        if not keep[i]:
            continue
        for jj in range(ii + 1, n):
            j = order[jj]
            if not keep[j]:
                continue
            if (las.a_id[j] != las.a_id[i] or las.b_id[j] != las.b_id[i]
                    or las.complement[j] != las.complement[i]):
                break
            if las.a_begin[j] >= las.a_end[i]:
                break
            ov_a = min(las.a_end[i], las.a_end[j]) - max(las.a_begin[i], las.a_begin[j])
            ov_b = min(las.b_end[i], las.b_end[j]) - max(las.b_begin[i], las.b_begin[j])
            min_a = min(las.a_length(i), las.a_length(j))
            min_b = min(las.b_length(i), las.b_length(j))
            if (min_a > 0 and ov_a / min_a > cfg.dedup_overlap
                    and min_b > 0 and ov_b / min_b > cfg.dedup_overlap):
                # keep higher score (i precedes j in score order)
                if scores[i] >= scores[j]:
                    keep[j] = False
                else:
                    keep[i] = False
                    break
        if not keep[i]:
            continue
    return las.select(keep).sort()


#: content-hash → KmerIndex; the pipeline indexes the same store many
#: times (warmup + steady bench passes, per-stage re-maps), and a build
#: costs seconds at genome scale while a full blake2b hash costs ms/Mb
_INDEX_CACHE: "dict[bytes, KmerIndex]" = {}
_INDEX_CACHE_MAX = 4


#: content-hash → presorted (kmers, positions): the argsort (the
#: expensive part of an index build) is shared across the pipeline's
#: three mask variants of the same assembly
_PRESORT_CACHE: "dict[bytes, tuple]" = {}


def _cached_index(codes, offsets, lengths, k, mask_intervals) -> KmerIndex:
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(k).tobytes())
    h.update(np.ascontiguousarray(codes).tobytes())
    h.update(np.ascontiguousarray(offsets).tobytes())
    h.update(np.ascontiguousarray(lengths).tobytes())
    content_key = h.digest()
    if mask_intervals is not None and len(mask_intervals):
        h.update(np.ascontiguousarray(mask_intervals).tobytes())
    key = h.digest()
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        pre = _PRESORT_CACHE.get(content_key)
        if pre is None:
            pre = KmerIndex.presort(codes, k)
            if len(_PRESORT_CACHE) >= _INDEX_CACHE_MAX:
                _PRESORT_CACHE.pop(next(iter(_PRESORT_CACHE)))
            _PRESORT_CACHE[content_key] = pre
        idx = KmerIndex(codes, offsets, lengths, k=k,
                        mask_intervals=mask_intervals, presorted=pre)
        if len(_INDEX_CACHE) >= _INDEX_CACHE_MAX:
            _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
        _INDEX_CACHE[key] = idx
    else:  # LRU refresh
        _INDEX_CACHE.pop(key)
        _INDEX_CACHE[key] = idx
    return idx


#: id(query list) → (flat codes, offsets, keep-alive): resident dispatch
#: needs the queries as one flat store; repeated calls with the same
#: list (bench trials, warmup) reuse the concatenation
_FLAT_QUERY_CACHE: dict = {}


def _flat_query_store(queries: list) -> tuple:
    key = id(queries)
    hit = _FLAT_QUERY_CACHE.get(key)
    if hit is not None and hit[2] is queries:
        return hit[0], hit[1]
    lens = np.array([len(q) for q in queries], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
    flat = (np.concatenate([np.asarray(q, dtype=np.uint8) for q in queries])
            if queries else np.zeros(0, np.uint8))
    # one entry: retained flat copies pin GB-scale host RAM at
    # stress scale; only bench-style repeated calls benefit from reuse
    if len(_FLAT_QUERY_CACHE) >= 1:
        _FLAT_QUERY_CACHE.pop(next(iter(_FLAT_QUERY_CACHE)))
    _FLAT_QUERY_CACHE[key] = (flat, offs, queries)
    return flat, offs


def align_store_pair(
    target_codes: np.ndarray,
    target_offsets: np.ndarray,
    target_lengths: np.ndarray,
    queries: list[np.ndarray],
    query_ids: list[int] | None = None,
    config: AlignerConfig | None = None,
    mask_intervals: np.ndarray | None = None,
    self_alignment: bool = False,
    query_store=None,
    group=None,
) -> LocalAlignmentSet:
    """Align every query against the target store; returns sorted LAs.

    With ``self_alignment=True`` the queries are the target's own
    sequences and the identity diagonal is suppressed (daligner ``-I``
    self-comparison semantics).

    ``query_store`` — optional ``(codes, offsets)`` (or an object with
    those attributes) of the flat store the query ids index into; it
    enables the device-resident dispatch path.  Without it the store is
    derived from ``queries`` when the ids are the default 1..n.

    ``group`` (a :class:`~dentist_tpu_torch.parallel.dp.DPGroup`) splits
    every extension flush's lanes over its ranks; every rank returns the
    same records, equal to the single-device ones.
    """
    cfg = config or AlignerConfig()
    index = _cached_index(target_codes, target_offsets, target_lengths, cfg.k,
                          mask_intervals)
    if query_store is not None and not isinstance(query_store, tuple):
        query_store = (query_store.codes, query_store.offsets)
    if query_store is None and query_ids is None:
        query_store = _flat_query_store(queries)
    aligner = Aligner(index, target_codes, cfg, query_store=query_store,
                      group=group)
    ids = query_ids or list(range(1, len(queries) + 1))
    aligner.align_queries([np.asarray(q, dtype=np.uint8) for q in queries], ids,
                          exclude_identity=self_alignment)
    las = aligner.finish()
    log_json("diagnostic", event="alignStorePair", nQueries=len(queries),
             nAlignments=len(las))
    return las
