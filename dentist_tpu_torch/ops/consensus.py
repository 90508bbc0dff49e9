"""Pile-up consensus: iterative realign-and-vote template refinement.

Port of ``dentist_tpu/ops/consensus.py``: the host code — bucketing,
retries, windowed realignment, voting, template rebuild and the polish
hill climb — is the JAX package's, unchanged, so the same lanes share a
dispatch and the same lanes are retried.  The device work is five
hand-written CUDA kernels:

- K2p (:func:`.nw_round.nw_round_packed`) runs the full template rounds
  and the fixed-shape windowed rounds (192 template rows, 384 read
  chars) on 2-bit packed lanes the host built;
- K2r (:func:`.nw_round.nw_round_resident`) runs windowed rounds whose
  template and read windows lie in the device store, from five
  coordinates per lane;
- K4 (:func:`.round_pack.round_pack`) packs a full round's fields into
  the JAX package's sparse or dense result block, K4w
  (:func:`.round_pack.window_pack`) a windowed lane's interior row;
- K3p (:func:`.nw_dist.nw_dist_pairs_packed`) scores the polish
  candidates.

Two configurations, as in the JAX package.  The default: the cropped
reads of a ``consensus_batch`` call upload once into the device store
(K5, 2-bit packed) and each windowed round uploads its templates, so its
lanes ship coordinates only (K2r); full and windowed rounds return sparse
blocks, and lanes whose events overflow the blocks' caps are fetched
again through the dense blocks.  With ``DENTIST_TPU_DENSE_CONS=1`` every
round ships host-built packed windows (K2p) and returns dense blocks.
Under a data-parallel ``group`` every dispatch's lanes split over the
ranks and the blocks are gathered (port of ``_sharded_nw_round``,
``_sharded_nw_window_round`` and ``_sharded_nw_dist``), so every rank
computes the same consensi; the store-resident windows stay single-rank,
as in the JAX package.

The daccord replacement (SURVEY §2.3): reads of one pile-up share one
genomic interval and orientation, so each is aligned to the template by
a banded free-shift NW with the band following the proportional
diagonal; per-column majority votes rebuild the template, and the
per-read per-window diff counts are the intrinsic-QV signal.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..device import get_device
from ..errors import KernelError
from ..models.alignments import TRACE_SPACING
from ..parallel.dp import dispatch_workers, gather_lanes, local_lanes, pad_lanes
from ..utils import trace
from .banded import _ARENA_CHUNK, _RESIDENT_LADDER, RESIDENT_PAD, device_store
from .nw_dist import nw_dist_pairs_packed
from .nw_round import nw_round_packed, nw_round_resident
from .pack2 import pack2bit
from .round_pack import (TB_nwin, _collect_chunk, _collect_chunk_sparse,
                         _unpack_window_rows, _unpack_window_rows_sparse,
                         round_pack, window_pack)

__all__ = ["ConsensusResult", "consensus", "consensus_batch",
           "rank_reference_reads"]

_INF = np.int32(1 << 28)
#: move codes
_DIAG, _UP, _LEFT, _NONE = 0, 1, 2, 3

#: template-length buckets: ~factor-1.5 steps in the example-scale range
#: (pile-up templates measured p50 ≈ 3.7 k, p90 ≈ 7 k — pure powers of 2
#: paid up to 2× padded scan rows AND fetch bytes on the dominant sizes)
_T_BUCKETS = [512, 1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 32768]
#: device-memory budget for the (T, N, W) move tensor per dispatch
_MOVE_BUDGET = 1 << 28
#: lane-count ladder (the JAX package's, factor 4); with the RL = 2·T
#: rule (:func:`_rl_bucket`) it decides which lanes share a dispatch and
#: a retry, so parity keeps it
_N_LADDER = [32, 128, 512, 2048, 8192]


def _t_bucket(t: int) -> int:
    for b in _T_BUCKETS:
        if t <= b:
            return b
    return _T_BUCKETS[-1]


def _rl_bucket(rl: int, tb: int) -> int:
    """Read-length bucket: always 2·T.

    Reads longer than 2·T cannot produce acceptable lanes anyway — the
    free-shift DP must consume the whole read, costing ≥ RL − T edits —
    so such reads are dispatched on their 2·T prefix (gap pile-ups bound
    one-anchored reads well below this; extension templates never grow
    past ~the median read length)."""
    return 2 * tb


def _n_max(tb: int, W: int) -> int:
    """Main-chunk lane count for a T bucket (move-tensor budget)."""
    return max(_N_LADDER[0],
               1 << ((_MOVE_BUDGET // (tb * W)).bit_length() - 1))



def _n_bucket_lanes(n: int, tb: int, W: int) -> int:
    """Pad a chunk's lane count to the lane ladder (padding only costs
    compute: lanes are independent)."""
    cap = _n_max(tb, W)
    for b in _N_LADDER:
        if n <= b <= cap:
            return b
    return cap


@dataclass
class _RoundOut:
    """Per-job results of one realign round (host arrays)."""

    sym: np.ndarray  # (n, T) int8
    ins: np.ndarray  # (n, T+1, 4) int8
    jpath: np.ndarray  # (n, T+1) int64
    spans: np.ndarray  # (n, 2)
    diffs: np.ndarray  # (n,)
    win: np.ndarray  # (n, NWIN)
    covered: np.ndarray  # (n,) bool
    #: columns whose values were (re)aligned this round; None = all of
    #: them (full rounds).  Incremental rounds carry forward the stale
    #: columns from ``prev`` and mark only realigned window interiors.
    fresh_cols: np.ndarray | None = None  # (T,) bool
    fresh_bnds: np.ndarray | None = None  # (T+1,) bool


@dataclass
class _ConsJob:
    """One pile-up's realign-round input.

    ``dirty`` (len-T bool, only with ``prev``) restricts realignment to
    windows touching dirty columns — the incremental rounds that make
    template-edit iteration O(edits), not O(template): clean windows
    keep ``prev``'s stitched values (their template columns are
    unchanged, so the old per-read contributions are still exact).
    """

    template: np.ndarray
    reads: list[np.ndarray]
    jpath: np.ndarray | None = None
    prev: _RoundOut | None = None
    dirty: np.ndarray | None = None
    reads_arr: np.ndarray | None = None  # (n, RL) uint8 cache
    #: device-resident flat cropped-read store + this job's per-read
    #: offsets into it (enables coordinate-only windowed dispatches)
    seg_res: object = None
    read_offs: np.ndarray | None = None

    def reads_u8(self) -> np.ndarray:
        if self.reads_arr is None:
            RL = max((len(r) for r in self.reads), default=1)
            arr = np.zeros((len(self.reads), RL), dtype=np.uint8)
            for ni, r in enumerate(self.reads):
                arr[ni, : len(r)] = r
            self.reads_arr = arr
        return self.reads_arr


class _ArenaRef:
    """A store uploaded to the device store, re-uploaded transparently
    if the store was reset (epoch change) since."""

    def __init__(self, codes: np.ndarray):
        self.store = device_store()
        self.codes = codes
        self.base = self.store.offset_of(codes, cache=False)
        self.epoch = self.store.epoch

    def offset(self) -> int:
        if self.store.epoch != self.epoch:
            self.base = self.store.offset_of(self.codes, cache=False)
            self.epoch = self.store.epoch
        return self.base


def _as_jobs(jobs) -> "list[_ConsJob]":
    return [j if isinstance(j, _ConsJob) else _ConsJob(*j) for j in jobs]


def _dilate_mask(mask: np.ndarray, pad: int) -> np.ndarray:
    """Dilate a bool mask by ``pad`` positions on each side."""
    if not mask.any():
        return mask
    idx = np.flatnonzero(mask)
    out = np.zeros(len(mask) + 1, dtype=np.int32)
    lo = np.maximum(idx - pad, 0)
    hi = np.minimum(idx + pad + 1, len(mask))
    np.add.at(out, lo, 1)
    np.add.at(out, hi, -1)
    return np.cumsum(out[:-1]) > 0


def _clamp_steps(centers: np.ndarray) -> np.ndarray:
    """Limit per-row center increments to ≤ 2: ``c'_i = min_{k≤i}(c_k +
    2(i−k))``.  Bounded shifts let the kernel realize band moves as
    static shift selects instead of per-row gathers; a band that cannot
    keep up (read ≫ 2×template) simply fails coverage and is retried /
    dropped, as before."""
    rows2 = 2 * np.arange(centers.shape[0], dtype=np.int64)[:, None]
    return (np.minimum.accumulate(centers.astype(np.int64) - rows2, axis=0)
            + rows2).astype(np.int32)


def _make_centers(T: int, read_lens: np.ndarray, jpath: np.ndarray | None) -> np.ndarray:
    """Band centers (T+1, N): slope-1 clamped, or previous traceback path."""
    N = len(read_lens)
    rows = np.arange(T + 1, dtype=np.int64)
    centers = np.minimum(rows[:, None], read_lens[None, :].astype(np.int64))
    if jpath is not None and jpath.shape[0] == N:
        Tp = jpath.shape[1] - 1
        for n in range(N):
            good = np.flatnonzero(jpath[n] >= 0)
            if len(good) >= 2:
                interp = np.interp(
                    np.linspace(0, Tp, T + 1), good, jpath[n, good]
                )
                centers[:, n] = np.clip(np.round(interp), 0, read_lens[n]).astype(np.int64)
    return _clamp_steps(centers.astype(np.int32))


def _prop_centers(T: int, read_lens: np.ndarray) -> np.ndarray:
    rows = np.arange(T + 1, dtype=np.int64)
    prop = np.minimum(
        rows[:, None] * read_lens[None, :].astype(np.int64) // max(T, 1),
        read_lens[None, :].astype(np.int64),
    )
    return _clamp_steps(prop.astype(np.int32))


def _run_round(jobs, W: int, group=None) -> list[_RoundOut]:
    """One realign round for every job, routed per lane.

    Lanes whose previous-round traceback path is available (``jpath``
    row with ≥ 2 valid boundaries) realign through the WINDOWED kernel —
    independent ``_WS``-column template windows anchored on the previous
    path, all windows of all lanes of all jobs in one fixed-shape
    dispatch (daccord's windowed consensus: the full-template scan is
    latency-bound at one sequential row per template column, the
    windowed realign runs thousands of 192-row DPs in parallel).  First-round lanes (no path yet) and windowed failures
    take the full banded scan (:func:`_run_round_full`).
    """
    jobs = _as_jobs(jobs)
    if os.environ.get("DENTIST_TPU_NO_WINDOWED"):
        return _run_round_full(jobs, W, group=group)
    win_jobs: list[int] = []
    full_jobs: list[int] = []
    for ji, job in enumerate(jobs):
        if (job.jpath is not None
                and job.jpath.shape == (len(job.reads), len(job.template) + 1)
                and len(job.template) >= _WS):
            win_jobs.append(ji)
        else:
            full_jobs.append(ji)
    outs: list[_RoundOut | None] = [None] * len(jobs)
    retry_jobs: list[_ConsJob] = []
    retry_map: list[tuple[int, int]] = []  # (job_idx, read_idx)
    if win_jobs:
        wouts, failures = _run_round_windowed([jobs[ji] for ji in win_jobs],
                                              W, group)
        for wi, ji in enumerate(win_jobs):
            outs[ji] = wouts[wi]
        for wi, ri in failures:
            ji = win_jobs[wi]
            retry_jobs.append(_ConsJob(jobs[ji].template, [jobs[ji].reads[ri]]))
            retry_map.append((ji, ri))
    if full_jobs or retry_jobs:
        fouts = _run_round_full([jobs[ji] for ji in full_jobs] + retry_jobs,
                                W, group)
        for k, ji in enumerate(full_jobs):
            outs[ji] = fouts[k]
        for k, (ji, ri) in enumerate(retry_map):
            r = fouts[len(full_jobs) + k]
            o = outs[ji]
            o.sym[ri] = r.sym[0]
            o.ins[ri] = r.ins[0]
            o.jpath[ri] = r.jpath[0]
            o.spans[ri] = r.spans[0]
            o.diffs[ri] = r.diffs[0]
            o.win[ri] = r.win[0][: o.win.shape[1]]
            o.covered[ri] = r.covered[0]
    return outs


def _run_round_full(jobs, W: int, group=None) -> list[_RoundOut]:
    """Align every job's reads to its template in bucketed batched
    dispatches; lanes from all jobs share dispatches.

    Lanes that fail with path-following/slope-1 centers are retried once
    with proportional centers (partial vs full-span reads drift
    differently).
    """
    jobs = _as_jobs(jobs)
    lanes = []  # (job_idx, read_idx, template, read)
    # band centers are built ONCE per job across all its lanes (the
    # per-lane np.interp calls were a measured host hotspot)
    centers_path: list[np.ndarray] = []
    centers_prop: list[np.ndarray | None] = []
    for ji, job in enumerate(jobs):
        template, reads, jpath_prev = job.template, job.reads, job.jpath
        T = max(len(template), 1)
        rl = np.array([len(r) for r in reads], dtype=np.int64)
        jp = jpath_prev if (jpath_prev is not None
                            and jpath_prev.shape[0] == len(reads)) else None
        centers_path.append(_make_centers(T, rl, jp))
        centers_prop.append(None)  # built lazily on retry
        for ri, r in enumerate(reads):
            lanes.append((ji, ri, template, r))

    outs: dict[tuple[int, int], tuple] = {}
    groups: dict[int, list[int]] = {}  # T bucket -> lane indices
    for li, (ji, ri, template, r) in enumerate(lanes):
        groups.setdefault(_t_bucket(max(len(template), 1)), []).append(li)

    # dispatch every chunk of every group before fetching any result, so
    # the host assembles later chunks while the device runs earlier ones
    def centers_for(li):
        ji, ri, _, _ = lanes[li]
        return centers_path[ji][:, ri]

    plan = []
    for TB, lidx in groups.items():
        max_n = _n_max(TB, W)
        for c0 in range(0, len(lidx), max_n):
            chunk = lidx[c0 : c0 + max_n]
            plan.append((chunk, TB))

    use_sparse = not os.environ.get("DENTIST_TPU_DENSE_CONS")

    def collect(chunk, TB, arr, cen, only_if_better=False,
                centers_fn=None):
        """Sparse decode with dense refetch of cap-overflow lanes (the
        dense block is exact for any event density; ``centers_fn`` must
        be the SAME band-center source the decoded dispatch used)."""
        if not use_sparse:
            _collect_chunk(lanes, chunk, TB, outs,
                           only_if_better=only_if_better, fetched=arr,
                           centers=cen)
            return
        ovf = _collect_chunk_sparse(lanes, chunk, TB, outs,
                                    only_if_better=only_if_better,
                                    fetched=arr)
        if ovf:
            trace.count("cons.ovf_refetch", len(ovf))
            ovf_lanes = [chunk[k] for k in ovf]
            h2, cen2 = _dispatch_chunk(lanes, ovf_lanes, TB, W,
                                       centers_fn or centers_for,
                                       group, dense=True)
            _collect_chunk(lanes, ovf_lanes, TB, outs,
                           only_if_better=only_if_better,
                           fetched=_fetch(h2), centers=cen2)

    with trace.span("cons.full.dispatch"):
        # launches serialize in a group: gathers run in the same order on
        # every rank
        with ThreadPoolExecutor(max_workers=dispatch_workers(4)) as ex:
            handles = list(ex.map(
                lambda t: _dispatch_chunk(lanes, t[0], t[1], W, centers_for,
                                          group, dense=not use_sparse),
                plan))
    with trace.span("cons.full.fetch"), trace.span("wait.device"):
        fetched = [_fetch(h) for h, _ in handles]
    trace.count("cons.full.fetch.bytes", sum(a.nbytes for a in fetched))
    # the overflow refetch launches (and, in a group, gathers): the pool
    # runs one worker in a group, as the dispatch pool does
    with trace.span("cons.full.collect"):
        with ThreadPoolExecutor(max_workers=dispatch_workers(4)) as ex:
            list(ex.map(
                lambda t: collect(t[0][0], t[0][1], t[2], t[1][1]),
                zip(plan, handles, fetched)))
    retries = []
    for chunk, TB in plan:
        # retry uncovered lanes with proportional centers
        retry = [li for li in chunk if not outs[(lanes[li][0], lanes[li][1])][6]]
        if retry:
            for li in retry:
                ji = lanes[li][0]
                if centers_prop[ji] is None:
                    job = jobs[ji]
                    rl = np.array([len(r) for r in job.reads], dtype=np.int64)
                    centers_prop[ji] = _prop_centers(
                        max(len(job.template), 1), rl)

            def prop_for(li):
                ji, ri, _, _ = lanes[li]
                return centers_prop[ji][:, ri]

            retries.append((retry, TB,
                            _dispatch_chunk(lanes, retry, TB, W, prop_for,
                                            group, dense=not use_sparse),
                            prop_for))
    with trace.span("wait.device"):
        refetched = [_fetch(t[2][0]) for t in retries]
    for (retry, TB, (_, cen), pf), arr in zip(retries, refetched):
        collect(retry, TB, arr, cen, only_if_better=True, centers_fn=pf)

    # assemble per-job outputs
    with trace.span("cons.full.assemble"):
        results = []
        for ji, job in enumerate(jobs):
            T = len(job.template)
            n = len(job.reads)
            NWIN = max((TB_nwin(T)), 1)
            sym = np.full((n, T), 5, np.int8)
            ins = np.zeros((n, T + 1, 4), np.int8)
            jpath = np.full((n, T + 1), -1, np.int64)
            spans = np.zeros((n, 2), np.int64)
            diffs = np.zeros(n, np.int64)
            win = np.zeros((n, NWIN), np.int32)
            cov = np.zeros(n, bool)
            for ri in range(n):
                o = outs[(ji, ri)]
                sym[ri] = o[0][:T]
                ins[ri] = o[1][: T + 1]
                jpath[ri] = o[2][: T + 1]
                spans[ri] = o[3]
                diffs[ri] = o[4]
                win[ri] = o[5][:NWIN]
                cov[ri] = o[6]
            results.append(_RoundOut(sym, ins, jpath, spans, diffs, win, cov))
    return results


# ======================================================================
# Windowed realign round (rounds with a previous traceback path)
# ======================================================================

#: interior columns per window lane (= the QV/trace spacing, so stitched
#: per-window diff buckets land exactly on the intrinsic-QV grid)
_ADV = TRACE_SPACING
#: margin columns on each side of the interior, realigned but discarded —
#: absorbs boundary wander of the previous round's path (and of template
#: edits, which the exact ``src_bnd`` remap bounds to ±1 column per edit)
_MARGIN = 33
#: template rows per window lane (multiple of the kernel's 32-row chunks)
_WS = _ADV + 2 * _MARGIN
#: read-segment capacity per lane (the fixed RL bucket: 2·_WS)
_SEG = 2 * _WS
#: skippable read chars prepended before each window (leading read
#: prefixes are free in the kernel; trailing slack would be force-consumed)
_LEAD_SLACK = 8

def _run_round_windowed(jobs, W: int, group=None):
    """Realign via independent path-anchored template windows.

    Every (read, window) pair becomes one lane of a SINGLE fixed shape
    (``_WS`` template rows × ``_SEG`` read chars): the full-template scan
    is latency-bound — one sequential DP row per template column — while
    window lanes of every read of every pile-up run in parallel, which is
    daccord's windowed-consensus structure
    (``dazzler.d:4196-4340``; w=40/advance 10 there, 192/126 here).  Only
    each window's interior ``_ADV`` columns contribute to the stitched
    result; the ``_MARGIN`` overlap is discarded, so window-boundary
    artifacts cannot vote.

    Jobs with ``dirty`` realign ONLY windows whose [b0, b1) span touches
    a dirty column; everything else carries ``prev``'s values forward
    (clean columns' template content is unchanged, so the carried
    alignments remain exact) — the incremental mode that makes polish
    iteration cost O(applied edits), not O(template).

    Returns ``(outs, failures)``: per-job :class:`_RoundOut` plus the
    (job, read) lanes that need the full banded scan (no usable previous
    path; full-realign jobs only).  Stitched ``win``/``diffs`` count
    insertion runs at their ≤4-rank cap — runs of 5+ at one boundary
    (vanishingly rare at 13 % error) undercount the QV signal slightly;
    votes are unaffected.
    """
    jobs = _as_jobs(jobs)
    lane_tpl, lane_seg = [], []
    lane_tlen, lane_seglen, lane_loc0 = [], [], []
    lane_tstart, lane_sstart = [], []
    per_job = []  # (rr, kk, i0, kend, b0, b1, jlo_s, lane_offset)
    failures: list[tuple[int, int]] = []
    total = 0
    # resident mode: the cropped reads live on the device (batch upload)
    # and the templates upload once per call — lanes then ship coordinates
    res_mode = (bool(jobs) and group is None
                and all(j.seg_res is not None and j.read_offs is not None
                        for j in jobs))
    tpl_bases = None
    if res_mode:
        # preflight: the read store and the per-round templates must be
        # able to coexist in the device store, or the upload-retry loop in
        # the dispatcher could thrash (each template upload resetting the
        # store and evicting the read store)
        def _bucket(n):
            b = next(x for x in _RESIDENT_LADDER if max(n, 4) <= x)
            return max(b, -(-n // _ARENA_CHUNK) * _ARENA_CHUNK)

        seg_len = len(jobs[0].seg_res.codes)
        tpl_len = sum(len(j.template) for j in jobs)
        if (_bucket(seg_len) + _bucket(tpl_len) + 3 * RESIDENT_PAD
                > jobs[0].seg_res.store.capacity):
            res_mode = False
    if res_mode:
        tpl_bases = np.concatenate(
            [[0], np.cumsum([len(j.template) for j in jobs])])[:-1]
    with trace.span("cons.win.build"):
        for wi, job in enumerate(jobs):
            template, reads, jp = job.template, job.reads, job.jpath
            T = len(template)
            n = len(reads)
            nwin = -(-T // _ADV)
            valid = jp >= 0
            nvalid = valid.sum(axis=1)
            s = np.argmax(valid, axis=1)
            e = T - np.argmax(valid[:, ::-1], axis=1)  # last valid boundary
            ok_read = nvalid >= 2
            if job.dirty is None:
                for ri in np.flatnonzero(~ok_read):
                    failures.append((wi, int(ri)))
            k = np.arange(nwin)
            i0 = k * _ADV
            kend = np.minimum(i0 + _ADV, T)
            b0 = np.maximum(i0 - _MARGIN, 0)
            b1 = np.minimum(i0 + _ADV + _MARGIN, T)
            rel = (ok_read[:, None] & (i0[None, :] < e[:, None])
                   & (kend[None, :] > s[:, None]))
            if job.dirty is not None:
                cumd = np.concatenate([[0], np.cumsum(job.dirty)])
                rel &= (cumd[b1] - cumd[b0] > 0)[None, :]
            lo_b = np.maximum(b0[None, :], s[:, None])
            hi_b = np.minimum(b1[None, :], e[:, None])
            jlo = np.take_along_axis(jp, np.clip(lo_b, 0, T), axis=1)
            jhi = np.take_along_axis(jp, np.clip(hi_b, 0, T), axis=1)
            rel &= (jlo >= 0) & (jhi > jlo)
            rr, kk = np.nonzero(rel)
            L = len(rr)
            if L == 0:
                per_job.append(None)
                continue
            jl = np.maximum(jlo[rr, kk] - _LEAD_SLACK, 0)
            jl = np.maximum(jl, jhi[rr, kk] - _SEG)
            seg_len = jhi[rr, kk] - jl
            t_len = (b1 - b0)[kk]
            tidx = b0[kk][:, None] + np.arange(_WS)[None, :]
            tmask = tidx < b1[kk][:, None]
            lane_tpl.append(np.where(
                tmask, template[np.minimum(tidx, max(T - 1, 0))], 0).astype(np.uint8))
            if res_mode:
                lane_tstart.append(tpl_bases[wi] + b0[kk])
                lane_sstart.append(job.read_offs[rr] + jl)
            else:
                reads_arr = job.reads_u8()
                RL = reads_arr.shape[1]
                sidx = jl[:, None] + np.arange(_SEG)[None, :]
                smask = np.arange(_SEG)[None, :] < seg_len[:, None]
                lane_seg.append(np.where(
                    smask, reads_arr[rr[:, None], np.minimum(sidx, RL - 1)], 0))
            lane_tlen.append(t_len)
            lane_seglen.append(seg_len)
            lane_loc0.append((i0 - b0)[kk])
            per_job.append((rr, kk, i0, kend, b0, b1, jl, total))
            total += L
    resident = None
    if res_mode:
        resident = (jobs[0].seg_res,
                    np.concatenate([j.template for j in jobs])
                    if jobs else np.zeros(0, np.uint8),
                    lane_tstart, lane_sstart)
    with trace.span("cons.win.dispatch+fetch"):
        fetched = _dispatch_windowed_lanes(
            lane_tpl, lane_tlen, lane_seg, lane_seglen, lane_loc0, total, W,
            group, resident=resident)
    trace.count("cons.win.lanes", total)

    with trace.span("cons.win.stitch"):
        def stitch_one(wi):
            job = jobs[wi]
            template, reads = job.template, job.reads
            T = len(template)
            n = len(reads)
            NWIN = max(TB_nwin(T), 1)
            incremental = job.dirty is not None and job.prev is not None
            if incremental:
                sym_g = job.prev.sym.copy()
                ins_g = job.prev.ins.copy()
                jp_g = job.prev.jpath.copy()
                fresh_cols = np.zeros(T, dtype=bool)
                fresh_bnds = np.zeros(T + 1, dtype=bool)
            else:
                sym_g = np.full((n, T), 5, np.int8)
                ins_g = np.zeros((n, T + 1, 4), np.int8)
                jp_g = np.full((n, T + 1), -1, np.int64)
                fresh_cols = fresh_bnds = None
            meta = per_job[wi]
            if meta is not None:
                rr, kk, i0, kend, b0, b1, jl, off = meta
                L = len(rr)
                sym_l, ins_l, jpath_l = (fetched[0][off : off + L],
                                         fetched[1][off : off + L],
                                         fetched[2][off : off + L])
                # lane arrays are interior-only (device-side extraction):
                # column c of sym_l is global column i0 + c
                cols = i0[kk][:, None] + np.arange(_ADV)[None, :]
                cmask = cols < kend[kk][:, None]
                ccols = np.minimum(cols, T - 1)  # safe pre-mask (cmask ⇒ < T)
                flat_cols = (rr[:, None] * T + ccols)[cmask]
                flat_bnds = (rr[:, None] * (T + 1) + ccols)[cmask]
                sym_g.reshape(-1)[flat_cols] = sym_l[cmask]
                jvals = np.where(jpath_l >= 0, jpath_l + jl[:, None], -1)
                jp_g.reshape(-1)[flat_bnds] = jvals[:, :_ADV][cmask]
                ins_g.reshape(n * (T + 1), 4)[flat_bnds] = ins_l[:, :_ADV][cmask]
                # final boundary T comes from the last window's interior end
                last = kend[kk] == T
                if last.any():
                    wid = (kend - i0)[kk][last]
                    lanes_last = np.flatnonzero(last)
                    jp_g[rr[last], T] = jvals[lanes_last, wid]
                    ins_g[rr[last], T] = ins_l[lanes_last, wid]
                if incremental:
                    wk = np.unique(kk)
                    for k_ in wk:
                        fresh_cols[i0[k_] : kend[k_]] = True
                        fresh_bnds[i0[k_] : kend[k_] + (kend[k_] == T)] = True
            # derived per-read statistics from the stitched columns
            tplv = template[None, :T]
            mism = (sym_g < 4) & (sym_g != tplv)
            dele = sym_g == 4
            contrib_col = mism.astype(np.int64) + dele
            ins_cnt = (ins_g != 0).sum(axis=2).astype(np.int64)
            bounds = np.arange(0, max(T, 1), TRACE_SPACING)[:NWIN]
            win_cols = np.add.reduceat(contrib_col, bounds, axis=1) if T else \
                np.zeros((n, NWIN), np.int64)
            win_ins = np.add.reduceat(ins_cnt[:, : T + 1], bounds, axis=1)
            win = (win_cols + win_ins).astype(np.int32)
            diffs = contrib_col.sum(axis=1) + ins_cnt.sum(axis=1)
            covered_cols = sym_g != 5
            covered = covered_cols.any(axis=1)
            first = np.argmax(covered_cols, axis=1)
            last_c = T - np.argmax(covered_cols[:, ::-1], axis=1)
            spans = np.stack([np.where(covered, first, 0),
                              np.where(covered, last_c, 0)], axis=1)
            fails = []
            # defensively retry reads whose windows all failed to stitch
            if meta is not None and job.dirty is None:
                for ri in np.flatnonzero(~covered):
                    if (wi, int(ri)) not in failures and len(reads[ri]):
                        fails.append((wi, int(ri)))
            return _RoundOut(sym_g, ins_g, jp_g, spans,
                             np.where(covered, diffs, 0), win, covered,
                             fresh_cols, fresh_bnds), fails

        # per-job stitching is independent numpy; thread it (serial, it was
        # ~10 s at 147-pile-up scale on a 4-core host)
        with ThreadPoolExecutor(max_workers=4) as ex:
            stitched = list(ex.map(stitch_one, range(len(jobs))))
        outs = [s[0] for s in stitched]
        for _, fails in stitched:
            failures.extend(fails)
    return outs, failures


#: window lanes per dispatch
_WCHUNK = 2048


def _dispatch_windowed_lanes(lane_tpl, lane_tlen, lane_seg, lane_seglen,
                             lane_loc0, total: int, W: int, group=None,
                             resident=None):
    """Run all window lanes in fixed-shape chunks; returns stacked
    interior-only (sym (total, 126) int8, ins (total, 127, 4) int8, jpath
    (total, 127) int64 relative to each segment's start).

    Host-window lanes ship 2-bit packed rows to K2p, with band centers
    ``c(r) = min(r, tlen) · slen // tlen`` as 2-bit steps clipped to 0..2
    (an over-slope lane fails coverage and is retried by the full round).
    ``resident`` = (read store ``_ArenaRef``, flat templates, per-job
    template starts, per-job read-segment starts) ships five coordinates
    per lane to K2r instead, which reads both windows from the device
    store and builds the same centers.  K4w packs each lane's interior
    row (sparse by default, dense with ``DENTIST_TPU_DENSE_CONS=1``, and
    dense for the lanes that overflow the sparse caps); only those rows
    leave the device (and, under a group, cross between ranks).
    """
    sym_all = np.full((total, _ADV), 5, np.int8)
    ins_all = np.zeros((total, _ADV + 1, 4), np.int8)
    jp_all = np.full((total, _ADV + 1), -1, np.int64)
    if total == 0:
        return sym_all, ins_all, jp_all
    if W > 128:  # the windowed blocks' byte-packed jpath offsets
        raise KernelError(f"windowed rounds take W <= 128, not {W}")
    tpl = np.concatenate(lane_tpl)
    tlen = np.concatenate(lane_tlen).astype(np.int32)
    slen = np.concatenate(lane_seglen).astype(np.int32)
    loc0 = np.concatenate(lane_loc0).astype(np.int32)
    rows = np.arange(_WS + 1, dtype=np.int32)
    use_sparse = not os.environ.get("DENTIST_TPU_DENSE_CONS")
    dev = get_device()
    seg = store = tstart = sstart = None
    if resident is not None:
        seg_ref, tpl_flat, lane_tstart, lane_sstart = resident
        st = seg_ref.store
        with st.lock:  # both offsets + array from one store state
            for _attempt in range(4):
                seg_base = seg_ref.offset()
                tpl_base = st.offset_of(tpl_flat, cache=False)
                # the template upload may have reset a full store, wiping
                # the read store — redo both until stable (the caller's
                # preflight guarantees they coexist, so this settles in
                # <= 2 iterations)
                if st.epoch == seg_ref.epoch:
                    break
            else:
                raise MemoryError(
                    "consensus stores do not fit the device store")
            store = st.array
        tstart = np.concatenate(lane_tstart).astype(np.int32) + tpl_base
        sstart = np.concatenate(lane_sstart).astype(np.int32) + seg_base
    else:
        seg = np.concatenate(lane_seg)
    kw = dict(T=_WS, RL=_SEG, W=W, S=_WS + _SEG, NWIN=max(TB_nwin(_WS), 1),
              lead_free=2 * _LEAD_SLACK)

    def dispatch(sel, dense=False):
        m = len(sel)
        Nc = pad_lanes(next((b for b in _N_LADDER if m <= b <= _WCHUNK),
                            _WCHUNK), group)
        sparse = use_sparse and not dense
        if resident is not None:
            meta = np.zeros((5, Nc), np.int32)
            meta[0] = 1
            meta[0, :m] = tlen[sel]
            meta[1, :m] = slen[sel]
            meta[2, :m] = loc0[sel]
            meta[3, :m] = tstart[sel]
            meta[4, :m] = sstart[sel]
            meta = torch.from_numpy(meta).to(dev)
            cen = torch.empty((Nc, _WS + 1), dtype=torch.int32, device=dev)
            fields = nw_round_resident(store, meta, centers_out=cen, **kw)
            return window_pack(store, meta, fields[:3], cen, sparse,
                               resident=True)
        tpl_c = np.zeros((Nc, _WS), np.uint8)
        seg_c = np.zeros((Nc, _SEG), np.uint8)
        meta = np.zeros((4, Nc), np.int32)  # t_lens, seg_lens, c0, loc0
        meta[0] = 1
        tpl_c[:m] = tpl[sel]
        seg_c[:m] = seg[sel]
        meta[0, :m] = tlen[sel]
        meta[1, :m] = slen[sel]
        meta[3, :m] = loc0[sel]
        tl = np.maximum(tlen[sel, None], 1)
        cen = (np.minimum(rows[None, :], tl) * slen[sel, None]) // tl
        steps = np.zeros((Nc, _WS), np.uint8)
        steps[:m] = np.diff(cen, axis=1).clip(0, 2)
        chars = torch.from_numpy(np.concatenate(
            [pack2bit(local_lanes(x, group, 0)) for x in (tpl_c, seg_c, steps)],
            axis=1)).to(dev)
        meta = torch.from_numpy(np.ascontiguousarray(
            local_lanes(meta, group, 1))).to(dev)
        cen = torch.empty((meta.shape[1], _WS + 1), dtype=torch.int32,
                          device=dev)
        fields = nw_round_packed(chars, meta, centers_out=cen, **kw)
        return gather_lanes(window_pack(chars, meta, fields[:3], cen, sparse,
                                        resident=False), group, 0)

    plan = [np.arange(c0, min(c0 + _WCHUNK, total))
            for c0 in range(0, total, _WCHUNK)]
    with trace.span("cons.win.enqueue"):
        with ThreadPoolExecutor(max_workers=dispatch_workers(4)) as ex:
            handles = list(ex.map(dispatch, plan))
    with trace.span("cons.win.fetch"), trace.span("wait.device"):
        arrs = [_fetch(h) for h in handles]
    trace.count("cons.win.fetch.bytes", sum(a.nbytes for a in arrs))
    bnd = np.arange(_ADV + 1, dtype=np.int64)[None, :]
    intr = np.arange(_ADV, dtype=np.int64)[None, :]

    def decode_dense(sel, packed):
        # band centers at the interior boundaries (rows loc0..loc0+126)
        r = loc0[sel, None] + bnd
        tl = np.maximum(tlen[sel, None].astype(np.int64), 1)
        cen_b = np.minimum(r, tl) * slen[sel, None] // tl
        return _unpack_window_rows(packed[: len(sel)], cen_b)

    ovf_idx: list[int] = []

    def decode_one(args):
        sel, packed = args
        m = len(sel)
        if use_sparse:
            tpl_i = tpl[sel[:, None], loc0[sel, None] + intr].astype(np.int8)
            sym, ins, jp, ovf = _unpack_window_rows_sparse(packed[:m], tpl_i)
            if ovf.any():
                ovf_idx.extend(sel[np.flatnonzero(ovf)].tolist())
        else:
            sym, ins, jp = decode_dense(sel, packed)
        sym_all[sel] = sym
        ins_all[sel] = ins
        jp_all[sel] = jp

    # decode on a pool: numpy's unpack/cumsum passes release the GIL
    with trace.span("cons.win.decode"):
        with ThreadPoolExecutor(max_workers=4) as ex:
            list(ex.map(decode_one, zip(plan, arrs)))
    if ovf_idx:
        # cap-overflow lanes (error-dense windows): exact dense refetch
        # of just those lanes
        trace.count("cons.ovf_refetch", len(ovf_idx))
        # sorted: the decode pool accumulates in completion order, but
        # refetch chunk composition must be deterministic (in a group
        # every rank gathers these chunks)
        allsel = np.asarray(sorted(ovf_idx), dtype=np.int64)
        for c0 in range(0, len(allsel), _WCHUNK):
            sub = allsel[c0 : c0 + _WCHUNK]
            handle = dispatch(sub, dense=True)
            with trace.span("wait.device"):
                packed = _fetch(handle)
            sym, ins, jp = decode_dense(sub, packed)
            sym_all[sub] = sym
            ins_all[sub] = ins
            jp_all[sub] = jp
    return sym_all, ins_all, jp_all


def _fetch(handle: torch.Tensor) -> np.ndarray:
    """A device result block → numpy (the synchronization point)."""
    return handle.cpu().numpy()


def _dispatch_chunk(lanes, chunk, TB, W, centers_for, group=None,
                    dense=False):
    """Assemble + launch one chunk of a full round; returns ``(block,
    centers)``: the result block on the device (padded to the chunk's
    lane bucket) and the chunk's band centers, which the host needs to
    restore absolute jpath from a dense block.  ``dense`` selects the
    dense block (``DENTIST_TPU_DENSE_CONS=1``, and sparse-cap overflow
    refetches).

    ``centers_for(lane_idx)`` supplies each lane's step-clamped band
    center column; reads longer than the 2·T read bucket run on their
    prefix (see :func:`_rl_bucket`).  Templates, reads and the centers'
    0..2 steps travel 2-bit packed to K2p, and K4 packs its fields into
    the block; under a group each rank packs and runs its block of lanes
    and the result blocks are gathered.
    """
    RLB = _rl_bucket(0, TB)
    # non-power-of-2 groups: pad to a lane multiple
    N = pad_lanes(_n_bucket_lanes(len(chunk), TB, W), group)
    tpl = np.zeros((N, TB), dtype=np.uint8)
    t_lens = np.ones(N, dtype=np.int32)
    reads_arr = np.zeros((N, RLB), dtype=np.uint8)
    read_lens = np.zeros(N, dtype=np.int32)
    centers = np.zeros((TB + 1, N), dtype=np.int32)
    for k, li in enumerate(chunk):
        ji, ri, template, r = lanes[li]
        T = len(template)
        tpl[k, :T] = template
        t_lens[k] = T
        rl = min(len(r), RLB)  # see _rl_bucket: >2·T reads cannot pass anyway
        reads_arr[k, :rl] = r[:rl]
        read_lens[k] = rl
        c = centers_for(li)
        centers[: T + 1, k] = c
        centers[T + 1 :, k] = c[T]
    NWIN = max(TB_nwin(TB), 1)
    # the kernel's band moves 0..2 columns per row: centers travel as
    # their first row plus clipped steps (a no-op for the clamped schedules)
    steps = np.clip(np.diff(centers, axis=0), 0, 2).astype(np.uint8).T  # (N, TB)
    meta = np.stack([t_lens, read_lens, centers[0]])
    dev = get_device()
    chars = torch.from_numpy(np.concatenate(
        [pack2bit(local_lanes(x, group, 0)) for x in (tpl, reads_arr, steps)],
        axis=1)).to(dev)
    meta = torch.from_numpy(np.ascontiguousarray(local_lanes(meta, group, 1))).to(dev)
    cen = torch.empty((meta.shape[1], TB + 1), dtype=torch.int32, device=dev)
    fields = nw_round_packed(chars, meta, T=TB, RL=RLB, W=W, S=TB + RLB,
                             NWIN=NWIN, centers_out=cen)
    block = round_pack(chars, fields, cen, TB, RLB, NWIN, sparse=not dense)
    return gather_lanes(block, group, 0), centers


# ======================================================================
# Voting + template rebuild (vectorized host passes)
# ======================================================================


def _votes_of(out: _RoundOut, T: int):
    """(col_votes (T, 5), ins_votes (T+1, 4, 4), cov (T,))."""
    n = out.sym.shape[0]
    if T == 0 or n == 0:
        return (np.zeros((T, 5), np.int32), np.zeros((T + 1, 4, 4), np.int32),
                np.zeros(T, np.int32))
    with trace.span("cons.votes"):
        onehot = out.sym[:, :, None] == np.arange(5, dtype=np.int8)[None, None, :]
        col_votes = onehot.sum(axis=0).astype(np.int32)
        ins_votes = (out.ins[:, :, :, None]
                     == np.arange(1, 5, dtype=np.int8)[None, None, None, :]).sum(
            axis=0).astype(np.int32)
        cov = col_votes.sum(axis=1).astype(np.int32)
    return col_votes, ins_votes, cov


def _rebuild_template(template: np.ndarray, col_votes, ins_votes, cov):
    """Per-column majority + majority-supported insertions (vectorized).

    Returns ``(new_template, src_bnd)`` where ``src_bnd`` (len+1,) maps
    each new boundary to its source boundary in the old template — the
    exact column correspondence that lets the previous round's traceback
    paths (``jpath``) follow template edits (the windowed realign rounds
    anchor on them; a linear stretch would drift by the edit count).
    """
    T = len(template)
    covered = np.flatnonzero(cov > 0)
    lo, hi = (int(covered[0]), int(covered[-1]) + 1) if len(covered) else (0, T)
    # trim junk edge columns: leading/trailing template bases that only
    # coincidentally collect votes (free end gaps bypass them, so they
    # show a sharp coverage jump relative to the adjacent interior)
    while lo < hi - 1 and cov[lo] * 3 < cov[min(lo + 8, hi - 1)]:
        lo += 1
    while hi - 1 > lo and cov[hi - 1] * 3 < cov[max(hi - 9, lo)]:
        hi -= 1

    idx = np.arange(lo, hi)
    # insertion reference coverage: cov[i-1] for i > 0 else cov[i]
    cov_ref = np.maximum(np.where(idx > 0, cov[np.maximum(idx - 1, 0)], cov[idx]), 1)
    iv = ins_votes[lo:hi]  # (M, 4 ranks, 4 bases)
    ins_accept = iv.max(axis=2) * 2 > cov_ref[:, None]  # (M, 4)
    ins_base = iv.argmax(axis=2)  # (M, 4)

    v = col_votes[lo:hi]
    vsum = v.sum(axis=1)
    col_keep = (vsum == 0) | ~(v[:, 4] * 2 > vsum)
    col_char = np.where(vsum == 0, template[lo:hi], v[:, :4].argmax(axis=1))

    # row-major (column, slot) emission: 4 insertion slots then the column
    M = hi - lo
    vals = np.empty((M, 5), dtype=np.int64)
    keep = np.empty((M, 5), dtype=bool)
    vals[:, :4] = ins_base
    keep[:, :4] = ins_accept
    vals[:, 4] = col_char
    keep[:, 4] = col_keep
    parts = vals.reshape(-1)[keep.reshape(-1)]
    # each kept element's pre-boundary is its source column (insertion
    # slots precede column i; the column base sits between i and i+1)
    parts_src = np.repeat(idx, 5)[keep.reshape(-1)]

    # trailing insertions at boundary hi
    iv_hi = ins_votes[hi]
    c_hi = max(cov[hi - 1] if hi > 0 else 1, 1)
    tail_accept = iv_hi.max(axis=1) * 2 > c_hi
    tail = iv_hi.argmax(axis=1)[tail_accept]
    src_bnd = np.concatenate(
        [parts_src, np.full(len(tail) + 1, hi, dtype=np.int64)])
    return np.concatenate([parts, tail]).astype(np.uint8), src_bnd


def _rebuild_maps(old_template: np.ndarray, new_template: np.ndarray,
                  src_bnd: np.ndarray):
    """Column map + changed-column mask for a template rebuild.

    ``src_col[i]`` is the old column new column ``i`` copies (−1 when
    inserted); ``dirty[i]`` marks columns whose content or local
    structure changed (insertion, deletion in the neighborhood, revoted
    base, or edge trim) — the realign set for the next round.
    """
    T_new = len(new_template)
    d = np.diff(src_bnd)
    copied = d == 1
    src_col = np.where(copied, src_bnd[:-1], -1)
    dirty = ~copied  # insertions (d == 0) and deletion sites (d > 1)
    if T_new and len(old_template):
        sc = np.minimum(np.maximum(src_col, 0), len(old_template) - 1)
        dirty |= copied & (new_template != old_template[sc])
        if src_bnd[0] != 0:  # leading trim: col 0's left context changed
            dirty[0] = True
        if src_bnd[-1] != len(old_template):
            dirty[-1] = True
    return src_col, dirty



#: polish-scorer lane buckets (the JAX package's): two V widths and four
#: read-count widths
_V_SMALL, _V_MAX = 512, 8192
_N_BUCKETS = [8, 32, 64, 128]


def _n_bucket(n: int) -> int:
    for b in _N_BUCKETS:
        if n <= b:
            return b
    return _N_BUCKETS[-1]


def _assemble_gain_group(template, pos, kind, base, reads_arr, jpath,
                         NB: int, HALF: int, RW: int, TW: int):
    """Vectorized window assembly for one pile-up's candidate edits.

    Returns (win (K, TW), wlen, ewin (K, TW), elen, seg (K, NB, RW),
    seglen (K, NB), ok (K, NB)) — the per-candidate base and edited
    template windows plus each read's path-anchored segment.  The former
    per-candidate-per-read Python loop was a measured 2.2 s/run host
    hotspot.
    """
    K = len(pos)
    T = len(template)
    n = min(reads_arr.shape[0], NB)
    lo = np.maximum(pos - HALF, 0)
    hi = np.minimum(pos + HALF, T)
    wlen = hi - lo
    ar = np.arange(TW, dtype=np.int64)
    c = ar[None, :]
    idx = lo[:, None] + c
    win = np.where(c < wlen[:, None],
                   template[np.minimum(idx, max(T - 1, 0))], 0).astype(np.uint8)
    d = (pos - lo)[:, None]
    k2 = kind[:, None]
    # edited-window source columns: deletion skips d, insertion shifts
    # right of d (d itself overwritten with the base), substitution copies
    src = np.where(k2 == 0, np.where(c < d, c, c + 1),
                   np.where(k2 == 1, np.where(c <= d, c, c - 1), c))
    ewin = np.take_along_axis(win, np.minimum(src, TW - 1), axis=1)
    at_d = (c == d) & (k2 != 0)
    ewin = np.where(at_d, base[:, None], ewin).astype(np.uint8)
    elen = wlen + (kind == 1).astype(np.int64) - (kind == 0).astype(np.int64)
    ewin = np.where(c < elen[:, None], ewin, 0).astype(np.uint8)

    seg = np.zeros((K, NB, RW), dtype=np.uint8)
    seglen = np.zeros((K, NB), dtype=np.int64)
    ok = np.zeros((K, NB), dtype=bool)
    if n:
        jlo = jpath[:n, lo].T  # (K, n)
        jhi = jpath[:n, hi].T
        ok_n = (jlo >= 0) & (jhi > jlo) & (jhi - jlo <= RW)
        sl = np.where(ok_n, jhi - jlo, 0)
        RL = reads_arr.shape[1]
        ridx = np.clip(jlo[:, :, None], 0, RL - 1) + np.arange(RW)[None, None, :]
        mask = np.arange(RW)[None, None, :] < sl[:, :, None]
        seg[:, :n] = np.where(
            mask, reads_arr[np.arange(n)[None, :, None],
                            np.clip(ridx, 0, RL - 1)], 0)
        seglen[:, :n] = sl
        ok[:, :n] = ok_n
    return win, wlen, ewin, elen, seg, seglen, ok


def _window_gains_multi(groups, W_score: int = 16, HALF: int = 16,
                        group=None):
    """Score candidate edits on path-anchored local windows, batched
    across pile-ups.

    groups: list of (template, pos (K,), kind (K,), base (K,),
    reads_arr, jpath) — one entry per pile-up, so one dispatch mixes
    candidates from many pile-ups.  Both the unedited and edited window
    are scored with a *global* NW against each read's segment between
    its traceback-path coordinates at the window boundaries (anchored
    ends — free ends would let deletions hide in unpenalized gaps).
    Returns flat gains in group order: Σ_reads (base − edit).
    """
    TW = 2 * HALF + 2
    # read-window capacity: segments span ~TW·(1+err) chars (measured
    # p99 = 38 at 13 % error for TW=34); W_score slack absorbs the tail,
    # and longer segments are skipped (ok stays False) — they imply
    # a local blow-up the ±1-edit score can't judge anyway
    RW = 2 * HALF + W_score
    TWp = -(-TW // 4) * 4

    # groups bucket by THEIR read count (a lone 36-read pile-up must not
    # force every other group onto 128 padded read slots)
    counts = [len(g[1]) for g in groups]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    gains_all = np.zeros(int(offsets[-1]), dtype=np.int64)
    by_nb: dict[int, list[int]] = {}
    for gi, g in enumerate(groups):
        if len(g[1]):
            by_nb.setdefault(_n_bucket(g[4].shape[0]), []).append(gi)
    if not by_nb:
        return gains_all

    inflight = []
    dev = get_device()
    with trace.span("cons.gains.assemble+enqueue"):
        for NB, gidx in by_nb.items():
            # per-group window assembly is independent numpy; thread it
            # (the serial loop was ~10 s/run at 147-pile-up scale)
            with ThreadPoolExecutor(max_workers=4) as ex:
                parts = list(ex.map(
                    lambda gi: _assemble_gain_group(*groups[gi][:6], NB, HALF,
                                                    RW, TW), gidx))
            WIN = np.concatenate([p[0] for p in parts])
            WLEN = np.concatenate([p[1] for p in parts])
            EWIN = np.concatenate([p[2] for p in parts])
            ELEN = np.concatenate([p[3] for p in parts])
            SEG = np.concatenate([p[4] for p in parts])
            SLEN = np.concatenate([p[5] for p in parts])
            OK = np.concatenate([p[6] for p in parts])
            # flat output positions of this class's candidates
            dst = np.concatenate([np.arange(offsets[gi], offsets[gi + 1])
                                  for gi in gidx])
            Ktot = len(WIN)
            for c0 in range(0, Ktot, _V_MAX // 2):
                n_chunk = min(_V_MAX // 2, Ktot - c0)
                # two V widths only (see _V_SMALL); non-power-of-2 groups pad
                V = pad_lanes(_V_SMALL // 2 if n_chunk <= _V_SMALL // 2
                              else _V_MAX // 2, group)
                buf = np.zeros((V, 2 * TWp + NB * RW), dtype=np.uint8)
                meta = np.zeros((V, 2 + NB), dtype=np.int32)
                sl = slice(c0, c0 + n_chunk)
                buf[:n_chunk, :TW] = WIN[sl]
                buf[:n_chunk, TWp : TWp + TW] = EWIN[sl]
                buf[:n_chunk, 2 * TWp :] = SEG[sl].reshape(n_chunk, NB * RW)
                meta[:n_chunk, 0] = WLEN[sl]
                meta[:n_chunk, 1] = ELEN[sl]
                meta[:n_chunk, 2:] = SLEN[sl]
                out = nw_dist_pairs_packed(
                    torch.from_numpy(pack2bit(local_lanes(buf, group, 0))).to(dev),
                    torch.from_numpy(local_lanes(meta, group, 0)).to(dev),
                    TW=TW, TWp=TWp, RW=RW, NB=NB)
                out = gather_lanes(out, group, 1)
                inflight.append((dst[sl], OK[sl], n_chunk, out))
    with trace.span("cons.gains.fetch"), trace.span("wait.device"):
        fetched = [t[3].cpu().numpy() for t in inflight]
    for (dst_c, ok_c, n_chunk, _out), dist in zip(inflight, fetched):
        db = dist[0, :n_chunk]
        de = dist[1, :n_chunk]
        okc = ok_c & (db < _INF) & (de < _INF)
        gains_all[dst_c] = np.where(okc, db - de, 0).sum(axis=1)
    return gains_all


def _candidates_from_votes(col_votes, ins_votes, cov, min_votes_frac=0.08,
                           floor_high=3, template=None):
    """Candidate single-base edits: (pos, kind, base); kind 0=del, 1=ins,
    2=substitution.

    The vote floor matters for cost, not just noise: at 13 % error and
    20× coverage a 2-vote floor qualifies ~every column (P[≥2 noise
    votes] ≈ 0.26), making the polish scorer scan the whole template
    every round.  ``floor_high`` applies at ≥12× coverage: 3 for the
    fast early rounds, lowered to 2 by the polish loop's final
    refinement pass — real edits occasionally sit at 2 votes even at
    20× (error-masked in most reads), so the 2-vote fixpoint decides
    byte-exactness.  Below 12× the floor is always 2 (real edits can be
    thin there and noise floods are no concern: P[≥2] ≈ 0.06 at 8×).
    """
    T = col_votes.shape[0]
    floor = np.where(cov >= 12, floor_high, 2)
    min_votes = np.maximum((min_votes_frac * np.maximum(cov, 1)).astype(int),
                           floor)
    candidates: list[tuple[int, int, int]] = []
    for i in np.flatnonzero(col_votes[:, 4] >= min_votes):
        candidates.append((int(i), 0, 0))
    thresh = min_votes[np.clip(np.arange(T + 1) - 1, 0, T - 1)][:, None, None]
    ins_pos, ins_rank, ins_base = np.nonzero(ins_votes >= thresh)
    for i, r, b in zip(ins_pos, ins_rank, ins_base):
        if r == 0:
            candidates.append((int(i), 1, int(b)))
    if template is not None and T:
        # substitution candidates: a non-template base whose column vote
        # is a strong runner-up.  Per-column majority already picked the
        # argmax, but reads with indels near the column scatter their
        # votes across neighbors — the exact window objective re-aligns
        # each read locally and can overturn a misvoted column (the
        # residual-error class votes alone never fix)
        # templates are 2-bit codes by construction; clip defensively so
        # an N/pad code (≥ 4) reaching this boundary cannot fault the
        # polish loop (it would merely skip that column's substitution)
        cur = np.minimum(template[:T].astype(np.int64), 3)
        v = col_votes[:, :4].copy()
        cur_votes = v[np.arange(T), cur]
        v[np.arange(T), cur] = -1
        alt = v.argmax(axis=1)
        alt_votes = v[np.arange(T), alt]
        sel = (alt_votes >= min_votes) & (2 * alt_votes >= cur_votes)
        for i in np.flatnonzero(sel):
            candidates.append((int(i), 2, int(alt[i])))
    return candidates


#: columns within this distance of an applied edit are realigned (the
#: windowed kernel's margins absorb the path wander one edit can cause)
_EDIT_PAD = _MARGIN + 2


def _apply_edits(template: np.ndarray, chosen):
    """Apply spaced single-base edits (descending position order).

    Returns ``(new_template, src_bnd, src_col)``: boundary/column maps
    from new coordinates to old (``src_col[i] = -1`` for inserted
    columns) — the exact correspondence that lets traceback paths, vote
    matrices, and cached gains follow template edits.
    """
    src_bnd = np.arange(len(template) + 1, dtype=np.int64)
    src_col = np.arange(len(template), dtype=np.int64)
    for pos, kind, base in sorted(chosen, reverse=True):
        if kind == 0:
            template = np.delete(template, pos)
            src_bnd = np.delete(src_bnd, pos)
            src_col = np.delete(src_col, pos)
        elif kind == 1:
            template = np.insert(template, pos, base)
            src_bnd = np.insert(src_bnd, pos, src_bnd[pos])
            src_col = np.insert(src_col, pos, -1)
        else:  # substitution (content change; position map unchanged)
            template = template.copy()
            template[pos] = base
    return template, src_bnd, src_col


def _remap_out(prev: _RoundOut, src_bnd: np.ndarray,
               src_col: np.ndarray) -> _RoundOut:
    """Carry a round's stitched arrays through template edits: copied
    columns keep their per-read values, inserted columns start uncovered
    (the dirty realign that follows fills them).  Derived stats
    (spans/diffs/win) go stale — the next realign recomputes them from
    the full stitched arrays."""
    sc = np.maximum(src_col, 0)
    sym = np.where(src_col[None, :] >= 0, prev.sym[:, sc], np.int8(5)).astype(np.int8)
    ins = prev.ins[:, src_bnd]
    jp = prev.jpath[:, src_bnd]
    return _RoundOut(sym, ins, jp, prev.spans, prev.diffs, prev.win,
                     prev.covered)


def _votes_refresh(votes, out: _RoundOut, T: int):
    """Update vote matrices in place on the round's fresh columns (or
    rebuild them wholly after a full round)."""
    if out.fresh_cols is None:
        return list(_votes_of(out, T))
    cv, iv, cov = votes
    cols = np.flatnonzero(out.fresh_cols)
    bnds = np.flatnonzero(out.fresh_bnds)
    if len(cols):
        cvc = (out.sym[:, cols, None]
               == np.arange(5, dtype=np.int8)).sum(axis=0).astype(np.int32)
        cv[cols] = cvc
        cov[cols] = cvc.sum(axis=1)
    if len(bnds):
        iv[bnds] = (out.ins[:, bnds, :, None]
                    == np.arange(1, 5, dtype=np.int8)).sum(axis=0).astype(np.int32)
    return [cv, iv, cov]


def _polish_batch(states, read_sets, W: int, max_rounds: int = 8,
                  tie_policy: str = "delete", group=None):
    """Hill-climb on total edit distance to all reads, batched.

    Candidate edits (single-base insertions, deletions, substitutions)
    come from the vote matrices; an edit is kept only if it reduces the
    exact local objective.  This escapes the local fixpoints of
    per-column majority voting where 13 %-error reads scatter indel
    votes across neighboring columns (daccord's de-Bruijn window
    consensus solves the same problem).

    Cost model (the round-3 bench's 411 s lived here): every candidate's
    exact gain is scored ONCE and cached — candidate sets barely change
    between rounds, and the former per-round rescoring paid ~10× the
    unique-candidate work; after edits are applied, only windows around
    the edit sites realign (``_ConsJob.dirty``) and only their votes and
    nearby cached gains refresh.  All still-improving pile-ups share
    each round's dispatches.

    ``tie_policy`` decides edits whose exact objective TIES (gain 0):
    ``"delete"`` accepts deletions (insertion-biased error profiles:
    PacBio CLR ≈ 55 % ins / 25 % del — the default and what the
    simulator reproduces), ``"insert"`` accepts insertions
    (deletion-biased profiles, e.g. older ONT chemistries), ``"none"``
    rejects all ties.  daccord derives the same tilt from its measured
    error profile (``--eprofonly`` pre-pass, ``dazzler.d:4324``).
    """
    tie_kind = {"delete": 0, "insert": 1}.get(tie_policy)
    HALF = 16
    active = [p for p in range(len(states))
              if len(read_sets[p]) > 1 and len(states[p]["template"])]
    # refresh alignment state where the last rebuild left it stale
    stale = [p for p in active
             if states[p]["stats_stale"] or states[p]["last_out"] is None]
    if stale:
        jobs = [_ConsJob(states[p]["template"], read_sets[p],
                         states[p]["jpath"],
                         prev=(states[p]["last_out"]
                               if states[p].get("dirty") is not None else None),
                         dirty=states[p].get("dirty"),
                         reads_arr=states[p].get("reads_arr"),
                         seg_res=states[p].get("seg_res"),
                         read_offs=states[p].get("read_offs"))
                for p in stale]
        for ai, out in enumerate(_run_round(jobs, W, group)):
            p = stale[ai]
            states[p]["last_out"] = out
            states[p]["jpath"] = out.jpath
            states[p]["stats_stale"] = False
            states[p]["dirty"] = None

    votes = {p: list(_votes_of(states[p]["last_out"],
                               len(states[p]["template"]))) for p in active}
    caches: dict[int, dict] = {p: {} for p in active}
    # two-phase floors: rounds run with the 3-vote candidate floor until
    # a pile-up converges, then a floor-2 refinement catches the rare
    # thin-support true edits (byte-exactness).  The floor-2 flood
    # arrives when the template is nearly final — its cached gains
    # survive (the early rounds' dense edits would have invalidated most
    # of an up-front floor-2 scoring).
    floors = {p: 3 for p in active}

    for _rnd in range(max_rounds + 1):
        if not active:
            break
        # ---- candidates; score only cache misses (exact window gains)
        per_cands: dict[int, list] = {}
        groups, group_meta = [], []
        with trace.span("cons.polish.candidates"):
            for p in active:
                cv, iv, cov = votes[p]
                cands = _candidates_from_votes(cv, iv, cov,
                                               floor_high=floors[p],
                                               template=states[p]["template"])
                per_cands[p] = cands
                miss = [c for c in cands if c not in caches[p]]
                if miss:
                    ca = np.array(miss, dtype=np.int64).reshape(-1, 3)
                    groups.append((states[p]["template"], ca[:, 0], ca[:, 1],
                                   ca[:, 2], states[p]["reads_arr"],
                                   states[p]["jpath"]))
                    group_meta.append((p, miss))
        if groups:
            gains = _window_gains_multi(groups, HALF=HALF, group=group)
            gi = 0
            for p, miss in group_meta:
                for c in miss:
                    caches[p][c] = int(gains[gi])
                    gi += 1

        # ---- choose non-overlapping best edits; apply + remap
        edited: list[int] = []
        next_active: list[int] = []
        dirty_now: dict[int, np.ndarray] = {}
        with trace.span("cons.polish.apply"):
            for p in active:
                mine = sorted(((caches[p][c], c) for c in per_cands[p]),
                              key=lambda x: -x[0])
                chosen, taken_pos = [], []
                for g, (pos, kind, base) in mine:
                    # Ties (g == 0) fall to the error-profile tilt: when the
                    # exact objective cannot decide between "extra base is
                    # real" and "extra base is k coinciding read insertions",
                    # the profile's dominant error kind picks the likelier
                    # explanation (see tie_policy in the docstring).
                    if g < 0 or (g == 0 and kind != tie_kind):
                        continue
                    if all(abs(pos - q) > 2 * HALF for q in taken_pos):
                        chosen.append((pos, kind, base))
                        taken_pos.append(pos)
                if not chosen:
                    if floors[p] > 2:  # converged at floor 3: refine at 2
                        floors[p] = 2
                        next_active.append(p)
                    continue
                st = states[p]
                T_old = len(st["template"])
                dirty_old = np.zeros(T_old, dtype=bool)
                for pos, _kind, _base in chosen:
                    dirty_old[max(pos - _EDIT_PAD, 0)
                              : min(pos + _EDIT_PAD + 1, T_old)] = True
                new_template, src_bnd, src_col = _apply_edits(st["template"], chosen)
                T_new = len(new_template)
                sc = np.maximum(src_col, 0)
                st["template"] = new_template
                st["last_out"] = _remap_out(st["last_out"], src_bnd, src_col)
                st["jpath"] = st["last_out"].jpath
                st["stats_stale"] = True
                dirty_new = np.where(src_col >= 0, dirty_old[sc], True)
                dirty_now[p] = dirty_new
                # votes follow the column map (dirty rows refresh post-realign)
                cv, iv, cov = votes[p]
                votes[p] = [
                    np.where((src_col >= 0)[:, None], cv[sc], 0).astype(np.int32),
                    iv[src_bnd],
                    np.where(src_col >= 0, cov[sc], 0).astype(np.int32),
                ]
                # cached gains follow the position maps; anything near an
                # edit is invalidated (template content + paths change there)
                invalid = _dilate_mask(dirty_new, HALF + 1)
                new_of_col = np.full(T_old, -1, dtype=np.int64)
                m = src_col >= 0
                new_of_col[src_col[m]] = np.flatnonzero(m)
                new_of_bnd = np.full(T_old + 1, -1, dtype=np.int64)
                new_of_bnd[src_bnd] = np.arange(T_new + 1)
                cache_new = {}
                for (pos, kind, base), g in caches[p].items():
                    np_ = (new_of_bnd[pos] if kind == 1
                           else (new_of_col[pos] if pos < T_old else -1))
                    if np_ >= 0 and not invalid[min(np_, T_new - 1)]:
                        cache_new[(int(np_), kind, base)] = g
                caches[p] = cache_new
                edited.append(p)
                next_active.append(p)

        # ---- realign only the windows the edits touched
        if edited:
            jobs = [_ConsJob(states[p]["template"], read_sets[p],
                             states[p]["jpath"], prev=states[p]["last_out"],
                             dirty=dirty_now[p],
                             reads_arr=states[p]["reads_arr"],
                             seg_res=states[p].get("seg_res"),
                             read_offs=states[p].get("read_offs"))
                    for p in edited]
            for ai, out in enumerate(_run_round(jobs, W, group)):
                p = edited[ai]
                states[p]["last_out"] = out
                states[p]["jpath"] = out.jpath
                states[p]["stats_stale"] = False
                votes[p] = _votes_refresh(votes[p], out,
                                          len(states[p]["template"]))
                if out.fresh_cols is not None and out.fresh_cols.any():
                    inv = _dilate_mask(out.fresh_cols, HALF + 1)
                    caches[p] = {k: v for k, v in caches[p].items()
                                 if not inv[min(k[0], len(inv) - 1)]}
        active = next_active


# ======================================================================
# Public API
# ======================================================================


@dataclass
class ConsensusResult:
    sequence: np.ndarray  # consensus codes
    coverage: np.ndarray  # per consensus window: number of covering reads
    read_spans: np.ndarray  # (N, 2) template interval covered per read
    read_diffs: np.ndarray  # (N,) total diffs vs final consensus
    win_diffs: np.ndarray  # (N, n_windows) per-126bp-window diffs (QV signal)


def _result_from(template, out: _RoundOut) -> ConsensusResult:
    T = len(template)
    n_win = max(TB_nwin(T), 1)
    win_cov = np.zeros(n_win, dtype=np.int32)
    for b, e in out.spans:
        wb, we = int(b) // TRACE_SPACING, (max(int(e) - 1, 0)) // TRACE_SPACING
        if e > b:
            win_cov[wb : we + 1] += 1
    return ConsensusResult(template, win_cov, out.spans, out.diffs, out.win)


def _trivial_result(reads: list[np.ndarray]) -> ConsensusResult | None:
    if not reads:
        return ConsensusResult(np.empty(0, np.uint8), np.empty(0, np.int32),
                               np.empty((0, 2), np.int64), np.empty(0, np.int64),
                               np.empty((0, 0), np.int32))
    if len(reads) == 1:
        seq = reads[0]
        return ConsensusResult(seq, np.ones(1, np.int32),
                               np.array([[0, len(seq)]]), np.zeros(1, np.int64),
                               np.zeros((1, 1), np.int32))
    return None


def consensus_batch(read_sets: list[list[np.ndarray]], rounds: int = 3,
                    W: int = 128, template_idxs: list[int | None] | None = None,
                    polish: bool = True, tie_policy: str = "delete",
                    group=None) -> list[ConsensusResult]:
    """Compute consensi for MANY pile-ups; dispatches are shared.

    Each realign round batches the lanes of every still-active pile-up
    into a handful of bucketed kernel launches (the reference
    thread-parallelizes pile-ups, ``processPileUps/package.d:153``; here
    they share launches instead).  With a data-parallel ``group`` every
    launch's lanes split over its ranks, with gathered results (the
    reference's ``--batch`` slices + ``merge-insertions``,
    ``snakemake/Snakefile:1315-1358``); every rank returns the same
    consensi, equal to the single-device ones.
    """
    read_sets = [[np.asarray(r, dtype=np.uint8) for r in rs if len(r) > 0]
                 for rs in read_sets]
    results: list[ConsensusResult | None] = [None] * len(read_sets)
    # device-resident cropped-read store: ONE packed upload serves every
    # windowed realign round of the whole batch (the per-lane read
    # segments were the rounds' largest input stream)
    seg_res = None
    read_offs: list[np.ndarray | None] = [None] * len(read_sets)
    if group is None and not os.environ.get("DENTIST_TPU_DENSE_CONS"):
        offs_all, pos = [], 0
        for rs in read_sets:
            job_offs = np.empty(len(rs), np.int64)
            for i, r in enumerate(rs):
                job_offs[i] = pos
                pos += len(r)
            offs_all.append(job_offs)
        if pos:
            try:
                seg_res = _ArenaRef(
                    np.concatenate([r for rs in read_sets for r in rs]))
                read_offs = offs_all
            except MemoryError:
                seg_res = None  # host-window dispatch (identical results)
    states: list[dict] = []
    for p, reads in enumerate(read_sets):
        triv = _trivial_result(reads)
        t_idx = template_idxs[p] if template_idxs else None
        if triv is not None:
            results[p] = triv
            template = np.empty(0, np.uint8)
        else:
            if t_idx is None:
                order = sorted(range(len(reads)), key=lambda i: len(reads[i]))
                t_idx = order[len(order) // 2]
            template = reads[t_idx]
        RL = max((len(r) for r in reads), default=1)
        reads_arr = np.zeros((len(reads), RL), dtype=np.uint8)
        for n, r in enumerate(reads):
            reads_arr[n, : len(r)] = r
        states.append({"template": template, "jpath": None, "done": False,
                       "last_out": None, "stats_stale": False,
                       "reads_arr": reads_arr, "dirty": None,
                       "seg_res": seg_res, "read_offs": read_offs[p]})

    live = [p for p in range(len(read_sets)) if results[p] is None]
    for rnd in range(rounds):
        active = [p for p in live if not states[p]["done"]
                  and len(states[p]["template"])]
        if not active:
            break
        # rounds after a rebuild realign only windows the rebuild touched
        # (``dirty`` from ``_rebuild_maps``); the late rounds, where the
        # template is nearly converged, cost O(changes) instead of O(T)
        jobs = [_ConsJob(states[p]["template"], read_sets[p],
                         states[p]["jpath"],
                         prev=(states[p]["last_out"]
                               if states[p]["dirty"] is not None else None),
                         dirty=states[p]["dirty"],
                         reads_arr=states[p]["reads_arr"],
                         seg_res=states[p].get("seg_res"),
                         read_offs=states[p].get("read_offs"))
                for p in active]
        outs = _run_round(jobs, W, group)
        for ai, p in enumerate(active):
            st = states[p]
            T = len(st["template"])
            col_votes, ins_votes, cov = _votes_of(outs[ai], T)
            st["jpath"] = outs[ai].jpath
            st["last_out"] = outs[ai]
            new_template, src_bnd = _rebuild_template(st["template"],
                                                      col_votes, ins_votes, cov)
            if len(new_template) == len(st["template"]) and np.array_equal(
                    new_template, st["template"]):
                st["done"] = True
                st["stats_stale"] = False
                st["dirty"] = None
            else:
                src_col, dirty = _rebuild_maps(st["template"], new_template,
                                               src_bnd)
                st["template"] = new_template
                # exact remap: boundary c of the new template maps to
                # source boundary src_bnd[c] of the old one
                st["last_out"] = _remap_out(outs[ai], src_bnd, src_col)
                st["jpath"] = st["last_out"].jpath
                st["dirty"] = _dilate_mask(dirty, _EDIT_PAD)
                st["stats_stale"] = True

    if polish:
        _polish_batch([states[p] for p in live],
                      [read_sets[p] for p in live], W,
                      tie_policy=tie_policy, group=group)

    # refresh stats for pile-ups whose template changed after their last round
    stale = [p for p in live if states[p]["stats_stale"]
             and len(states[p]["template"])]
    if stale:
        jobs = [_ConsJob(states[p]["template"], read_sets[p],
                         states[p]["jpath"],
                         prev=(states[p]["last_out"]
                               if states[p]["dirty"] is not None else None),
                         dirty=states[p]["dirty"],
                         reads_arr=states[p]["reads_arr"],
                         seg_res=states[p].get("seg_res"),
                         read_offs=states[p].get("read_offs"))
                for p in stale]
        outs = _run_round(jobs, W, group)
        for ai, p in enumerate(stale):
            states[p]["last_out"] = outs[ai]
            states[p]["stats_stale"] = False

    for p in live:
        st = states[p]
        if st["last_out"] is None or len(st["template"]) == 0:
            results[p] = ConsensusResult(
                st["template"], np.zeros(1, np.int32),
                np.zeros((len(read_sets[p]), 2), np.int64),
                np.zeros(len(read_sets[p]), np.int64),
                np.zeros((len(read_sets[p]), 1), np.int32))
        else:
            results[p] = _result_from(st["template"], st["last_out"])
    return results


def consensus(reads: list[np.ndarray], rounds: int = 3, W: int = 128,
              template_idx: int | None = None, polish: bool = True,
              tie_policy: str = "delete", group=None) -> ConsensusResult:
    """Compute one pile-up's consensus (see :func:`consensus_batch`).

    ``tie_policy`` selects the error-profile tilt applied to
    cost-tied polish edits — ``"delete"`` (insertion-biased reads, the
    CLR default), ``"insert"`` (deletion-biased), or ``"none"``.
    """
    return consensus_batch([reads], rounds=rounds, W=W,
                           template_idxs=[template_idx], polish=polish,
                           tie_policy=tie_policy, group=group)[0]


def rank_reference_reads(win_diffs: np.ndarray, spans: np.ndarray,
                         bad_fraction: float = 0.8) -> np.ndarray:
    """Rank pile-up reads as consensus reference candidates.

    Mirrors ``findReferenceReadCandidates``
    (``processPileUps/package.d:518-568``): the intrinsic-QV histogram's
    value at cumulative ``bad_fraction`` becomes the bad-window
    threshold; reads are ordered by (number of bad windows, mean QV).
    Windows outside a read's covered span are ignored.
    """
    n, n_win = win_diffs.shape
    if n == 0:
        return np.empty(0, dtype=np.int64)
    wb = spans[:, 0] // TRACE_SPACING
    we = np.maximum(spans[:, 1] - 1, 0) // TRACE_SPACING
    cols = np.arange(n_win)[None, :]
    in_span = (cols >= wb[:, None]) & (cols <= we[:, None]) & (
        spans[:, 1] > spans[:, 0])[:, None]
    vals = win_diffs[in_span]
    if len(vals) == 0:
        return np.argsort(np.zeros(n), kind="stable")
    bad_qv = np.quantile(vals, bad_fraction)
    n_bad = ((win_diffs >= max(bad_qv, 1)) & in_span).sum(axis=1)
    denom = np.maximum(in_span.sum(axis=1), 1)
    mean_qv = win_diffs.sum(axis=1, where=in_span) / denom
    mean_qv = np.where(in_span.any(axis=1), mean_qv, np.inf)
    return np.lexsort((mean_qv, n_bad))
