"""K2, the banded realign round: forward NW DP plus traceback.

Port of ``dentist_tpu/ops/consensus.py:_nw_round_parts``.  For N
independent (template, read) lanes it fills a W-cell band per template
row (free leading template gap, ``lead_free`` leading read chars free
or all of them), picks the first best "read exhausted" row, traces the
path back and reduces it into dense per-lane columns:

- ``sym`` (N, T) int8 — 0..3 read base, 4 deletion, 5 uncovered;
- ``ins`` (N, T+1, 4) int8 — ranked insertions before each column
  (0 none, 1..4 base+1);
- ``jpath`` (N, T+1) int32 — read coordinate crossing each template
  boundary (−1 uncovered);
- ``spans`` (N, 2), ``diffs`` (N,), ``win`` (N, NWIN) int32 and
  ``covered`` (N,) bool.

:func:`nw_round` launches ``csrc/nw_round.cu`` for CUDA tensors and runs
:func:`nw_round_reference`, the plain PyTorch version, for CPU tensors.
Every band width 1 <= W <= 1024 runs (the card kernel keeps the band
in registers; JAX's windowed rounds take W <= 128, which
``ops/consensus.py`` checks).

:func:`nw_round_packed` (K2p, port of ``_nw_round_packed`` and of the
2-bit input of ``_nw_window_round``) takes the lanes as one 2-bit packed
row each — [template | read | band-center steps] — and rebuilds the
centers on the device as the running sum of the steps; its plain version
unpacks and calls :func:`nw_round_reference`.

:func:`nw_round_resident` (K2r, port of ``_window_resident_inputs`` with
the DP of ``_nw_window_round_resident(_dense)``) takes windowed lanes as
five coordinates each and reads their characters from the device store;
its plain version, :func:`window_resident_inputs`, gathers the windows
and the proportional band centers as JAX does and calls
:func:`nw_round_reference`.

The packed and resident modes can hand their band centers to the result
packing (``ops/round_pack.py``) through ``centers_out``, an (N, T+1)
int32 tensor that they fill.
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import KernelError
from .pack2 import unpack2bit

__all__ = ["nw_round", "nw_round_reference", "nw_round_packed",
           "nw_round_packed_reference", "nw_round_resident",
           "window_resident_inputs", "INF"]

INF = 1 << 28
_DIAG, _UP, _LEFT, _NONE = 0, 1, 2, 3
_TRACE = 126


def _move_row_bytes(W: int) -> int:
    """Bytes of the kernel's move scratch per template row: 2 bits for
    each of the 32 V band cells a warp holds (V = 4 up to W = 128, else
    32)."""
    return 32 if W <= 128 else 256


#: launches of the K2 kernel on unpacked inputs (never of the plain version)
launches = 0
#: launches of the K2 kernel on 2-bit packed inputs (K2p)
packed_launches = 0
#: launches of the K2 kernel on windows in the device store (K2r)
resident_launches = 0


def _check_args(tpl, t_lens, reads, read_lens, centers, T, W, S, NWIN):
    N, RL = reads.shape
    if tpl.shape != (T, N) or centers.shape != (T + 1, N):
        raise KernelError("tpl must be (T, N) and centers (T+1, N)")
    if t_lens.shape != (N,) or read_lens.shape != (N,):
        raise KernelError("t_lens and read_lens must be (N,)")
    if tpl.dtype != torch.uint8 or reads.dtype != torch.uint8:
        raise KernelError("tpl and reads must be uint8")
    for x in (t_lens, read_lens, centers):
        if x.dtype != torch.int32:
            raise KernelError("t_lens, read_lens and centers must be int32")
    devs = {x.device for x in (tpl, t_lens, reads, read_lens, centers)}
    if len(devs) != 1:
        raise KernelError("nw_round inputs must share a device")
    if not 1 <= W <= 1024 or T < 1 or RL < 1 or S < 0 or NWIN < 1:
        raise KernelError(f"unsupported shape T={T} W={W} RL={RL}")
    return N, RL


def nw_round(tpl, t_lens, reads, read_lens, centers, T: int, W: int, S: int,
             NWIN: int, lead_free: int = -1):
    """One realign round for N lanes (see the module docstring).

    ``tpl`` (T, N) uint8, ``t_lens`` (N,) int32, ``reads`` (N, RL)
    uint8, ``read_lens`` (N,) int32, ``centers`` (T+1, N) int32.
    Returns ``(sym, ins, jpath, spans, diffs, win, covered)`` tensors on
    the inputs' device."""
    global launches
    N, RL = _check_args(tpl, t_lens, reads, read_lens, centers, T, W, S, NWIN)
    dev = tpl.device
    if dev.type == "cpu":
        return nw_round_reference(tpl, t_lens, reads, read_lens, centers,
                                  T, W, S, NWIN, lead_free)
    if dev.type != "cuda":
        raise KernelError(f"nw_round: no kernel for device {dev}")
    tpl_nt = tpl.t().contiguous()
    cen_nt = centers.t().contiguous()
    reads = reads.contiguous()
    t_lens = t_lens.contiguous()
    read_lens = read_lens.contiguous()
    moves = torch.empty((N, T, _move_row_bytes(W)), dtype=torch.uint8,
                        device=dev)
    sym = torch.empty((N, T), dtype=torch.int8, device=dev)
    ins = torch.empty((N, T + 1, 4), dtype=torch.int8, device=dev)
    jpath = torch.empty((N, T + 1), dtype=torch.int32, device=dev)
    spans = torch.empty((N, 2), dtype=torch.int32, device=dev)
    diffs = torch.empty((N,), dtype=torch.int32, device=dev)
    win = torch.empty((N, NWIN), dtype=torch.int32, device=dev)
    covered = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        fn = _build.kernel_fn("dentist_nw_round", 13, 8)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(tpl_nt.data_ptr(), t_lens.data_ptr(), reads.data_ptr(),
                        read_lens.data_ptr(), cen_nt.data_ptr(),
                        moves.data_ptr(), sym.data_ptr(), ins.data_ptr(),
                        jpath.data_ptr(), spans.data_ptr(), diffs.data_ptr(),
                        win.data_ptr(), covered.data_ptr(),
                        N, T, RL, W, S, NWIN, lead_free, _TRACE, stream)
        _build.check("dentist_nw_round", status)
        with _build.launch_lock:
            launches += 1
    return sym, ins, jpath, spans, diffs, win, covered


def _check_packed(chars_pack, meta, T, RL, W, S, NWIN):
    if chars_pack.dtype != torch.uint8 or chars_pack.dim() != 2:
        raise KernelError("chars_pack must be a 2-D uint8 tensor")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[0] not in (3, 4):
        raise KernelError("meta must be a (3 | 4, N) int32 tensor")
    if chars_pack.device != meta.device:
        raise KernelError("chars_pack and meta must share a device")
    N = meta.shape[1]
    if T % 4 or RL % 4 or tuple(chars_pack.shape) != (N, (2 * T + RL) // 4):
        raise KernelError(f"chars_pack must be (N, (2T + RL)/4) with T, RL "
                          f"multiples of 4; got {tuple(chars_pack.shape)}, "
                          f"T={T}, RL={RL}")
    if not 1 <= W <= 1024 or T < 1 or RL < 1 or S < 0 or NWIN < 1:
        raise KernelError(f"unsupported shape T={T} W={W} RL={RL}")
    return N


def _check_centers_out(centers_out, N, T, dev):
    if centers_out is not None and (
            centers_out.dtype != torch.int32
            or tuple(centers_out.shape) != (N, T + 1)
            or centers_out.device != dev or not centers_out.is_contiguous()):
        raise KernelError("centers_out must be a contiguous (N, T+1) int32 "
                          "tensor on the inputs' device")


def nw_round_packed(chars_pack, meta, T: int, RL: int, W: int, S: int,
                    NWIN: int, lead_free: int = -1, centers_out=None):
    """K2p: one realign round for N lanes given 2-bit packed.

    ``chars_pack`` (N, T/4 + RL/4 + T/4) uint8 = [template | read |
    band-center steps] per lane (:func:`~.pack2.pack2bit`; steps are
    0..2); ``meta`` (3, N) or (4, N) int32 rows t_lens, read_lens, first
    band center (and ``loc0`` for windowed rounds, which the kernel does
    not read).  Returns the seven outputs of :func:`nw_round`; fills
    ``centers_out`` (N, T+1) with the band centers when it is given."""
    global packed_launches
    N = _check_packed(chars_pack, meta, T, RL, W, S, NWIN)
    dev = chars_pack.device
    _check_centers_out(centers_out, N, T, dev)
    if dev.type == "cpu":
        return nw_round_packed_reference(chars_pack, meta, T, RL, W, S, NWIN,
                                         lead_free, centers_out)
    if dev.type != "cuda":
        raise KernelError(f"nw_round_packed: no kernel for device {dev}")
    chars_pack = chars_pack.contiguous()
    meta = meta.contiguous()
    centers = (centers_out if centers_out is not None else
               torch.empty((N, T + 1), dtype=torch.int32, device=dev))
    moves = torch.empty((N, T, _move_row_bytes(W)), dtype=torch.uint8,
                        device=dev)
    sym = torch.empty((N, T), dtype=torch.int8, device=dev)
    ins = torch.empty((N, T + 1, 4), dtype=torch.int8, device=dev)
    jpath = torch.empty((N, T + 1), dtype=torch.int32, device=dev)
    spans = torch.empty((N, 2), dtype=torch.int32, device=dev)
    diffs = torch.empty((N,), dtype=torch.int32, device=dev)
    win = torch.empty((N, NWIN), dtype=torch.int32, device=dev)
    covered = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        fn = _build.kernel_fn("dentist_nw_round_packed", 11, 8)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(chars_pack.data_ptr(), meta.data_ptr(),
                        centers.data_ptr(), moves.data_ptr(), sym.data_ptr(),
                        ins.data_ptr(), jpath.data_ptr(), spans.data_ptr(),
                        diffs.data_ptr(), win.data_ptr(), covered.data_ptr(),
                        N, T, RL, W, S, NWIN, lead_free, _TRACE, stream)
        _build.check("dentist_nw_round_packed", status)
        with _build.launch_lock:
            packed_launches += 1
    return sym, ins, jpath, spans, diffs, win, covered


def nw_round_packed_reference(chars_pack, meta, T: int, RL: int, W: int,
                              S: int, NWIN: int, lead_free: int = -1,
                              centers_out=None):
    """Plain PyTorch version of :func:`nw_round_packed`: unpack, rebuild
    the centers with a cumulative sum, run :func:`nw_round_reference`."""
    codes = unpack2bit(chars_pack)
    tpl = codes[:, :T].t().contiguous()
    reads = codes[:, T : T + RL].contiguous()
    steps = codes[:, T + RL :].t().to(torch.int32)
    c0 = meta[2][None, :]
    centers = torch.cat([c0, c0 + torch.cumsum(steps, 0, dtype=torch.int32)])
    if centers_out is not None:
        centers_out.copy_(centers.t())
    return nw_round_reference(tpl, meta[0].contiguous(), reads,
                              meta[1].contiguous(), centers, T, W, S, NWIN,
                              lead_free)


def _check_resident(store, meta, T, RL, W, S, NWIN):
    if store.dtype != torch.uint8 or store.dim() != 1:
        raise KernelError("store must be a 1-D uint8 tensor")
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[0] != 5:
        raise KernelError("meta must be a (5, N) int32 tensor")
    if store.device != meta.device:
        raise KernelError("store and meta must share a device")
    if not max(T, RL) <= store.numel() < 1 << 31:
        raise KernelError("store size out of range")
    if not 1 <= W <= 1024 or T < 1 or RL < 1 or S < 0 or NWIN < 1:
        raise KernelError(f"unsupported shape T={T} W={W} RL={RL}")
    return meta.shape[1]


def nw_round_resident(store, meta, T: int, RL: int, W: int, S: int,
                      NWIN: int, lead_free: int = -1, centers_out=None):
    """K2r: one windowed realign round for N lanes whose characters lie
    in the device store.

    ``store`` (L,) uint8 (a :class:`~.banded.DeviceStore`'s array);
    ``meta`` (5, N) int32 rows t_lens, seg_lens, loc0, tpl_start,
    seg_start: lane n's template is ``store[tpl_start:][:T]`` cut at
    t_len and its read segment ``store[seg_start:][:RL]`` cut at seg_len
    (zeros past them; starts clamped into the store).  The band centers
    are the proportional schedule of :func:`window_resident_inputs`.
    Returns the seven outputs of :func:`nw_round`; fills ``centers_out``
    (N, T+1) when it is given."""
    global resident_launches
    N = _check_resident(store, meta, T, RL, W, S, NWIN)
    dev = store.device
    _check_centers_out(centers_out, N, T, dev)
    if dev.type == "cpu":
        tpl, reads, t_lens, seg_lens, centers, _ = window_resident_inputs(
            store, meta, T, RL)
        if centers_out is not None:
            centers_out.copy_(centers.t())
        return nw_round_reference(tpl, t_lens, reads, seg_lens, centers, T,
                                  W, S, NWIN, lead_free)
    if dev.type != "cuda":
        raise KernelError(f"nw_round_resident: no kernel for device {dev}")
    if not (store.is_contiguous() and meta.is_contiguous()):
        raise KernelError("nw_round_resident takes contiguous tensors")
    centers = (centers_out if centers_out is not None else
               torch.empty((N, T + 1), dtype=torch.int32, device=dev))
    moves = torch.empty((N, T, _move_row_bytes(W)), dtype=torch.uint8,
                        device=dev)
    sym = torch.empty((N, T), dtype=torch.int8, device=dev)
    ins = torch.empty((N, T + 1, 4), dtype=torch.int8, device=dev)
    jpath = torch.empty((N, T + 1), dtype=torch.int32, device=dev)
    spans = torch.empty((N, 2), dtype=torch.int32, device=dev)
    diffs = torch.empty((N,), dtype=torch.int32, device=dev)
    win = torch.empty((N, NWIN), dtype=torch.int32, device=dev)
    covered = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        fn = _build.kernel_fn("dentist_nw_round_resident", 11, 9)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(store.data_ptr(), meta.data_ptr(), centers.data_ptr(),
                        moves.data_ptr(), sym.data_ptr(), ins.data_ptr(),
                        jpath.data_ptr(), spans.data_ptr(), diffs.data_ptr(),
                        win.data_ptr(), covered.data_ptr(), store.numel(), N,
                        T, RL, W, S, NWIN, lead_free, _TRACE, stream)
        _build.check("dentist_nw_round_resident", status)
        with _build.launch_lock:
            resident_launches += 1
    return sym, ins, jpath, spans, diffs, win, covered


def window_resident_inputs(store, meta, T: int, RL: int):
    """Plain PyTorch version of K2r's inputs (JAX's
    ``_window_resident_inputs``): ``(tpl (T, N) uint8, reads (N, RL)
    uint8, t_lens, seg_lens, centers (T+1, N) int32, loc0)`` from the
    store and the (5, N) coordinates."""
    t_lens, seg_lens, loc0 = meta[0], meta[1], meta[2]
    L = store.numel()
    dev = store.device

    def rows(start, size, lens):
        s = start.to(torch.int64).clamp(0, L - size)  # dynamic_slice clamps
        col = torch.arange(size, device=dev)
        r = store[s[:, None] + col[None, :]]
        return torch.where(col[None, :] < lens[:, None], r, 0)

    tpl = rows(meta[3], T, t_lens)
    reads = rows(meta[4], RL, seg_lens)
    r = torch.arange(T + 1, dtype=torch.int32, device=dev)[None, :]
    tl = torch.clamp(t_lens, min=1)[:, None]
    cen = torch.div(torch.minimum(r, tl) * seg_lens[:, None], tl,
                    rounding_mode="floor")
    steps = torch.clamp(cen[:, 1:] - cen[:, :-1], 0, 2)
    centers = torch.cat([torch.zeros_like(steps[:, :1]),
                         torch.cumsum(steps, 1, dtype=torch.int32)], 1)
    return (tpl.t().contiguous(), reads.contiguous(), t_lens.contiguous(),
            seg_lens.contiguous(), centers.t().contiguous(), loc0)


def nw_round_reference(tpl, t_lens, reads, read_lens, centers, T: int, W: int,
                       S: int, NWIN: int, lead_free: int = -1):
    """Plain PyTorch version of :func:`nw_round`: a Python loop over
    template rows and traceback steps, vectorized over lanes.

    Lanes are independent, so equal lanes (the padding of a dispatch's
    lane bucket) run once and their outputs are copied."""
    key = torch.cat([tpl.t().to(torch.int64), reads.to(torch.int64),
                     t_lens[:, None].to(torch.int64),
                     read_lens[:, None].to(torch.int64),
                     centers.t().to(torch.int64)], 1)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    if len(uniq) == len(key):
        return _nw_round_lanes(tpl, t_lens, reads, read_lens, centers, T, W,
                               S, NWIN, lead_free)
    RL = reads.shape[1]
    cols = [0, T, T + RL, T + RL + 1, T + RL + 2, uniq.shape[1]]
    u_tpl, u_reads, u_tl, u_rl, u_cen = (uniq[:, a:b] for a, b in
                                         zip(cols, cols[1:]))
    out = _nw_round_lanes(u_tpl.t().to(tpl.dtype), u_tl[:, 0].to(t_lens.dtype),
                          u_reads.to(reads.dtype), u_rl[:, 0].to(read_lens.dtype),
                          u_cen.t().to(centers.dtype), T, W, S, NWIN, lead_free)
    return tuple(x[inv] for x in out)


def _nw_round_lanes(tpl, t_lens, reads, read_lens, centers, T: int, W: int,
                    S: int, NWIN: int, lead_free: int = -1):
    dev = tpl.device
    i64 = torch.int64
    N, RL = reads.shape
    tplT = (tpl.t().to(i64) & 3)  # (N, T)
    rd = reads.to(i64) & 3
    rl = read_lens.to(i64)
    tl = t_lens.to(i64)
    cen = centers.t().to(i64)  # (N, T+1)
    p = torch.arange(W, device=dev, dtype=i64)[None, :]
    lane = torch.arange(N, device=dev)
    rl_clip = torch.clamp(rl - W // 2, min=0)

    def off_from(c):  # c is (N,) or (N, X)
        clip = rl_clip.view(N, *([1] * (c.dim() - 1)))
        return torch.minimum(torch.clamp(c - W // 2, min=-(W // 2)), clip)

    offs = off_from(cen)  # (N, T+1)
    j0 = offs[:, :1] + p
    d_init = (torch.zeros_like(j0) if lead_free < 0
              else torch.clamp(j0 - lead_free, min=0))
    D = torch.where((j0 >= 0) & (j0 <= rl[:, None]), d_init, INF)
    # rows past every lane's template are all invalid: no moves, no ends
    moves = torch.full((T, N, W), _NONE, dtype=torch.uint8, device=dev)
    d_at = torch.full((T, N), INF, dtype=i64, device=dev)
    T_eff = min(T, int(tl.max())) if N else 0
    for i in range(1, T_eff + 1):
        off = offs[:, i : i + 1]
        s = off - offs[:, i - 1 : i]
        # the band shifted by s (any s; the host's centers give 0..2):
        # D[q] for 0 <= q < W, INF outside
        E = torch.where((p + s >= 0) & (p + s < W),
                        D.gather(1, (p + s).clamp(0, W - 1)), INF)
        E1 = torch.where((p + s >= 1) & (p + s <= W),
                         D.gather(1, (p + s - 1).clamp(0, W - 1)), INF)
        r_ch = rd.gather(1, torch.clamp(off - 1 + p, 0, RL - 1))
        j = off + p
        sub = (r_ch != tplT[:, i - 1 : i]).to(i64)
        diag = torch.where(j >= 1, E1 + sub, INF)
        up = E + 1
        up = torch.where(j == 0, torch.clamp(up, max=0), up)
        tmp = torch.minimum(diag, up)
        choose_up = up < diag
        D = torch.cummin(tmp - p, dim=1).values + p
        from_left = D < tmp
        valid = (j >= 0) & (j <= rl[:, None]) & (i <= tl)[:, None]
        D = torch.where(valid, torch.clamp(D, max=INF), INF)
        move = torch.where(from_left, _LEFT, torch.where(choose_up, _UP, _DIAG))
        move = move | (r_ch << 2) | (sub << 4)
        moves[i - 1] = torch.where(valid, move, _NONE).to(torch.uint8)
        d_at[i - 1] = torch.where((j == rl[:, None]) & valid, D, INF).min(dim=1).values

    dmin = d_at.min(dim=0).values
    best_i = torch.argmin(d_at, dim=0) + 1
    covered = dmin < INF
    i0 = torch.where(covered, best_i, 0)
    j_start = torch.where(covered, rl, 0)

    # traceback over path steps (i or j strictly decreases)
    i, j = i0, j_start
    run = torch.zeros(N, dtype=i64, device=dev)
    active = covered & (i0 > 0) & (j_start > 0)
    steps_I, steps_J, steps_MV, steps_RUN = [], [], [], []
    for step in range(S):
        if step % 64 == 0 and not bool(active.any()):
            break
        off = off_from(cen.gather(1, torch.clamp(i, 0, T)[:, None])[:, 0])
        pp = j - off
        inb = (pp >= 0) & (pp < W) & (i >= 1)
        mv_raw = moves[torch.clamp(i - 1, 0, T - 1), lane,
                       torch.clamp(pp, 0, W - 1)].to(i64)
        mv_raw = torch.where(active & inb, mv_raw, _NONE)
        steps_I.append(i)
        steps_J.append(j)
        steps_MV.append(mv_raw)
        steps_RUN.append(run)
        mv = mv_raw & 3
        is_d, is_u, is_l = mv == _DIAG, mv == _UP, mv == _LEFT
        i = i - (is_d | is_u).to(i64)
        j = j - (is_d | is_l).to(i64)
        run = torch.where(is_l, run + 1, 0)
        active = active & (mv != _NONE) & (i > 0) & (j > 0)
    i_f = i

    sym0 = torch.full((N, T + 1), 5, dtype=i64, device=dev)
    ins0 = torch.zeros((N, (T + 2) * 4), dtype=i64, device=dev)
    jp0 = torch.full((N, T + 2), -1, dtype=i64, device=dev)
    jp0[lane, torch.clamp(i0, 0, T)] = torch.where(covered, j_start, -1)
    win0 = torch.zeros((N, NWIN + 1), dtype=i64, device=dev)
    if steps_I:
        I = torch.stack(steps_I, dim=1)  # (N, steps)
        J = torch.stack(steps_J, dim=1)
        MV_RAW = torch.stack(steps_MV, dim=1)
        RUN = torch.stack(steps_RUN, dim=1)
        MV = MV_RAW & 3
        base = (MV_RAW >> 2) & 3
        diag_or_up = (MV == _DIAG) | (MV == _UP)
        is_left = MV == _LEFT
        symval = torch.where(MV == _DIAG, base, 4)
        sym0.scatter_reduce_(
            1, torch.where(diag_or_up, torch.clamp(I - 1, 0, T - 1), T),
            torch.where(diag_or_up, symval, 127), reduce="amin")
        ins_ok = is_left & (RUN < 4)
        ins0.scatter_reduce_(
            1, torch.where(ins_ok, torch.clamp(I, 0, T), T + 1) * 4
            + torch.where(ins_ok, RUN, 0),
            torch.where(ins_ok, base + 1, 0), reduce="amax")
        jp0.scatter_reduce_(
            1, torch.where(diag_or_up, torch.clamp(I - 1, 0, T), T + 1),
            torch.where(diag_or_up, J - (MV == _DIAG).to(i64), -1),
            reduce="amax")
        mism = (MV == _DIAG) & (((MV_RAW >> 4) & 1) == 1)
        contrib = mism | (MV == _UP) | is_left
        w = torch.where(is_left, torch.minimum(I, tl[:, None] - 1), I - 1) // _TRACE
        win0.scatter_add_(
            1, torch.where(contrib, torch.clamp(w, 0, NWIN - 1), NWIN),
            contrib.to(i64))
    sym = sym0[:, :T].to(torch.int8)
    ins = ins0.view(N, T + 2, 4)[:, : T + 1].to(torch.int8)
    jpath = jp0[:, : T + 1].to(torch.int32)
    spans = torch.stack([torch.where(covered, i_f, 0),
                         torch.where(covered, i0, 0)], dim=1).to(torch.int32)
    diffs = torch.where(covered, dmin, 0).to(torch.int32)
    win = win0[:, :NWIN].to(torch.int32)
    return sym, ins, jpath, spans, diffs, win, covered
