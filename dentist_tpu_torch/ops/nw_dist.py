"""K3, the polish scorer: full-width global NW distances; K3f and K3b,
the JAX package's other two scorer modes.

Port of ``dentist_tpu/ops/consensus.py:_nw_dist_full`` with
``global_ends=True`` and of its caller's pairing,
``_nw_dist_pair_packed``: each candidate edit's base window and edited
window (≤ TW template chars) are scored against the same NB read
segments (≤ RW chars each), as exact global edit distances.

:func:`nw_dist_pairs` launches ``csrc/nw_dist.cu`` for CUDA tensors and
runs :func:`nw_dist_pairs_reference` for CPU tensors.  The kernel is
bit-parallel (Myers's algorithm, one thread per read slot scoring both
windows); its plain version is the cell DP JAX runs, so the two agree
only because both are exact.
:func:`nw_dist_pairs_packed` (K3p) takes the same rows 2-bit packed, as
``_nw_dist_pair_packed`` does; its plain version unpacks and calls
:func:`nw_dist_pairs_reference`.

:func:`nw_dist_full` (K3f) is ``_nw_dist_full`` on its general layout
in either end mode, and :func:`banded_nw_dist` (K3b) is
``_banded_nw_dist``: no path of the JAX package calls them (its scorer
is ``_nw_dist_pair_packed``), so no path of the port does either; each
launches for CUDA tensors and runs its plain version
(:func:`nw_dist_full_reference`, :func:`banded_nw_dist_reference`) for
CPU tensors.  K3f's kernel is K3's bit-parallel step on bytes compared
whole (free-shift ends: Myers's search form), so it too agrees with its
plain cell DP only because both are exact.
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import KernelError
from .pack2 import unpack2bit

__all__ = ["nw_dist_pairs", "nw_dist_pairs_reference", "nw_dist_pairs_packed",
           "nw_dist_pairs_packed_reference", "nw_dist_full",
           "nw_dist_full_reference", "banded_nw_dist",
           "banded_nw_dist_reference", "INF"]

INF = 1 << 28
#: the kernel holds a read as two 64-bit words at most: reads up to 127
#: chars
_RW_MAX = 127
#: K3b keeps a band of its row per thread: bands up to 256 cells
_BAND_MAX = 256

#: launches of the K3 kernel on unpacked rows (never of the plain version)
launches = 0
#: launches of the K3 kernel on 2-bit packed rows (K3p)
packed_launches = 0
#: launches of K3f, the general-layout full-width scorer
full_launches = 0
#: launches of K3b, the banded scorer
banded_launches = 0


def nw_dist_pairs(buf: torch.Tensor, meta: torch.Tensor, TW: int, TWp: int,
                  RW: int, NB: int) -> torch.Tensor:
    """Global edit distances of V candidates' (base, edited) windows
    against their NB read segments.

    ``buf`` (V, 2·TWp + NB·RW) uint8 = [base window | edited window | NB
    read segments]; ``meta`` (V, 2 + NB) int32 = [base len, edited len,
    segment lens...].  Returns (2, V, NB) int32: base and edit
    distances (``INF`` where a window is empty)."""
    global launches
    V = meta.shape[0]
    if buf.dtype != torch.uint8 or buf.shape != (V, 2 * TWp + NB * RW):
        raise KernelError("buf must be (V, 2*TWp + NB*RW) uint8")
    if meta.dtype != torch.int32 or meta.shape != (V, 2 + NB):
        raise KernelError("meta must be (V, 2 + NB) int32")
    if buf.device != meta.device:
        raise KernelError("buf and meta must share a device")
    if not 0 < TW <= TWp or not 0 < RW <= _RW_MAX:
        raise KernelError(f"unsupported shape TW={TW} TWp={TWp} RW={RW}")
    dev = buf.device
    if dev.type == "cpu":
        return nw_dist_pairs_reference(buf, meta, TW, TWp, RW, NB)
    if dev.type != "cuda":
        raise KernelError(f"nw_dist_pairs: no kernel for device {dev}")
    buf = buf.contiguous()
    meta = meta.contiguous()
    out = torch.empty((2, V, NB), dtype=torch.int32, device=dev)
    if V and NB:
        fn = _build.kernel_fn("dentist_nw_dist", 3, 5)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(buf.data_ptr(), meta.data_ptr(), out.data_ptr(),
                        V, TW, TWp, RW, NB, stream)
        _build.check("dentist_nw_dist", status)
        with _build.launch_lock:
            launches += 1
    return out


def nw_dist_pairs_packed(chars_pack: torch.Tensor, meta: torch.Tensor, TW: int,
                         TWp: int, RW: int, NB: int) -> torch.Tensor:
    """K3p: :func:`nw_dist_pairs` on ``chars_pack`` (V, (2·TWp +
    NB·RW)/4) uint8, the 2-bit packed rows of ``buf``."""
    global packed_launches
    V = meta.shape[0]
    L = 2 * TWp + NB * RW
    if L % 4 or chars_pack.dtype != torch.uint8 or chars_pack.shape != (V, L // 4):
        raise KernelError("chars_pack must be (V, (2*TWp + NB*RW)/4) uint8")
    if meta.dtype != torch.int32 or meta.shape != (V, 2 + NB):
        raise KernelError("meta must be (V, 2 + NB) int32")
    if chars_pack.device != meta.device:
        raise KernelError("chars_pack and meta must share a device")
    if not 0 < TW <= TWp or not 0 < RW <= _RW_MAX:
        raise KernelError(f"unsupported shape TW={TW} TWp={TWp} RW={RW}")
    dev = chars_pack.device
    if dev.type == "cpu":
        return nw_dist_pairs_packed_reference(chars_pack, meta, TW, TWp, RW, NB)
    if dev.type != "cuda":
        raise KernelError(f"nw_dist_pairs_packed: no kernel for device {dev}")
    chars_pack = chars_pack.contiguous()
    meta = meta.contiguous()
    out = torch.empty((2, V, NB), dtype=torch.int32, device=dev)
    if V and NB:
        fn = _build.kernel_fn("dentist_nw_dist_packed", 3, 5)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = fn(chars_pack.data_ptr(), meta.data_ptr(), out.data_ptr(),
                        V, TW, TWp, RW, NB, stream)
        _build.check("dentist_nw_dist_packed", status)
        with _build.launch_lock:
            packed_launches += 1
    return out


def _check_general(templates, t_lens, reads, read_lens, T: int) -> None:
    """The layout of :func:`nw_dist_full` and :func:`banded_nw_dist`."""
    if reads.dtype != torch.uint8 or reads.dim() != 3:
        raise KernelError("reads must be (V, N, RL) uint8")
    V, N, _ = reads.shape
    if templates.dtype != torch.uint8 or templates.shape != (V, T):
        raise KernelError("templates must be (V, T) uint8")
    if t_lens.dtype != torch.int32 or t_lens.shape != (V,):
        raise KernelError("t_lens must be (V,) int32")
    if read_lens.dtype != torch.int32 or read_lens.shape != (V, N):
        raise KernelError("read_lens must be (V, N) int32")
    if len({t.device for t in (templates, t_lens, reads, read_lens)}) != 1:
        raise KernelError("templates, reads and their lengths must share a device")


def _launch_general(name: str, n_int: int, templates, t_lens, reads,
                    read_lens, *ints) -> torch.Tensor:
    """Launch K3f or K3b: (V, N) int32 distances."""
    V, N, _ = reads.shape
    dev = reads.device
    args = [x.contiguous() for x in (templates, t_lens, reads, read_lens)]
    out = torch.empty((V, N), dtype=torch.int32, device=dev)
    fn = _build.kernel_fn(name, 5, n_int)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(a.data_ptr() for a in args), out.data_ptr(), *ints,
                    stream)
    _build.check(name, status)
    return out


def nw_dist_full(templates: torch.Tensor, t_lens: torch.Tensor,
                 reads: torch.Tensor, read_lens: torch.Tensor, T: int,
                 global_ends: bool) -> torch.Tensor:
    """K3f: edit distance of each (template, read) pair over the full
    read width, free-shift or global (``_nw_dist_full``).

    ``templates`` (V, T) uint8, ``t_lens`` (V,) int32, ``reads`` (V, N,
    RL) uint8 with RL ≤ 127, ``read_lens`` (V, N) int32; template v is
    scored against its own N reads.  Returns (V, N) int32 (``INF`` where
    the template is empty)."""
    global full_launches
    _check_general(templates, t_lens, reads, read_lens, T)
    V, N, RL = reads.shape
    if RL > _RW_MAX:
        raise KernelError(f"nw_dist_full: reads of RL={RL} > {_RW_MAX} chars")
    dev = reads.device
    if dev.type == "cpu":
        return nw_dist_full_reference(templates, t_lens, reads, read_lens, T,
                                      global_ends)
    if dev.type != "cuda":
        raise KernelError(f"nw_dist_full: no kernel for device {dev}")
    if not V * N:
        return torch.empty((V, N), dtype=torch.int32, device=dev)
    out = _launch_general("dentist_nw_dist_full", 5, templates, t_lens, reads,
                          read_lens, V, N, T, RL, int(global_ends))
    with _build.launch_lock:
        full_launches += 1
    return out


def banded_nw_dist(templates: torch.Tensor, t_lens: torch.Tensor,
                   reads: torch.Tensor, read_lens: torch.Tensor, T: int,
                   W: int, global_ends: bool) -> torch.Tensor:
    """K3b: edit distance of each (template, read) pair inside a W-cell
    band that follows the diagonal from (0, 0) to (t_len, rl), free-shift
    or global (``_banded_nw_dist``).  Layout as :func:`nw_dist_full`,
    any RL ≥ 1; W ≤ 256."""
    global banded_launches
    _check_general(templates, t_lens, reads, read_lens, T)
    V, N, RL = reads.shape
    if not 0 < W <= _BAND_MAX or RL < 1:
        raise KernelError(f"banded_nw_dist: unsupported W={W} RL={RL}")
    dev = reads.device
    if dev.type == "cpu":
        return banded_nw_dist_reference(templates, t_lens, reads, read_lens, T,
                                        W, global_ends)
    if dev.type != "cuda":
        raise KernelError(f"banded_nw_dist: no kernel for device {dev}")
    if not V * N:
        return torch.empty((V, N), dtype=torch.int32, device=dev)
    out = _launch_general("dentist_banded_nw_dist", 6, templates, t_lens,
                          reads, read_lens, V, N, T, RL, W, int(global_ends))
    with _build.launch_lock:
        banded_launches += 1
    return out


def nw_dist_pairs_packed_reference(chars_pack, meta, TW: int, TWp: int,
                                   RW: int, NB: int):
    """Plain PyTorch version of :func:`nw_dist_pairs_packed`."""
    return nw_dist_pairs_reference(unpack2bit(chars_pack), meta, TW, TWp, RW,
                                   NB)


def nw_dist_pairs_reference(buf, meta, TW: int, TWp: int, RW: int, NB: int):
    """Plain PyTorch version of :func:`nw_dist_pairs`."""
    V = meta.shape[0]
    buf = buf & 3  # the kernel reads 2-bit codes
    win = buf[:, :TW]
    ewin = buf[:, TWp : TWp + TW]
    rwin = buf[:, 2 * TWp :].reshape(V, NB, RW)
    rl = meta[:, 2:]
    tpl2 = torch.cat([win, ewin], dim=0)
    tl2 = torch.cat([meta[:, 0], meta[:, 1]])
    out = nw_dist_full_reference(tpl2, tl2, torch.cat([rwin, rwin], dim=0),
                                 torch.cat([rl, rl], dim=0), TW)
    return out.reshape(2, V, NB)


def nw_dist_full_reference(templates, t_lens, reads, read_lens, T: int,
                           global_ends: bool = True):
    """Edit distance of each (template, read) pair, global or free-shift:
    templates (V, T), reads (V, N, RL); returns (V, N) int32.  A Python
    loop over template rows, vectorized over pairs and read columns.

    A pair whose template is empty ends on no row, so its distance stays
    INF: the loop runs only over pairs with a template, and only up to
    their longest one (rows past a template's end are INF)."""
    live = torch.nonzero(t_lens > 0).flatten()
    out = torch.full(t_lens.shape + reads.shape[1:2], INF, dtype=torch.int32,
                     device=templates.device)
    if len(live):
        T_eff = min(T, int(t_lens[live].max()))
        out[live] = _nw_dist_rows(templates[live], t_lens[live], reads[live],
                                  read_lens[live], T_eff, global_ends)
    return out


def _nw_dist_rows(templates, t_lens, reads, read_lens, T: int,
                  global_ends: bool):
    dev = templates.device
    i64 = torch.int64
    tpl = templates.to(i64)
    rd = reads.to(i64)
    V, N, RL = rd.shape
    tl = t_lens.to(i64)[:, None, None]
    rl = read_lens.to(i64)[..., None]
    j = torch.arange(RL + 1, device=dev, dtype=i64)[None, None, :]
    valid_j = j <= rl
    D = torch.where(valid_j, j if global_ends else 0, INF).expand(V, N, RL + 1)
    best = torch.full((V, N), INF, dtype=i64, device=dev)
    inf = torch.full((V, N, 1), INF, dtype=i64, device=dev)
    for i in range(1, T + 1):
        sub = (rd != tpl[:, i - 1][:, None, None]).to(i64)
        diag = torch.cat([inf, D[..., :-1] + sub], dim=-1)
        up = D + 1
        if not global_ends:  # free leading template gap at j == 0
            up = torch.cat([up[..., :1].clamp(max=0), up[..., 1:]], dim=-1)
        tmp = torch.minimum(diag, up)
        ok = valid_j & (i <= tl)
        tmp = torch.where(ok, tmp, INF)
        closed = torch.cummin(tmp - j, dim=-1).values
        D = torch.where(ok, torch.clamp(torch.minimum(tmp, closed + j), max=INF),
                        INF)
        end = (j == rl) & (i == tl) if global_ends else j == rl
        best = torch.minimum(best, torch.where(end, D, INF).min(dim=-1).values)
        if not global_ends:  # the template's end anywhere in the read
            row = torch.where(i == tl, D, INF).min(dim=-1).values
            best = torch.minimum(best, row)
    return best.to(torch.int32)


def banded_nw_dist_reference(templates, t_lens, reads, read_lens, T: int,
                             W: int, global_ends: bool):
    """Plain PyTorch version of :func:`banded_nw_dist`: a Python loop over
    template rows, vectorized over pairs and band cells."""
    dev = templates.device
    i64 = torch.int64
    V, N, RL = reads.shape
    tpl = templates.to(i64)
    rd = reads.to(i64)
    tl = t_lens.to(i64)[:, None]  # (V, 1)
    rl = read_lens.to(i64)  # (V, N)
    p = torch.arange(W, device=dev, dtype=i64)

    def off_of(i: int):
        c = torch.div(i * rl, tl.clamp(min=1), rounding_mode="floor")
        return torch.minimum((c - W // 2).clamp(min=-W // 2),
                             (rl - W // 2).clamp(min=0))

    def shifted(D, idx):
        ok = (idx >= 0) & (idx < W)
        return torch.where(ok, torch.gather(D, -1, idx.clamp(0, W - 1)), INF)

    off = off_of(0)
    j = off[..., None] + p
    D = torch.where((j >= 0) & (j <= rl[..., None]), j if global_ends else 0,
                    INF)
    best = torch.full((V, N), INF, dtype=i64, device=dev)
    # rows past every template's end are INF
    rows = min(T, int(t_lens.max())) if V * N else 0
    for i in range(1, rows + 1):
        off_i = off_of(i)
        idx = p + (off_i - off)[..., None]
        E, E1 = shifted(D, idx), shifted(D, idx - 1)
        j = off_i[..., None] + p
        r_ch = torch.gather(rd, -1, (j - 1).clamp(0, RL - 1))
        diag = torch.where(j >= 1, E1 + (r_ch != tpl[:, i - 1, None, None]), INF)
        up = E + 1
        if not global_ends:
            up = torch.where(j == 0, up.clamp(max=0), up)
        tmp = torch.minimum(diag, up)
        closed = torch.cummin(tmp - p, dim=-1).values + p
        valid = (j >= 0) & (j <= rl[..., None]) & (i <= tl[..., None])
        D = torch.where(valid, closed.clamp(max=INF), INF)
        end = (j == rl[..., None]) & valid
        if global_ends:
            end &= i == tl[..., None]
        best = torch.minimum(best, torch.where(end, D, INF).min(dim=-1).values)
        if not global_ends:
            row = torch.where(i == tl, D.min(dim=-1).values, INF)
            best = torch.minimum(best, row)
        off = off_i
    return best.to(torch.int32)
