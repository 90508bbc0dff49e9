"""K3, the polish scorer: full-width global NW distances.

Port of ``dentist_tpu/ops/consensus.py:_nw_dist_full`` with
``global_ends=True`` and of its caller's pairing,
``_nw_dist_pair_packed``: each candidate edit's base window and edited
window (≤ TW template chars) are scored against the same NB read
segments (≤ RW chars each), as exact global edit distances.

:func:`nw_dist_pairs` launches ``csrc/nw_dist.cu`` for CUDA tensors and
runs :func:`nw_dist_pairs_reference` for CPU tensors.
:func:`nw_dist_pairs_packed` (K3p) takes the same rows 2-bit packed, as
``_nw_dist_pair_packed`` does; its plain version unpacks and calls
:func:`nw_dist_pairs_reference`.
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import KernelError
from .pack2 import unpack2bit

__all__ = ["nw_dist_pairs", "nw_dist_pairs_reference", "nw_dist_pairs_packed",
           "nw_dist_pairs_packed_reference", "nw_dist_full_reference", "INF"]

INF = 1 << 28
#: the kernel keeps a read and a DP row per thread: reads up to 127 chars
_RW_MAX = 127

#: launches of the K3 kernel on unpacked rows (never of the plain version)
launches = 0
#: launches of the K3 kernel on 2-bit packed rows (K3p)
packed_launches = 0


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


def nw_dist_pairs_packed_reference(chars_pack, meta, TW: int, TWp: int,
                                   RW: int, NB: int):
    """Plain PyTorch version of :func:`nw_dist_pairs_packed`."""
    return nw_dist_pairs_reference(unpack2bit(chars_pack), meta, TW, TWp, RW,
                                   NB)


def nw_dist_pairs_reference(buf, meta, TW: int, TWp: int, RW: int, NB: int):
    """Plain PyTorch version of :func:`nw_dist_pairs`."""
    V = meta.shape[0]
    win = buf[:, :TW]
    ewin = buf[:, TWp : TWp + TW]
    rwin = buf[:, 2 * TWp :].reshape(V, NB, RW)
    rl = meta[:, 2:]
    tpl2 = torch.cat([win, ewin], dim=0)
    tl2 = torch.cat([meta[:, 0], meta[:, 1]])
    out = nw_dist_full_reference(tpl2, tl2, torch.cat([rwin, rwin], dim=0),
                                 torch.cat([rl, rl], dim=0), TW)
    return out.reshape(2, V, NB)


def nw_dist_full_reference(templates, t_lens, reads, read_lens, T: int):
    """Global edit distance of each (template, read) pair: templates
    (V, T), reads (V, N, RL); returns (V, N) int32.  A Python loop over
    template rows, vectorized over pairs and read columns.

    A pair whose template is empty ends on no row, so its distance stays
    INF: the loop runs only over pairs with a template, and only up to
    their longest one (rows past a template's end cannot reach its end
    row)."""
    live = torch.nonzero(t_lens > 0).flatten()
    out = torch.full(t_lens.shape + reads.shape[1:2], INF, dtype=torch.int32,
                     device=templates.device)
    if len(live):
        T_eff = min(T, int(t_lens[live].max()))
        out[live] = _nw_dist_rows(templates[live], t_lens[live], reads[live],
                                  read_lens[live], T_eff)
    return out


def _nw_dist_rows(templates, t_lens, reads, read_lens, T: int):
    dev = templates.device
    i64 = torch.int64
    tpl = templates.to(i64) & 3
    rd = reads.to(i64) & 3
    V, N, RL = rd.shape
    tl = t_lens.to(i64)[:, None, None]
    rl = read_lens.to(i64)[..., None]
    j = torch.arange(RL + 1, device=dev, dtype=i64)[None, None, :]
    valid_j = j <= rl
    D = torch.where(valid_j, j, INF).expand(V, N, RL + 1)
    best = torch.full((V, N), INF, dtype=i64, device=dev)
    inf = torch.full((V, N, 1), INF, dtype=i64, device=dev)
    for i in range(1, T + 1):
        sub = (rd != tpl[:, i - 1][:, None, None]).to(i64)
        diag = torch.cat([inf, D[..., :-1] + sub], dim=-1)
        tmp = torch.minimum(diag, D + 1)
        ok = valid_j & (i <= tl)
        tmp = torch.where(ok, tmp, INF)
        closed = torch.cummin(tmp - j, dim=-1).values
        D = torch.where(ok, torch.clamp(torch.minimum(tmp, closed + j), max=INF),
                        INF)
        at_end = torch.where((j == rl) & (i == tl), D, INF).min(dim=-1).values
        best = torch.minimum(best, at_end)
    return best.to(torch.int32)
