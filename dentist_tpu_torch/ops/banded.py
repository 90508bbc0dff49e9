"""K1, the banded extension DP, and the device sequence store.

Port of ``dentist_tpu/ops/banded.py``.  The kernel (``csrc/extend.cu``)
has two modes, one per dispatch mode of the aligner, and a third that
takes the band schedules as a table:

- :func:`extend` (K1): lanes whose windows lie in the resident
  :class:`DeviceStore`, each described by twelve coordinates
  (``meta12``); the kernel gathers, reverses, complements and masks the
  characters itself.
- :func:`extend_packed` (K1p): windows the host assembled, shipped as
  one 2-bit packed row per lane (:func:`extend_batch_packed`, which also
  splits the lanes over the ranks of a data-parallel group and gathers
  their results).
- :func:`extend_table` (K1t): :func:`extend`'s lanes with each lane's
  band offsets read from an (R + 1, K) table in place of the slopes
  ``num_k`` (:func:`extend_batch_multi`, the port of the JAX package's
  eight-array dispatch ``extend_batch_multi_async``, which nothing on
  the main path calls).

:class:`DeviceStore` uploads its sequences 2-bit packed, one launch of
K5 (:func:`store_write`, ``csrc/store_write.cu``) an upload, which
unpacks them into the store on the device.

:func:`extend_reference` is the plain PyTorch version of the DP: a
Python loop over rows, vectorized over lanes and band cells, on the
offsets :func:`ladder` expands from ``num_k``;
:func:`extend_table_reference` runs the same loop on a table, and
:func:`extend_packed_reference` unpacks and calls it.  The wrappers
take them for CPU tensors only; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from .. import _build
from ..device import get_device
from ..errors import KernelError
from ..parallel.dp import gather_lanes, local_lanes
from ..utils import trace
from .pack2 import pack2bit, unpack2bit

__all__ = ["extend", "extend_reference", "extend_packed",
           "extend_packed_reference", "extend_batch_packed", "extend_table",
           "extend_table_reference", "extend_batch_multi", "ladder",
           "unpack_extension", "bw_for", "DeviceStore", "device_store",
           "reset_device_store", "host_window_meta", "DIFF_PENALTY", "INF",
           "DIAG_UNBOUNDED", "RESIDENT_PAD", "store_write",
           "store_write_reference"]

DIFF_PENALTY = 6  # score = advance - 6*diffs → break-even at ~33% error
INF = 1 << 28
#: diag_lo/diag_hi sentinel: larger than any band coordinate
DIAG_UNBOUNDED = 1 << 20
_NEG = -(1 << 30)
#: above the edit distance of any cell the DP reaches (at most its rows
#: and columns, 32256 + 46000), and below (2^31 - 2^20) / 3072: the plain
#: version's row keys stay inside int32 with it
_D_KEY = 400_000
#: rows per trace sample (``models.alignments.TRACE_SPACING``)
_TRACE = 126
#: the TPU kernel's row-chunk length: window buckets stay multiples of it
_CHUNK = 42

#: launches of the K1 kernel on the device store (never of the plain version)
launches = 0
#: launches of the K1 kernel on 2-bit packed windows (K1p)
packed_launches = 0
#: launches of the K1 kernel with a table of band offsets (K1t)
table_launches = 0
#: launches of K5, the 2-bit store upload
store_write_launches = 0


def bw_for(R: int, W: int) -> int:
    """B-window width for an R-row bucket, rounded to a multiple of 4."""
    bw = int(1.4 * R) + 2 * W + 8
    return -(-bw // 4) * 4


# ======================================================================
# Device sequence store
# ======================================================================

#: zero margin at the store start (and kept free at its end): every
#: window of any bucket fits without start clamping
RESIDENT_PAD = 46464

#: upload length buckets (chars), as the TPU arena allocates them
_RESIDENT_LADDER = [-(-int(65536 * 1.5 ** k) // 4096) * 4096
                    for k in range(40)]
#: chars per upload chunk of the JAX arena; the capacity check counts
#: whole chunks as the arena does (K5 writes an upload in one launch)
_ARENA_CHUNK = 1 << 22


def _store_capacity(device: torch.device) -> int:
    """Store size in bytes: ``DENTIST_TPU_ARENA_MB`` if set, else 2 GiB
    less 16 MiB on a GPU and 128 MiB on the CPU (the JAX arena's sizes,
    so resets and host-window fallbacks happen where they happen there).
    Capped below 2^31: window coordinates are int32."""
    mb = os.environ.get("DENTIST_TPU_ARENA_MB")
    if mb:
        return min(int(mb) << 20, (1 << 31) - (1 << 24))
    return (1 << 31) - (1 << 24) if device.type != "cpu" else 1 << 27


class DeviceStore:
    """Bump-allocated uint8 sequence store on one device.

    Replaces the TPU arena (``dentist_tpu.ops.banded._Arena``): same
    margins, length buckets, ``epoch`` reset when full and
    ``MemoryError`` for a store that cannot fit, so offsets and
    fallbacks follow the JAX run.  Codes upload 2-bit packed on the host
    (each code masked to its two bits) and are unpacked into the store by
    one K5 launch, which writes the upload's own characters (rounded up to
    a multiple of 4).  The arena writes whole chunks of ``_ARENA_CHUNK``
    characters, the last one's zero tail landing in space not yet
    allocated: that space is zero here too (a store starts as zeros and
    uploads go to rising offsets), so the bytes stay equal to the
    arena's.  Offsets, resets and ``MemoryError`` still count whole
    chunks, as the arena does.
    """

    def __init__(self, device: torch.device, capacity: int | None = None):
        self.device = torch.device(device)
        self.capacity = capacity or _store_capacity(self.device)
        self.array: torch.Tensor | None = None
        self.pos = RESIDENT_PAD
        self.keys: dict = {}  # id(codes) -> (offset, keepalive)
        self.epoch = 0
        #: uploads happen from dispatch-pool threads
        self.lock = threading.RLock()

    @classmethod
    def from_seqstore(cls, seqs, device) -> "DeviceStore":
        """A store holding ``seqs.codes`` (a ``SeqStore``) on ``device``;
        ``offset_of(seqs.codes)`` is its base offset."""
        store = cls(device)
        store.offset_of(seqs.codes)
        return store

    def _ensure(self):
        if self.array is None:
            self.array = torch.zeros(self.capacity, dtype=torch.uint8,
                                     device=self.device)

    def reset(self):
        with self.lock:
            self._reset_locked()

    def _reset_locked(self):
        trace.count("store.resets")
        self.pos = RESIDENT_PAD
        self.keys.clear()
        self.epoch += 1
        # a fresh buffer, as the JAX arena does: a dispatch that captured
        # the old one before this reset still reads the contents its
        # offsets point at
        self.array = None
        self._ensure()

    def offset_of(self, codes: np.ndarray, cache: bool = True) -> int:
        """Upload ``codes`` (unless already resident); returns its offset."""
        with self.lock:
            self._ensure()
            key = id(codes)
            if cache:
                hit = self.keys.get(key)
                if hit is not None and hit[1] is codes:
                    return hit[0]
            L = len(codes)
            L4 = -(-max(L, 4) // 4) * 4
            Lb = next(b for b in _RESIDENT_LADDER if L4 <= b)
            Lw = -(-L4 // _ARENA_CHUNK) * _ARENA_CHUNK
            if self.pos + max(Lb, Lw) + RESIDENT_PAD > self.capacity:
                self._reset_locked()
                if self.pos + max(Lb, Lw) + RESIDENT_PAD > self.capacity:
                    raise MemoryError(
                        f"store of {L} chars exceeds the device store "
                        f"({self.capacity >> 20} MiB); raise "
                        f"DENTIST_TPU_ARENA_MB")
            off = self.pos
            host = np.zeros(L4, dtype=np.uint8)
            host[:L] = np.asarray(codes, dtype=np.uint8) & 3
            packed = pack2bit(host.reshape(1, -1))[0]
            store_write(torch.from_numpy(packed).to(self.device), self.array,
                        off)
            self.pos += Lb
            if cache:
                self.keys[key] = (off, codes)
            return off


def store_write(packed: torch.Tensor, store: torch.Tensor, off: int) -> None:
    """K5: unpack the 2-bit packed upload ``packed`` (n/4,) uint8 into
    ``store[off : off + n]`` in place, ``store[off + i] = (packed[i >> 2]
    >> (6 − 2·(i & 3))) & 3``."""
    global store_write_launches
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise KernelError("packed must be a 1-D uint8 tensor")
    if store.dtype != torch.uint8 or store.dim() != 1:
        raise KernelError("store must be a 1-D uint8 tensor")
    if packed.device != store.device:
        raise KernelError("packed and store must share a device")
    n = 4 * packed.numel()
    if off < 0 or off + n > store.numel() or store.numel() >= 1 << 31:
        raise KernelError(f"upload [{off}, {off + n}) outside the store")
    trace.count("k5.upload_bytes", packed.numel())
    if store.device.type == "cpu":
        store_write_reference(packed, store, off)
        return
    if store.device.type != "cuda":
        raise KernelError(f"store_write: no kernel for device {store.device}")
    if not (packed.is_contiguous() and store.is_contiguous()):
        raise KernelError("store_write takes contiguous tensors")
    if n == 0:
        return
    fn = _build.kernel_fn("dentist_store_write", 2, 2)
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream(store.device).cuda_stream
        status = fn(packed.data_ptr(), store.data_ptr(), off, n, stream)
    _build.check("dentist_store_write", status)
    with _build.launch_lock:
        store_write_launches += 1


def store_write_reference(packed: torch.Tensor, store: torch.Tensor,
                          off: int) -> None:
    """Plain PyTorch version of :func:`store_write`."""
    vals = unpack2bit(packed[None, :])[0]
    store[off : off + vals.numel()] = vals


_STORE: DeviceStore | None = None
_STORE_LOCK = threading.Lock()


def device_store() -> DeviceStore:
    """The process-wide store on the chosen device."""
    global _STORE
    dev = get_device()
    with _STORE_LOCK:
        if _STORE is None or _STORE.device != dev:
            _STORE = DeviceStore(dev)
        return _STORE


def reset_device_store(capacity: int | None = None) -> DeviceStore:
    """Replace the process-wide store by an empty one of ``capacity``
    bytes (default: :func:`_store_capacity`) on the chosen device.  A
    store too small for a run's sequences sends every extension flush
    down the host-window path (K1p), as a store that outgrows the card
    does."""
    global _STORE
    with _STORE_LOCK:
        _STORE = DeviceStore(get_device(), capacity)
        return _STORE


# ======================================================================
# K1 wrapper, plain version, decode
# ======================================================================


def host_window_meta(a_len, b_len, lane_k, diag_lo, diag_hi, N: int, R: int,
                     BW: int) -> np.ndarray:
    """``meta12`` for host-assembled windows laid out as one scratch
    buffer: N A windows of R chars, then N B windows of BW chars, already
    oriented and zero-padded (no reversal, no complement, c in [0, BW))."""
    meta = np.zeros((12, N), dtype=np.int32)
    meta[0] = np.arange(N) * R
    meta[2] = a_len
    meta[3] = N * R + np.arange(N) * BW
    meta[7] = BW
    meta[8] = b_len
    meta[9] = lane_k
    meta[10] = diag_lo
    meta[11] = diag_hi
    return meta


def _check_rows(R, W):
    """The row and band-width checks of every mode; returns BW."""
    if R % _CHUNK or R % _TRACE or not 1 <= W <= 1024:
        raise KernelError(f"unsupported shape R={R}, W={W}")
    return bw_for(R, W)


def _check_shape(nk, R, W):
    """The row and schedule checks of K1 and K1p; returns BW."""
    BW = _check_rows(R, W)
    # every band schedule must stay inside the B window (the TPU kernel's
    # window refills would clamp otherwise) and move 0..2 columns per row
    if nk.ndim != 1 or len(nk) == 0:
        raise KernelError("num_k must hold one slope per schedule")
    if (int(nk.min()) < 0 or int(nk.max()) > 2 * R
                    or int(nk.max()) - W // 2 - 1 + 2 * W + 2 * _CHUNK > BW):
        raise KernelError("num_k outside the band schedules' range")
    return BW


def _check_table(offs, R, W):
    """K1t's row and schedule checks; returns BW.  The kernel and JAX's
    ``_extend_scan_v3`` agree on a table whose schedules share row 0
    (JAX starts every lane from ``offs_k[0, 0]``), move 0..2 columns a
    row (the band's shift; JAX selects 2 for any other) and keep every
    row's B window inside [0, BW) (JAX clamps its window slices there):
    the num_k ladders are such tables, and others are refused."""
    BW = _check_rows(R, W)
    if offs.ndim != 2 or offs.shape[0] != R + 1 or offs.shape[1] == 0:
        raise KernelError(f"offs_k must be an (R + 1, K) = ({R + 1}, K) table")
    if (offs[0] != offs[0, 0]).any():
        raise KernelError("offs_k: the schedules must share row 0")
    steps = np.diff(offs, axis=0)
    if int(steps.min()) < 0 or int(steps.max()) > 2:
        raise KernelError("offs_k: a schedule moves 0..2 columns a row")
    if (int(offs[1].min()) - 1 + W < 0
            or int(offs[R].max()) - 1 + 2 * W + 2 * _CHUNK > BW):
        raise KernelError("offs_k outside the B window")
    return BW


def _check_args(store, meta12, R, BW):
    """The store-mode checks of K1 and K1t."""
    if store.dtype != torch.uint8 or store.dim() != 1:
        raise KernelError("store must be a 1-D uint8 tensor")
    if meta12.dtype != torch.int32 or meta12.dim() != 2 or meta12.shape[0] != 12:
        raise KernelError("meta12 must be a (12, N) int32 tensor")
    if store.device != meta12.device:
        raise KernelError("store and meta12 must share a device")
    if not (store.is_contiguous() and meta12.is_contiguous()):
        raise KernelError("extend takes contiguous tensors")
    if store.numel() < max(R, BW) or store.numel() >= 1 << 31:
        raise KernelError("store size out of range")


def ladder(num_k, R: int, W: int) -> np.ndarray:
    """The (R + 1, K) band offsets of the slopes ``num_k``, ``offs[r, k] =
    (r·num_k[k])//R − W/2``, as the aligner's schedules expand."""
    rows = np.arange(R + 1, dtype=np.int64)[:, None]
    return (rows * _host_ints(num_k)[None, :]) // R - W // 2


def _host_ints(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int64)


def extend(store: torch.Tensor, meta12: torch.Tensor, num_k,
           R: int, W: int = 256) -> torch.Tensor:
    """Run the extension DP for N lanes; returns the (4 + R/126, N) int32
    block (rows best_r, best_j, best_d, best_s, then the packed
    ``jm << 15 | dm`` trace samples at rows 126, 252, ...).

    ``meta12`` (12, N) int32 rows: a_start, a_rev, a_len, b_start, b_rev,
    b_flip, c_lo, c_hi, b_len, lane_k, diag_lo, diag_hi — starts index
    ``store``; ``num_k`` (K,) host ints are the band schedules' slopes
    as ``offs[r] = (r·num_k)//R − W/2``.
    """
    global launches
    nk = _host_ints(num_k)
    BW = _check_shape(nk, R, W)
    _check_args(store, meta12, R, BW)
    if store.device.type == "cpu":
        return extend_reference(store, meta12, nk, R, W)
    if store.device.type != "cuda":
        raise KernelError(f"extend: no kernel for device {store.device}")
    N = meta12.shape[1]
    out = torch.empty((4 + R // _TRACE, N), dtype=torch.int32,
                      device=store.device)
    if N == 0:
        return out
    num_dev = torch.from_numpy(nk.astype(np.int32)).to(store.device)
    fn = _build.kernel_fn("dentist_extend", 4, 5)
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream(store.device).cuda_stream
        status = fn(store.data_ptr(), meta12.data_ptr(), num_dev.data_ptr(),
                    out.data_ptr(), store.numel(), N, R, W, BW, stream)
    _build.check("dentist_extend", status)
    with _build.launch_lock:
        launches += 1
    return out


def _check_packed(chars_pack, meta5, nk, R, W):
    if chars_pack.dtype != torch.uint8 or chars_pack.dim() != 2:
        raise KernelError("chars_pack must be a 2-D uint8 tensor")
    if meta5.dtype != torch.int32 or meta5.dim() != 2 or meta5.shape[0] != 5:
        raise KernelError("meta5 must be a (5, N) int32 tensor")
    if chars_pack.device != meta5.device:
        raise KernelError("chars_pack and meta5 must share a device")
    N = meta5.shape[1]
    BW = _check_shape(nk, R, W)
    if tuple(chars_pack.shape) != (N, (R + BW) // 4):
        raise KernelError(f"chars_pack must be (N, (R + BW)/4) = "
                          f"({N}, {(R + BW) // 4})")
    return BW


def extend_packed(chars_pack: torch.Tensor, meta5: torch.Tensor, num_k,
                  R: int, W: int = 256) -> torch.Tensor:
    """K1p: the extension DP on host-assembled windows, 2-bit packed.

    ``chars_pack`` (N, R/4 + BW/4) uint8 rows = [A window | B window]
    (:func:`~.pack2.pack2bit` of the oriented, zero-padded windows);
    ``meta5`` (5, N) int32 rows b_len, lane_k, a_len, diag_lo, diag_hi;
    ``num_k`` as in :func:`extend`.  Returns the same (4 + R/126, N)
    block."""
    global packed_launches
    nk = _host_ints(num_k)
    BW = _check_packed(chars_pack, meta5, nk, R, W)
    dev = chars_pack.device
    if dev.type == "cpu":
        return extend_packed_reference(chars_pack, meta5, nk, R, W)
    if dev.type != "cuda":
        raise KernelError(f"extend_packed: no kernel for device {dev}")
    if not (chars_pack.is_contiguous() and meta5.is_contiguous()):
        raise KernelError("extend_packed takes contiguous tensors")
    N = meta5.shape[1]
    if N * chars_pack.shape[1] >= 1 << 31:
        raise KernelError("chars_pack size out of range")
    out = torch.empty((4 + R // _TRACE, N), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    num_dev = torch.from_numpy(nk.astype(np.int32)).to(dev)
    fn = _build.kernel_fn("dentist_extend_packed", 4, 4)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(chars_pack.data_ptr(), meta5.data_ptr(), num_dev.data_ptr(),
                    out.data_ptr(), N, R, W, BW, stream)
    _build.check("dentist_extend_packed", status)
    with _build.launch_lock:
        packed_launches += 1
    return out


def extend_packed_reference(chars_pack: torch.Tensor, meta5: torch.Tensor,
                            num_k, R: int, W: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`extend_packed`: unpack, lay the
    windows out as a host-window scratch buffer, run
    :func:`extend_reference`."""
    N = meta5.shape[1]
    BW = bw_for(R, W)
    chars = unpack2bit(chars_pack)
    scratch = torch.cat([chars[:, :R].reshape(-1), chars[:, R:].reshape(-1)])
    m5 = meta5.cpu().numpy()
    meta12 = host_window_meta(m5[2], m5[0], m5[1], m5[3], m5[4], N, R, BW)
    return extend_reference(scratch, torch.from_numpy(meta12).to(chars.device),
                            num_k, R, W)


def extend_batch_packed(a_win: np.ndarray, b_win: np.ndarray, a_len, b_len,
                        num_k, lane_k, W: int = 256, diag_lo=None,
                        diag_hi=None, group=None) -> torch.Tensor:
    """Host-window dispatch (port of ``extend_batch_packed_async``):
    packs the (N, R) A and (N, ``bw_for(R, W)``) B windows and launches
    K1p on the chosen device.  With a data-parallel ``group`` each rank
    packs and runs only its contiguous block of lanes (N must be a
    multiple of the group size) and the blocks are gathered along the
    lane axis (port of ``sharded_extend_v3_packed``), so every rank
    returns the whole block, equal to the single-device result."""
    N, R = a_win.shape
    if diag_lo is None:
        diag_lo = np.full(N, -DIAG_UNBOUNDED, dtype=np.int32)
    if diag_hi is None:
        diag_hi = np.full(N, DIAG_UNBOUNDED, dtype=np.int32)
    meta5 = np.stack([np.asarray(x, dtype=np.int32) for x in
                      (b_len, lane_k, a_len, diag_lo, diag_hi)])
    a_win = local_lanes(a_win, group, 0)
    b_win = local_lanes(b_win, group, 0)
    meta5 = np.ascontiguousarray(local_lanes(meta5, group, 1))
    chars = np.concatenate([pack2bit(a_win), pack2bit(b_win)], axis=1)
    trace.count("k1p.window_bytes", chars.nbytes)
    dev = get_device()
    out = extend_packed(torch.from_numpy(chars).to(dev),
                        torch.from_numpy(meta5).to(dev), num_k, R=R, W=W)
    return gather_lanes(out, group, 1)


def extend_table(store: torch.Tensor, meta12: torch.Tensor, offs_k,
                 R: int, W: int = 256) -> torch.Tensor:
    """K1t: :func:`extend` with lane n's band offsets read from column
    ``lane_k[n]`` (``meta12`` row 9) of ``offs_k``, an (R + 1, K) table of
    host ints, in place of the slopes' formula.  The schedules must share
    row 0, move 0..2 columns a row and keep the B window inside [0, BW)
    (:func:`_check_table`; any num_k ladder does).  Returns the same
    (4 + R/126, N) block."""
    global table_launches
    offs = _host_ints(offs_k)
    BW = _check_table(offs, R, W)
    _check_args(store, meta12, R, BW)
    if store.device.type == "cpu":
        return extend_table_reference(store, meta12, offs, R, W)
    if store.device.type != "cuda":
        raise KernelError(f"extend_table: no kernel for device {store.device}")
    N, K = meta12.shape[1], offs.shape[1]
    out = torch.empty((4 + R // _TRACE, N), dtype=torch.int32,
                      device=store.device)
    if N == 0:
        return out
    tab = torch.from_numpy(offs.astype(np.int32)).to(store.device)
    fn = _build.kernel_fn("dentist_extend_table", 4, 6)
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream(store.device).cuda_stream
        status = fn(store.data_ptr(), meta12.data_ptr(), tab.data_ptr(),
                    out.data_ptr(), store.numel(), N, R, W, BW, K, stream)
    _build.check("dentist_extend_table", status)
    with _build.launch_lock:
        table_launches += 1
    return out


def extend_batch_multi(a_win: np.ndarray, b_win: np.ndarray, a_len, b_len,
                       offs_k, lane_k, W: int = 256, group=None, diag_lo=None,
                       diag_hi=None) -> torch.Tensor:
    """The eight-array dispatch (port of ``extend_batch_multi_async``):
    the (N, R) A and (N, ``bw_for(R, W)``) B windows of uint8 codes, each
    lane's lengths and optional diagonal bounds, and its schedule
    ``lane_k`` in ``offs_k``, an (R + 1, K) table of band offsets
    (:func:`extend_table`), laid out as one host-window store and run by
    K1t on the chosen device.  With a data-parallel ``group`` each rank
    runs its contiguous block of lanes (N must be a multiple of the group
    size) and the blocks are gathered along the lane axis (port of
    ``sharded_extend_v3``), so every rank returns the whole (4 + R/126, N)
    block, equal to the single-device result; read it with
    :func:`unpack_extension`."""
    N, R = a_win.shape
    if diag_lo is None:
        diag_lo = np.full(N, -DIAG_UNBOUNDED, dtype=np.int32)
    if diag_hi is None:
        diag_hi = np.full(N, DIAG_UNBOUNDED, dtype=np.int32)
    if b_win.shape != (N, bw_for(R, W)):
        raise KernelError(f"b_win must be (N, bw_for(R, W)) = ({N}, "
                          f"{bw_for(R, W)})")
    offs = _host_ints(offs_k)
    lane_k = np.asarray(lane_k, dtype=np.int32)
    if offs.ndim != 2 or ((lane_k < 0) | (lane_k >= offs.shape[-1])).any():
        raise KernelError("lane_k must pick a column of offs_k")
    lanes = [np.asarray(x, dtype=np.int32)
             for x in (a_len, b_len, lane_k, diag_lo, diag_hi)]
    a_win, b_win, *lanes = (local_lanes(x, group, 0)
                            for x in (a_win, b_win, *lanes))
    n, BW = len(a_win), b_win.shape[1]
    scratch = np.concatenate([np.asarray(a_win, np.uint8).reshape(-1),
                              np.asarray(b_win, np.uint8).reshape(-1)])
    meta = host_window_meta(*lanes, n, R, BW)
    dev = get_device()
    out = extend_table(torch.from_numpy(scratch).to(dev),
                       torch.from_numpy(meta).to(dev), offs, R=R, W=W)
    return gather_lanes(out, group, 1)


def _windows(store, start, size, rev):
    """(N, size) windows of ``store`` at clamped ``start``, reversed per
    lane where ``rev``."""
    L = store.numel()
    s = start.to(torch.int64).clamp(max=L - size).clamp(min=0)
    idx = s[:, None] + torch.arange(size, device=store.device)[None, :]
    rows = store[idx]
    return torch.where(rev[:, None] == 1, rows.flip(1), rows)


def extend_reference(store: torch.Tensor, meta12: torch.Tensor, num_k,
                     R: int, W: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`extend` (same arguments, same
    result, bit for bit)."""
    return extend_table_reference(store, meta12, ladder(num_k, R, W), R, W)


def extend_table_reference(store: torch.Tensor, meta12: torch.Tensor, offs_k,
                           R: int, W: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`extend_table` (and, on the
    :func:`ladder` of ``num_k``, of :func:`extend`).

    Rows past a lane's ``a_len`` cannot change its result, so the row
    loop stops at the longest live lane and the remaining trace samples
    repeat the final ones; lanes with no A row output the empty result
    without running."""
    dev = store.device
    m = meta12.to(torch.int64)
    N = m.shape[1]
    out = torch.zeros((4 + R // _TRACE, N), dtype=torch.int32, device=dev)
    out[3] = -INF
    live = torch.nonzero(m[2] > 0).flatten()
    if len(live):
        R_eff = min(R, int(m[2, live].max()))
        out[:, live] = _extend_lanes(store, m[:, live], _host_ints(offs_k), R,
                                     R_eff, W)
    return out


def _extend_lanes(store, m, offs, R: int, R_eff: int, W: int) -> torch.Tensor:
    """The DP's rows for the lanes of ``m``, in int32 as JAX computes
    them (every value a valid cell holds fits).  Each row keeps only its
    best cell's packed key; the running maxima jm and dm, the best row
    and the trace samples are taken from those keys after the last row,
    as the row-by-row updates would leave them.  A lane whose rows have
    all run (``a_len``) leaves the loop at the next trace sample."""
    dev = store.device
    BW = bw_for(R, W)
    (a_start, a_rev, a_len, b_start, b_rev, b_flip, c_lo, c_hi, b_len,
     lane_k, diag_lo, diag_hi) = m
    N = m.shape[1]
    i32, i64 = torch.int32, torch.int64
    a_win = _windows(store, a_start, R, a_rev)
    a_win = torch.where(torch.arange(R, device=dev)[None, :] < a_len[:, None],
                        a_win, 0)
    b_rows = _windows(store, b_start, BW, b_rev)
    b_rows = torch.where(b_flip[:, None] == 1, 3 - b_rows, b_rows)  # u8 wrap
    c = torch.arange(BW, device=dev)[None, :]
    b_win = torch.where((c >= c_lo[:, None]) & (c < c_hi[:, None]), b_rows, 0)

    # per row and lane, before the loop: the offset, the band's shift,
    # the first cell with j >= 1, the valid cells [lo, hi] (0 <= j <=
    # b_len, diag_lo <= j - r <= diag_hi, clamped where no p can reach)
    # and the B column of cell 0
    off = torch.as_tensor(offs, device=dev)[: R_eff + 1, lane_k]  # (R_eff+1, N)
    r_col = torch.arange(R_eff + 1, device=dev)[:, None]
    wide = 1 << 30
    lo = torch.maximum(-off, diag_lo + r_col - off).clamp(-wide, wide).to(i32)
    hi = torch.minimum(b_len - off, diag_hi + r_col - off).clamp(-wide, wide).to(i32)
    shift = torch.diff(off, dim=0, prepend=off[:1])
    j1 = (1 - off).clamp(-wide, wide).to(i32)
    b_col = off + (W - 1)

    p = torch.arange(W, device=dev, dtype=i32)[None, :]
    p1 = torch.arange(W + 1, device=dev)[None, :]
    p64 = p1[:, :W]
    # the packed row key ((p - 6D) << 9) + (W-1-p), as 511p + (W-1) - 3072D
    key_p = 511 * p + (W - 1)
    j0 = off[0][:, None] + p64
    ok0 = ((j0 >= 0) & (j0 <= b_len[:, None]) & (j0 >= diag_lo[:, None])
           & (j0 <= diag_hi[:, None]))
    D = torch.where(ok0, j0.to(i32), INF)
    inf = torch.full((N, 1), INF, dtype=i32, device=dev)
    keys = torch.full((R_eff, N), _NEG, dtype=i32, device=dev)
    lanes = torch.arange(N, device=dev)  # each state row's lane
    left = a_len  # the lanes' row counts, as the state rows hold them
    for r in range(1, R_eff + 1):
        padded = torch.cat([inf, D, inf, inf], dim=1)  # index q+1 ↔ D[q]
        e = padded.gather(1, p1 + shift[r][:, None])  # e[q] = padded[q + s]
        b_ch = b_win.gather(1, b_col[r][:, None] + p64)
        diag = e[:, :W] + (a_win[:, r - 1 : r] != b_ch)
        diag = torch.where(p >= j1[r][:, None], diag, INF)
        # cells before the valid ones are INF; those after them feed no
        # valid cell through the closure min_{q<=p} tmp[q] + (p - q),
        # which is never above tmp itself, and are set INF after it
        tmp = torch.where(p >= lo[r][:, None], torch.minimum(diag, e[:, 1:] + 1),
                          INF)
        closed = torch.cummin(tmp - p, dim=1).values + p
        D = torch.where(p <= hi[r][:, None], torch.clamp(closed, max=INF), INF)
        # a valid cell's D is below _D_KEY: its key is above _NEG, an
        # unreachable cell's (D = INF, taken as _D_KEY) below it
        key = key_p - 3072 * torch.clamp(D, max=_D_KEY)
        keys[r - 1, lanes] = key.max(dim=1).values.clamp(min=_NEG)
        if r % _TRACE == 0 and (left <= r).any():  # lanes whose rows have all run
            keep = left > r
            lanes, left, D, a_win, b_win, inf = (
                x[keep] for x in (lanes, left, D, a_win, b_win, inf))
            lo, hi, shift, j1, b_col = (x[:, keep] for x in (lo, hi, shift, j1,
                                                             b_col))
            if not len(lanes):
                break

    # the row winners, as the row-by-row updates take them: rows past a
    # lane's a_len have none; jm and dm are running maxima from 0; the
    # best row is the first of the highest score
    rows = r_col[1:].to(i32)
    keys = torch.where(rows <= a_len[None, :], keys, _NEG)
    ok = keys != _NEG
    row_m = keys >> 9
    row_p = (W - 1) - (keys & (2 * W - 1))
    off = off[1:].to(i32)
    low = torch.iinfo(i32).min
    jm = torch.cummax(torch.where(ok, off + row_p, low), dim=0).values.clamp(min=0)
    dm = torch.cummax(torch.where(ok, (row_p - row_m) // DIFF_PENALTY, low),
                      dim=0).values.clamp(min=0)
    row_s = torch.where(ok, rows + off + row_m, -INF)
    best_s = row_s.max(dim=0).values
    best_i = torch.where(row_s == best_s, rows - 1, R_eff).min(dim=0).values.long()
    found = best_s > -INF
    col = torch.arange(N, device=dev)
    jd = (jm << 15) | torch.clamp(dm, max=(1 << 15) - 1)
    out = torch.zeros((4 + R // _TRACE, N), dtype=i32, device=dev)
    out[0] = torch.where(found, best_i.to(i32) + 1, 0)
    out[1] = torch.where(found, jm[best_i, col], 0)
    out[2] = torch.where(found, dm[best_i, col], 0)
    out[3] = best_s
    n_trace = R_eff // _TRACE
    out[4 : 4 + n_trace] = jd[_TRACE - 1 : n_trace * _TRACE : _TRACE]
    out[4 + n_trace :] = jd[-1]
    return out


def unpack_extension(packed: torch.Tensor) -> tuple:
    """Fetch + split an extension result block.

    Returns ``(best_r, best_j, best_d, best_s, trace_j, trace_d)`` numpy
    arrays; trace rows sample DP rows 126, 252, … (trace_d saturates at
    2^15−1)."""
    arr = packed.cpu().numpy()
    jd = arr[4:]
    return (arr[0], arr[1], arr[2], arr[3], jd >> 15, jd & ((1 << 15) - 1))
