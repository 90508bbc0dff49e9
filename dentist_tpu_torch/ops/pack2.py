"""2-bit packed base codes: the host packer and the plain unpacker.

Four codes per byte, the first in the high bits (the Dazzler
``Compress_Read`` byte order), so character ``i`` of a packed row ``p``
is ``(p[i >> 2] >> (6 − 2·(i & 3))) & 3``.  The kernels read their packed
inputs through the same formula (``csrc/pack2.cuh``).

:func:`pack2bit` gives the bytes of ``dentist_tpu.ops.banded._pack2bit``
for every input, codes above 3 included: it uses the same native
word-wise packer (``native/``, loaded by the port's copy of the JAX
package's ``native`` module) when the library loads (it keeps the low
two bits of each code), and the same numpy shift-or when it does not
(which keeps all bits, so a code above 3 spills into its neighbours).  :func:`unpack2bit` is the plain PyTorch inverse, JAX's
``_unpack2bit``.

``seconds`` and ``calls`` count the host time :func:`pack2bit` takes
(all threads), so a run can report what the packed transport costs.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

__all__ = ["pack2bit", "unpack2bit"]

#: host seconds spent in :func:`pack2bit`, and its calls
seconds = 0.0
calls = 0
_count_lock = threading.Lock()


def pack2bit(a: np.ndarray) -> np.ndarray:
    """(N, X) codes → (N, X/4) uint8 rows (X must be a multiple of 4)."""
    global seconds, calls
    if a.shape[1] % 4:
        raise ValueError(f"row length {a.shape[1]} is not a multiple of 4")
    t0 = time.perf_counter()
    out = _pack(a)
    with _count_lock:
        seconds += time.perf_counter() - t0
        calls += 1
    return out


def _pack(a: np.ndarray) -> np.ndarray:
    from ..native import _load

    lib = _load()
    if lib is not None:
        flat = np.ascontiguousarray(a, dtype=np.uint8).reshape(-1)
        out = np.empty(flat.size // 4, dtype=np.uint8)
        lib.dentist_pack_2bit(flat.ctypes.data_as(ctypes.c_char_p), flat.size,
                              out.ctypes.data_as(ctypes.c_char_p))
        return out.reshape(a.shape[0], -1)
    q = np.ascontiguousarray(a, dtype=np.uint8).reshape(a.shape[0], -1, 4)
    out = q[:, :, 0] << 6
    out |= q[:, :, 1] << 4
    out |= q[:, :, 2] << 2
    out |= q[:, :, 3]
    return out


def unpack2bit(p: torch.Tensor) -> torch.Tensor:
    """(N, X/4) packed uint8 rows → (N, X) uint8 codes on ``p``'s device."""
    sh = torch.tensor([6, 4, 2, 0], dtype=torch.uint8, device=p.device)
    return ((p[:, :, None] >> sh) & 3).reshape(p.shape[0], -1)
