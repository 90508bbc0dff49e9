"""Data-parallel execution over ``torch.distributed`` ranks.

Port of ``dentist_tpu/parallel/dp.py``.  The scaling model is the JAX
package's (SURVEY §2.4): every rank runs the same deterministic host
pipeline on the same inputs, so every dispatch has the same lanes on
every rank; the lanes of a dispatch (independent candidate alignments,
consensus lanes, polish candidates) split into one contiguous block per
rank (JAX's ``P("dp")``), each rank runs the kernel on its block, and
the blocks are gathered along the lane axis so that every rank holds
the whole result (JAX's ``all_gather(..., tiled=True)``, the
reference's file-level ``LAmerge`` / ``merge-insertions``).  Per-lane
math is the single-device kernel's, so the gathered result equals the
single-device result.

One process per device.  :func:`init_distributed` joins the group that
``DENTIST_TPU_COORDINATOR`` (host:port of rank 0), ``DENTIST_TPU_NUM_PROCESSES``
and ``DENTIST_TPU_PROCESS_ID`` describe, with NCCL when the ranks' tensors
live on CUDA devices (each rank its own card) and gloo for CPU ranks.
The gather follows the group's backend: NCCL gathers on the device;
gloo has no ``all_gather`` of CUDA tensors, so it gathers the host copy
that the result decoders fetch anyway.  A failed collective raises.

Nothing here runs at import time.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import get_device, require_cuda
from ..utils.log import log_json

__all__ = ["DPGroup", "init_distributed", "default_group", "rank_device",
           "dispatch_workers", "pad_lanes", "local_lanes", "gather_lanes",
           "barrier"]

#: collective timeout: a rank that stalls in host code (a slow first
#: kernel build on another rank) must not abort its peers
_TIMEOUT = timedelta(minutes=30)


@dataclass(frozen=True)
class DPGroup:
    """The ranks of the default ``torch.distributed`` group, over which
    a dispatch's lanes split: this process is block ``rank`` of
    ``size``; ``backend`` is the group's (``nccl`` or ``gloo``)."""

    rank: int
    size: int
    backend: str

    @classmethod
    def world(cls) -> "DPGroup":
        """The default process group of this process."""
        return cls(dist.get_rank(), dist.get_world_size(), dist.get_backend())


def init_distributed(backend: str | None = None) -> bool:
    """Join the process group the environment describes; returns True
    when this process is in one.

    ``DENTIST_TPU_COORDINATOR`` (host:port, rank 0's rendezvous),
    ``DENTIST_TPU_NUM_PROCESSES`` and ``DENTIST_TPU_PROCESS_ID`` — the
    variables ``dentist_tpu.parallel.dp.init_distributed`` reads.
    ``backend`` defaults to NCCL when the chosen device
    (:func:`dentist_tpu_torch.device.get_device`) is a CUDA card and to
    gloo on the CPU; two ranks that share one card need ``"gloo"``
    (NCCL refuses them)."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("DENTIST_TPU_COORDINATOR")
    if not coord:
        return False
    n = os.environ.get("DENTIST_TPU_NUM_PROCESSES")
    pid = os.environ.get("DENTIST_TPU_PROCESS_ID")
    if not n or pid is None:
        raise ValueError("DENTIST_TPU_COORDINATOR needs DENTIST_TPU_NUM_PROCESSES "
                         "and DENTIST_TPU_PROCESS_ID")
    if backend is None:
        backend = "nccl" if get_device().type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, init_method=f"tcp://{coord}",
                            world_size=int(n), rank=int(pid), timeout=_TIMEOUT)
    log_json("info", event="distributedInit", coordinator=coord,
             processes=dist.get_world_size(), processIndex=dist.get_rank(),
             backend=backend, device=str(get_device()))
    return True


def default_group() -> DPGroup | None:
    """The group the pipeline shards over: every rank of the process
    group the environment describes (joined here if needed), or None
    for a single process.  ``DENTIST_TPU_FORCE_SINGLE=1`` forces the
    single-device path, as ``default_mesh`` does."""
    if os.environ.get("DENTIST_TPU_FORCE_SINGLE"):
        return None
    if not init_distributed():
        return None
    group = DPGroup.world()
    return group if group.size > 1 else None


def rank_device() -> torch.device:
    """The card of this process: rank ``DENTIST_TPU_PROCESS_ID`` takes
    card ``rank mod (cards on this host)`` — one process per card, ranks
    numbered host by host; card 0 outside a group."""
    require_cuda()
    rank = (int(os.environ.get("DENTIST_TPU_PROCESS_ID", "0"))
            if os.environ.get("DENTIST_TPU_COORDINATOR") else 0)
    return torch.device("cuda", rank % torch.cuda.device_count())


def dispatch_workers(default: int) -> int:
    """Thread count for pools that launch kernels: 1 in a group of more
    than one rank, where every rank must run its gathers in the same
    order (``dentist_tpu/parallel/dp.py:35-44``); ``default`` otherwise,
    to overlap host staging with device work."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return 1
    return default


def pad_lanes(n: int, group: DPGroup | None) -> int:
    """``n`` rounded up to a multiple of the group size."""
    if group is None:
        return n
    return -(-n // group.size) * group.size


def local_lanes(x, group: DPGroup | None, axis: int):
    """This rank's contiguous block of ``x`` (numpy array or tensor)
    along the lane ``axis``; all of ``x`` without a group.  The lane
    count must be a multiple of the group size (:func:`pad_lanes`)."""
    if group is None:
        return x
    n = x.shape[axis]
    if n % group.size:
        raise ValueError(f"{n} lanes do not split over {group.size} ranks")
    blk = n // group.size
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(group.rank * blk, (group.rank + 1) * blk)
    return x[tuple(idx)]


def gather_lanes(t: torch.Tensor, group: DPGroup | None,
                 axis: int) -> torch.Tensor:
    """Every rank's block of ``t``, concatenated along ``axis`` in rank
    order (JAX's tiled ``all_gather``).  NCCL gathers on the device;
    gloo gathers the host copy and returns a CPU tensor.  Returns ``t``
    without a group."""
    if group is None:
        return t
    x = t.movedim(axis, 0)
    is_bool = x.dtype == torch.bool
    if is_bool:  # bool travels as bytes
        x = x.to(torch.uint8)
    if group.backend == "nccl":
        x = x.contiguous()
        out = torch.empty((group.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
    elif group.backend == "gloo":
        x = x.cpu().contiguous()
        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x)
        out = torch.cat(parts)
    else:
        raise ValueError(f"no lane gather for backend {group.backend}")
    if is_bool:
        out = out.to(torch.bool)
    return out.movedim(0, axis).contiguous()


def barrier(group: DPGroup | None) -> None:
    """Wait for every rank of ``group`` (no-op without one)."""
    if group is None:
        return
    if group.backend == "nccl":
        dist.barrier(device_ids=[get_device().index])
    else:
        dist.barrier()
