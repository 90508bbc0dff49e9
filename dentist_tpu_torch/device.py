"""The one device the port runs on, chosen by the caller.

Nothing picks a device implicitly: the entry point (``cli.main`` for
its device sub-commands, ``chip_smoke.py``, a test) calls
:func:`set_device`, and every module
that allocates on the device asks :func:`get_device`.  A run asked for
``cuda`` on a machine without a GPU fails in :func:`require_cuda`
instead of quietly running the plain CPU versions of the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["set_device", "get_device", "require_cuda", "card_line",
           "device_busy"]

_DEVICE: torch.device | None = None


def require_cuda() -> torch.device:
    """The first CUDA device; raises when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: dentist_tpu_torch needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def set_device(device) -> torch.device:
    """Choose the device every later allocation goes to; ``"cuda"``
    requires a GPU.  Returns the chosen ``torch.device``."""
    global _DEVICE
    dev = torch.device(device)
    if dev.type == "cuda":
        first = require_cuda()
        dev = first if dev.index is None else dev
        torch.cuda.set_device(dev)  # NCCL collectives run on this card
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    _DEVICE = dev
    return dev


def get_device() -> torch.device:
    if _DEVICE is None:
        raise RuntimeError("no device chosen: call "
                           "dentist_tpu_torch.device.set_device first")
    return _DEVICE


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (its first card)."""
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def device_busy(prof) -> tuple[float, dict]:
    """The card's busy milliseconds in a ``torch.profiler`` run (the union
    of the intervals of its kernels and copies) and the milliseconds and
    count of each by name."""
    spans = [(e.time_range.start / 1e3, e.time_range.end / 1e3, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += b - a
        row[1] += 1
    return busy, dict(sorted(by_name.items(), key=lambda kv: -kv[1][0]))
