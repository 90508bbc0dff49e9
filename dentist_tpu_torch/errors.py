"""Errors raised by the port's device layer."""

from __future__ import annotations

import torch

__all__ = ["KernelError", "DEVICE_ERRORS"]


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, was refused at launch, or
    faulted while running.  Never contained: a kernel fault must stop the
    run, not turn into a skipped pile-up."""


#: exception classes that per-pile-up containment handlers re-raise: a
#: kernel error (build, argument check or launch status), the card
#: running out of memory, and a CUDA error that PyTorch reports when a
#: later call synchronizes with a faulted kernel.  Other ``RuntimeError``s
#: are host errors and are contained as the JAX package contains them.
DEVICE_ERRORS = (KernelError, torch.cuda.OutOfMemoryError, torch.AcceleratorError)
