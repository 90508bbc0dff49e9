"""Errors raised by the port's device layer.

Importing this module imports nothing of PyTorch, so that the kernel
build command (``python -m dentist_tpu_torch._build``), which raises
:class:`KernelError`, runs where only the CUDA toolkit is installed, as
in an image's builder stage.  :data:`DEVICE_ERRORS` names PyTorch's
classes and imports it on first use.
"""

from __future__ import annotations

__all__ = ["KernelError", "DEVICE_ERRORS"]


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, was refused at launch, or
    faulted while running.  Never contained: a kernel fault must stop the
    run, not turn into a skipped pile-up."""


def __getattr__(name: str):
    #: ``DEVICE_ERRORS``: exception classes that per-pile-up containment
    #: handlers re-raise: a kernel error (build, argument check or launch
    #: status), the card running out of memory, and a CUDA error that
    #: PyTorch reports when a later call synchronizes with a faulted
    #: kernel.  Other ``RuntimeError``s are host errors and are contained
    #: as the JAX package contains them.
    if name == "DEVICE_ERRORS":
        import torch

        value = (KernelError, torch.cuda.OutOfMemoryError, torch.AcceleratorError)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
