"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/*.cu`` have plain C entry points (no PyTorch
headers), so one ``nvcc`` call builds them in seconds into one shared
library under ``_build/``, named by a hash of the sources and flags: a
changed source builds anew, an unchanged one loads the existing file.
The library is loaded with ``ctypes``; every entry point takes device
pointers, ints and the CUDA stream, and returns ``cudaGetLastError()``.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .errors import KernelError

__all__ = ["library", "kernel_fn", "check", "launch_lock", "build_seconds",
           "build_log"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "csrc"
_OUT = _HERE / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
#: guards the wrappers' launch counters: dispatch pools launch from
#: several threads, and ``launches += 1`` is a read-modify-write
launch_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict[str, object] = {}
#: wall seconds the last build took (0.0 when the library was cached)
build_seconds = 0.0
#: nvcc's output of the last build: ptxas's registers, shared memory and
#: spills of each kernel
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelError("nvcc not found: the CUDA toolkit is needed to build "
                      "the kernels")


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_SRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(_FLAGS).encode())
        for s in sources:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        so = _OUT / f"libdentist_kernels_{h.hexdigest()[:16]}.so"
        if not so.exists():
            _OUT.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, sources)],
                capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                                  f"{build_log}")
            os.replace(tmp, so)
        _lib = ctypes.CDLL(str(so))
        return _lib


def kernel_fn(name: str, n_ptr: int, n_int: int):
    """The C entry point ``name`` taking ``n_ptr`` pointers, then
    ``n_int`` ints, then the stream; returns ``cudaGetLastError()``."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(name: str, status: int) -> None:
    if status != 0:
        raise KernelError(f"{name}: CUDA error {status} at launch")
