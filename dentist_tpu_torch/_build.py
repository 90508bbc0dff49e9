"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/*.cu`` have plain C entry points (no PyTorch
headers), so they build in seconds: one ``nvcc -c`` per source, all
started together, then one link into a shared library under ``_build/``,
named by a hash of the sources, their headers (``csrc/*.cuh``) and the
flags: a changed source builds anew, an unchanged one loads the existing
file.  Ranks of a process group that
reach their first launch together build once: the build runs under an
exclusive lock on a file beside the library, into a temporary file that
is renamed into place, and a rank that waited on the lock loads what
the first one built.  The library is loaded with ``ctypes``; every entry
point takes device pointers, ints and the CUDA stream, and returns
``cudaGetLastError()``.

Nothing here runs at import time: the first kernel launch builds.

Where the library lives: :func:`library_path`, ``_build/`` in the
package's own directory, in a checkout and in an install alike.  A wheel
of the port carries the sources (``csrc/*.cu``, ``csrc/*.cuh``) as
package data and nothing of ``_build/``.  The images and the conda
package of ``packaging/torch/`` build the library when they are built,
with :data:`BUILD_COMMAND` (``python -m dentist_tpu_torch._build``: it
compiles and links only, needs ``nvcc`` and no GPU, and imports nothing
of PyTorch), into the installed package's ``_build/``, so that the first
launch loads it and builds nothing (``build_seconds`` stays 0.0).  An
image is read-only at run time: where the library is missing and cannot
be built (``_build/`` cannot be made or written, no ``nvcc``, or
``csrc/`` holds no source), :func:`library` raises :class:`KernelError`
naming the library, its source hash and that command.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from .errors import KernelError

__all__ = ["library", "library_path", "build", "build_once", "kernel_fn",
           "check", "launch_lock", "build_seconds", "build_log", "BUILD_COMMAND"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "csrc"
_OUT = _HERE / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: builds the library where :func:`library` looks for it (see :func:`main`)
BUILD_COMMAND = "python -m dentist_tpu_torch._build"

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


def library_path() -> Path:
    """The kernel library that :func:`library` loads: ``_build/`` beside
    this module, named by a hash of the flags, the sources and their
    headers.  Builds nothing."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in sorted(_SRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return _OUT / f"libdentist_kernels_{h.hexdigest()[:16]}.so"


def _cannot_build(so: Path, why: str) -> KernelError:
    digest = so.stem.rsplit("_", 1)[1]
    return KernelError(
        f"the kernel library {so} (source hash {digest}) is missing and "
        f"cannot be built here: {why}.  Build it where the CUDA toolkit is "
        f"(no GPU needed), as a user who may write {so.parent}, with: "
        f"{BUILD_COMMAND}")


def build() -> Path:
    """Make :func:`library_path` exist and return it: built from
    ``csrc/`` unless it is there already (``build_seconds`` stays 0.0
    then).  Raises :class:`KernelError` naming :data:`BUILD_COMMAND`
    where it cannot build: ``csrc/`` holds no source, there is no
    ``nvcc``, or ``_build/`` cannot be made or written."""
    so = library_path()
    if so.exists():
        return so
    sources = sorted(_SRC.glob("*.cu"))
    if not sources:
        raise _cannot_build(so, f"{_SRC} holds no .cu source")
    try:
        nvcc_bin = _nvcc()
    except KernelError as exc:
        raise _cannot_build(so, str(exc)) from None

    def nvcc(tmp: Path) -> None:
        global build_seconds, build_log
        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        try:
            procs = [subprocess.Popen(
                [nvcc_bin, *_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            failed = [(src.name, p.returncode)
                      for src, p in zip(sources, procs) if p.returncode]
            if not failed:
                link = subprocess.run(
                    [nvcc_bin, *_ARCH, "-shared", "-o", str(tmp),
                     *map(str, objs)], capture_output=True, text=True)
                build_log += link.stdout + link.stderr
                if link.returncode:
                    failed = [("link", link.returncode)]
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        build_seconds = time.perf_counter() - t0
        if failed:
            raise KernelError(f"nvcc failed {failed}:\n{build_log}")

    try:
        build_once(so, nvcc)
    except OSError as exc:
        raise _cannot_build(so, f"{so.parent} cannot be made or written "
                                f"({exc})") from exc
    return so


def library() -> ctypes.CDLL:
    """The kernel library, built on first use (:func:`build`)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def build_once(target: Path, build) -> bool:
    """Make ``target`` exist, built at most once by all the processes
    that call this together: under an exclusive ``flock`` on
    ``<target>.lock``, ``build(tmp)`` writes a temporary file that is
    renamed onto ``target``, unless ``target`` appeared while this call
    waited for the lock.  Returns whether this call built it; an error
    of ``build`` propagates and leaves ``target`` absent."""
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{target}.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if target.exists():
                return False
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            try:
                build(tmp)
                os.replace(tmp, target)
            finally:
                tmp.unlink(missing_ok=True)
            return True
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


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


def main() -> int:
    """``python -m dentist_tpu_torch._build``: build the kernel library
    into ``_build/`` beside this module, with the flags and the name that
    :func:`library` looks for, and print its path, the build's seconds
    and nvcc's output (ptxas's registers, stack and spills per kernel).
    Compiles and links only: needs ``nvcc``, no GPU.  Exits 1 with the
    :class:`KernelError`'s text where it cannot build."""
    try:
        so = build()
    except KernelError as exc:
        print(f"dentist_tpu_torch._build: {exc}", file=sys.stderr)
        return 1
    print(f"library: {so}")
    print(f"build seconds: {build_seconds:.3f}"
          + ("" if build_log else " (built already)"))
    print(build_log, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
