"""The kernel library builds once when several ranks reach their first
launch together (``dentist_tpu_torch._build.build_once``).

No compiler runs here: the build step is a stand-in that writes a file
slowly, so that concurrent callers overlap inside the lock.
"""

import threading
import time

import pytest

from dentist_tpu_torch._build import build_once


def _slow_build(calls, lock):
    def build(tmp):
        with lock:
            calls.append(tmp)
        time.sleep(0.3)
        tmp.write_bytes(b"library")
    return build


def test_concurrent_builds_build_once(tmp_path):
    target = tmp_path / "_build" / "libkernels.so"
    calls, lock = [], threading.Lock()
    built = []
    threads = [threading.Thread(
        target=lambda: built.append(build_once(target, _slow_build(calls, lock))))
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(calls) == 1, "the second caller must load what the first built"
    assert sorted(built) == [False, True]
    assert target.read_bytes() == b"library"
    assert [p.name for p in target.parent.iterdir()
            if p.name.endswith(".tmp")] == []


def test_failed_build_leaves_no_library(tmp_path):
    target = tmp_path / "libkernels.so"

    def broken(tmp):
        tmp.write_bytes(b"half")
        raise RuntimeError("nvcc failed")

    with pytest.raises(RuntimeError):
        build_once(target, broken)
    assert not target.exists()
    assert [p.name for p in tmp_path.iterdir() if p.name.endswith(".tmp")] == []
    assert build_once(target, lambda tmp: tmp.write_bytes(b"ok")) is True
    assert target.read_bytes() == b"ok"
