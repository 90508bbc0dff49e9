#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dentist_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA GPU must be present; prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build: compiles the three kernels from ``dentist_tpu_torch/csrc/``.
3. Kernels: each kernel against its plain PyTorch version on the card,
   on seeded inputs at the main path's shapes.  The DPs are integer, so
   the tolerance is 0: every output must be equal.  Prints each
   kernel's time beside its plain version's.
4. Main path, small: the 60 kb / 3-gap scenario of ``tests/test_e2e.py``
   through ``python -m dentist_tpu_torch pipeline``; the output FASTA,
   AGP and BED must hash to the JAX package's outputs.
5. Main path, real size: the 3 Mb / 16-gap scenario of ``bench.py``
   phase A through ``run_pipeline``; every kernel must have launched,
   the gaps closed (byte-exact against the simulated truth) must be at
   least as many as the JAX package closes, and the FASTA, AGP and BED
   must hash to the JAX package's outputs.
6. Profile: ``PROFILE_CALLS`` more phase-A runs in the same process, the
   last under ``torch.profiler``; each must hash as phase 5's did.
   Prints each run's wall seconds and the device's busy share of the
   profiled run, by kernel and copy.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Phase-4 constants: sha256 of the outputs of the JAX package's own run,
#   JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 python -m dentist_tpu.cli \
#       pipeline assembly.fasta reads.fasta out.fasta --read-coverage 20 -q
# on the two files ``dentist_tpu_torch.scenarios.write_scenario(
# e2e_scenario(), dir)`` writes (x86-64 CPU, JAX on its CPU backend).
E2E_SHA256 = {
    "out.fasta": "9b020ffd563fc37cfef45ff22de97dddf938e209d61a98d43965ff6f22117d85",
    "out.agp": "da8ffdb0dac133429bdd91899234a72494a2138c50af012acfc72a38096f9bee",
    "out.closed-gaps.bed": "61fa6fce8358b86aead07d38941b89939d2ded88bccfdda74ae1d0f4b0a30251",
}
# Phase-5 reference: the same JAX command on ``phase_a_scenario()`` closes
# all 16 gaps, 15 of them byte-exact over the gap and 500 bp either side
# (the gap at 1,481,156-1,481,253 is closed inexactly), with these
# output hashes (same machine and command as above).
PHASE_A_JAX_CLOSED = 16
PHASE_A_JAX_EXACT = 15
PHASE_A_SHA256 = {
    "out.fasta": "572fb62b403c2fb5875b5e0f7783717497c972a7f4781525950e4742f8d0a841",
    "out.agp": "f231fb48b66abb60280707599ba6ff0477711f0a0a168ee432d182f449d58f0c",
    "out.closed-gaps.bed": "b6efeff815e249ab368f5cae9d7e8df79bb73401f4c9b7b5f39a00cdfc1fac4c",
}

#: phase-6 runs: the later calls of a process, without its first-call costs
PROFILE_CALLS = 3

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def sha256(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, ref) -> int:
    if not isinstance(got, (tuple, list)):
        got, ref = (got,), (ref,)
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            fail(f"kernel output {tuple(g.shape)} {g.dtype} != plain "
                 f"{tuple(r.shape)} {r.dtype}")
        err = max(err, int((g.long() - r.long()).abs().max().item()) if g.numel() else 0)
    return err


# ----------------------------------------------------------------------
# phase 3: inputs at the main path's shapes


def k1_case(store, rng, R: int, N: int, bounded: bool):
    """Extension lanes over a resident genome and read windows: forward
    lanes, backward lanes (A and B reversed), lanes whose read is stored
    reverse-complemented (B reversed + complemented), unrelated lanes;
    optionally identity-diagonal bounds on some lanes."""
    import torch

    from dentist_tpu_torch.ops.banded import DIAG_UNBOUNDED, bw_for

    W = 256
    BW = bw_for(R, W)
    genome = rng.integers(0, 4, 4 * (R + BW) + 2 * N * 64).astype(np.uint8)
    g0 = store.offset_of(genome)
    windows = np.zeros((N, BW), np.uint8)
    meta = np.zeros((12, N), np.int32)
    for n in range(N):
        kind = n % 4
        a0 = int(rng.integers(BW, len(genome) - BW))
        if kind == 1:
            seg = genome[a0 + W - BW : a0 + W].copy()
        else:
            seg = genome[a0 - W : a0 - W + BW].copy()
        if kind == 3:
            seg = rng.integers(0, 4, BW).astype(np.uint8)
        noise = rng.random(BW) < 0.12
        seg[noise] = rng.integers(0, 4, int(noise.sum()))
        windows[n] = 3 - seg[::-1] if kind == 2 else seg
        meta[0, n] = g0 + (a0 - R if kind == 1 else a0)
        meta[1, n] = kind == 1
        meta[2, n] = rng.integers(R // 2, R + 1)
        meta[4, n] = kind in (1, 2)
        meta[5, n] = kind == 2
        meta[6, n] = rng.integers(0, W // 4)
        meta[7, n] = BW - rng.integers(0, W // 4)
        meta[8, n] = rng.integers(R, int(1.2 * R))
        meta[9, n] = n % 8
    w0 = store.offset_of(windows.reshape(-1))
    meta[3] = w0 + np.arange(N) * BW
    meta[10] = -DIAG_UNBOUNDED
    meta[11] = DIAG_UNBOUNDED
    if bounded:
        meta[11, ::3] = rng.integers(20, 200, len(meta[11, ::3]))
        meta[10, 1::5] = -rng.integers(20, 200, len(meta[10, 1::5]))
    num_k = np.round(R * np.array([1.0, 0.98, 1.02, 0.95, 1.05, 1.0, 0.9, 1.1])
                     ).astype(np.int32)
    return torch.from_numpy(meta).cuda(), num_k


def nw_lanes(rng, T: int, RL: int, N: int, window: bool):
    """Consensus lanes: mutated copies of templates (homopolymer lanes
    included), band centers as the host builds them."""
    tpl = np.zeros((N, T), np.uint8)
    reads = np.zeros((N, RL), np.uint8)
    t_lens = np.ones(N, np.int32)
    r_lens = np.zeros(N, np.int32)
    for n in range(N):
        L = int(rng.integers(T // 2, T + 1))
        t = (np.zeros(L, np.uint8) if n % 7 == 0
             else rng.integers(0, 4, L).astype(np.uint8))
        keep = rng.random(L) > 0.04
        r = t[keep]
        ins = rng.random(len(r)) < 0.07
        r = np.insert(r, np.flatnonzero(ins), rng.integers(0, 4, int(ins.sum())))
        sub = rng.random(len(r)) < 0.03
        r[sub] = rng.integers(0, 4, int(sub.sum()))
        if window:
            r = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 9))), r])
        r = r[:RL].astype(np.uint8)
        tpl[n, :L] = t
        t_lens[n] = L
        reads[n, : len(r)] = r
        r_lens[n] = len(r)
    rows = np.arange(T + 1, dtype=np.int64)
    if window:  # proportional centers, steps clipped to 0..2
        tl = np.maximum(t_lens[:, None].astype(np.int64), 1)
        cen = (np.minimum(rows[None, :], tl) * r_lens[:, None]) // tl
    else:  # first-round slope-1 centers, clamped to 2 steps per row
        cen = np.minimum(rows[None, :], r_lens[:, None].astype(np.int64))
    steps = np.clip(np.diff(cen, axis=1), 0, 2)
    cen = np.concatenate([cen[:, :1], cen[:, :1] + np.cumsum(steps, axis=1)], axis=1)
    import torch

    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in
            (tpl.T, t_lens, reads, r_lens, cen.T.astype(np.int32))]


def phase_kernels():
    import torch

    from dentist_tpu_torch.ops import banded, nw_dist, nw_round

    rng = np.random.default_rng(2024)
    store = banded.device_store()
    rows = []

    # K1 at the main path's window buckets and lane buckets
    k1 = {"err": 0}
    for R, N in ((1512, 128), (13608, 1024)):
        for bounded in (False, True):
            meta, num_k = k1_case(store, rng, R, N, bounded)
            got = banded.extend(store.array, meta, num_k, R=R, W=256)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = banded.extend_reference(store.array, meta, num_k, R=R, W=256)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max_abs_err(got, ref)
            if err:
                fail(f"K1 extend != plain at R={R} N={N} bounded={bounded}")
            ms = cuda_ms(lambda: banded.extend(store.array, meta, num_k, R=R, W=256), 3)
            aligned = int((got[3] > 0).sum())
            log(f"K1 extend R={R} N={N} diag_bounds={bounded}: equal "
                f"(tolerance 0), {aligned}/{N} lanes aligned; kernel "
                f"{ms:.3f} ms, plain {plain_ms:.1f} ms")
            k1 = {"err": max(k1["err"], err), "ms": ms, "plain_ms": plain_ms}
    rows.append(("extend", "dentist_tpu_torch/csrc/extend.cu",
                 "dentist_tpu/ops/banded.py:61", banded, k1))

    # K2: a full round and a windowed round
    k2 = {"err": 0}
    for T, RL, N, lead_free, window in ((512, 1024, 32, -1, False),
                                        (192, 384, 2048, 16, True)):
        args = nw_lanes(rng, T, RL, N, window)
        kw = dict(T=T, W=128, S=T + RL, NWIN=-(-T // 126), lead_free=lead_free)
        got = nw_round.nw_round(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = nw_round.nw_round_reference(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, ref)
        if err:
            fail(f"K2 nw_round != plain at T={T} N={N}")
        ms = cuda_ms(lambda: nw_round.nw_round(*args, **kw), 3)
        log(f"K2 nw_round T={T} RL={RL} N={N} lead_free={lead_free}: equal "
            f"(tolerance 0), {int(got[6].sum())}/{N} lanes covered; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms")
        k2 = {"err": max(k2["err"], err), "ms": ms, "plain_ms": plain_ms}
    rows.append(("nw_round", "dentist_tpu_torch/csrc/nw_round.cu",
                 "dentist_tpu/ops/consensus.py:121", nw_round, k2))

    # K3: the polish scorer at V = 256 candidates
    k3 = {"err": 0}
    TW, TWp, RW, V = 34, 36, 48, 256
    for NB in (8, 32):
        buf = np.zeros((V, 2 * TWp + NB * RW), np.uint8)
        meta = np.zeros((V, 2 + NB), np.int32)
        for v in range(V):
            wl = int(rng.integers(TW // 2, TW + 1))
            w = rng.integers(0, 4, wl).astype(np.uint8)
            e = np.delete(w, wl // 2)
            buf[v, :wl] = w
            buf[v, TWp : TWp + len(e)] = e
            meta[v, :2] = (wl, len(e))
            for nb in range(int(rng.integers(NB // 2, NB + 1))):
                r = w.copy()
                flip = rng.random(wl) < 0.13
                r[flip] = rng.integers(0, 4, int(flip.sum()))
                buf[v, 2 * TWp + nb * RW : 2 * TWp + nb * RW + wl] = r
                meta[v, 2 + nb] = wl
        b, m = torch.from_numpy(buf).cuda(), torch.from_numpy(meta).cuda()
        got = nw_dist.nw_dist_pairs(b, m, TW, TWp, RW, NB)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = nw_dist.nw_dist_pairs_reference(b, m, TW, TWp, RW, NB)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, ref)
        if err:
            fail(f"K3 nw_dist != plain at V={V} NB={NB}")
        ms = cuda_ms(lambda: nw_dist.nw_dist_pairs(b, m, TW, TWp, RW, NB), 10)
        log(f"K3 nw_dist V={V} NB={NB}: equal (tolerance 0); kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms")
        k3 = {"err": max(k3["err"], err), "ms": ms, "plain_ms": plain_ms}
    rows.append(("nw_dist", "dentist_tpu_torch/csrc/nw_dist.cu",
                 "dentist_tpu/ops/consensus.py:1935", nw_dist, k3))
    return rows


# ----------------------------------------------------------------------
# phases 4 and 5: the main path


def phase_e2e(tmp: str) -> None:
    from dentist_tpu_torch.scenarios import e2e_scenario, write_scenario

    d = os.path.join(tmp, "e2e")
    asm, reads = write_scenario(e2e_scenario(), d)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dentist_tpu_torch", "pipeline", asm, reads,
         os.path.join(d, "out.fasta"), "--read-coverage", "20", "-q"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"pipeline subprocess exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    for name, want in E2E_SHA256.items():
        got = sha256(os.path.join(d, name))
        if got != want:
            fail(f"60 kb scenario: {name} sha256 {got} != JAX {want}")
    log(f"main path 60 kb / 3 gaps: FASTA, AGP and BED equal to the JAX "
        f"package's (sha256), {time.perf_counter() - t0:.1f} s")


def run_phase_a(d: str, asm: str, reads: str, tag: str):
    """One ``run_pipeline`` call on the phase-A files, with a fresh
    workdir (a used one would resume from its checkpoints); returns the
    result, the output path and the wall seconds."""
    import torch

    from dentist_tpu_torch.pipeline import PipelineConfig, run_pipeline

    out = os.path.join(d, f"out{tag}.fasta")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_pipeline(asm, reads, out,
                          PipelineConfig(read_coverage=20.0,
                                         workdir=os.path.join(d, f"work{tag}")))
    torch.cuda.synchronize()
    return result, out, time.perf_counter() - t0


def phase_a(tmp: str) -> dict:
    import torch

    from dentist_tpu_torch.ops import banded, nw_dist, nw_round
    from dentist_tpu_torch.pipeline import STAGE_SECONDS, reset_stage_seconds
    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             phase_a_scenario, write_scenario)

    d = os.path.join(tmp, "phase_a")
    sc = phase_a_scenario()
    asm, reads = write_scenario(sc, d)
    reset_stage_seconds()
    torch.cuda.reset_peak_memory_stats()
    for mod in (banded, nw_round, nw_dist):
        mod.launches = 0
    result, out, wall = run_phase_a(d, asm, reads, "")
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches
                for m in (banded, nw_round, nw_dist)}
    peak = torch.cuda.max_memory_allocated()
    n_pileups = None
    with open(os.path.join(d, "work", "pipeline.log")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("event") == "collectPileUps":
                n_pileups = rec["numPileUps"]
    exact = closed_exactly_in(sc, out)
    stages = {k.rsplit(".", 1)[-1]: round(v, 3) for k, v in STAGE_SECONDS.items()}
    log(f"main path 3 Mb / 16 gaps: {wall:.1f} s wall; stages {json.dumps(stages)}")
    log(f"  pile-ups {n_pileups}, gaps closed {result.n_closed_gaps} "
        f"({exact} byte-exact; JAX: {PHASE_A_JAX_CLOSED} closed, "
        f"{PHASE_A_JAX_EXACT} byte-exact); peak device memory "
        f"{peak / 2**30:.2f} GiB; kernel launches {json.dumps(launches)}")
    for name, want in PHASE_A_SHA256.items():
        got = sha256(os.path.join(d, name))
        if got != want:
            fail(f"3 Mb scenario: {name} sha256 {got} != JAX {want}")
    log("  FASTA, AGP and BED equal to the JAX package's (sha256)")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if result.n_closed_gaps < PHASE_A_JAX_CLOSED:
        fail(f"closed {result.n_closed_gaps} gaps, JAX closes {PHASE_A_JAX_CLOSED}")
    if exact < PHASE_A_JAX_EXACT:
        fail(f"{exact} gaps closed byte-exact, JAX closes {PHASE_A_JAX_EXACT}")
    return launches


def phase_profile(tmp: str, calls: int) -> None:
    """``calls`` more phase-A runs, the last under ``torch.profiler``.
    The device is busy where any kernel or copy runs: the union of their
    intervals, against the profiled run's wall."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    d = os.path.join(tmp, "phase_a")
    asm, reads = (os.path.join(d, f) for f in ("assembly.fasta", "reads.fasta"))
    walls = []
    for i in range(calls):
        last = i == calls - 1
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if last else contextlib.nullcontext()) as prof:
            _, out, wall = run_phase_a(d, asm, reads, f"_profile{i}")
        walls.append(wall)
        for name, want in PHASE_A_SHA256.items():
            got = sha256(out[: -len("fasta")] + name[len("out."):])
            if got != want:
                fail(f"profiled 3 Mb run {i}: {name} sha256 {got} != JAX {want}")
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        fail("torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict[str, list] = {}
    for e in dev:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    log(f"profile: {calls} more 3 Mb runs, wall s "
        f"{json.dumps([round(w, 3) for w in walls])}; the last under torch.profiler")
    log(f"  device busy {busy_us / 1e3:.1f} ms of {walls[-1]:.3f} s "
        f"({100 * busy_us / 1e6 / walls[-1]:.2f} %)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {us / 1e3:10.2f} ms {n:6d}x  {name[:90]}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    try:
        from dentist_tpu_torch import _build
        from dentist_tpu_torch.device import require_cuda, set_device
    except ImportError as exc:
        fail(f"dentist_tpu_torch is not importable next to this script: {exc}")

    # 1. device
    require_cuda()
    set_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"built the kernels in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():  # ptxas: registers, spills
        if "Used" in line or "spill" in line:
            log(f"  {line.strip()}")

    # 3. kernels against their plain versions
    rows = phase_kernels()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 4. main path, small, against the JAX package's hashes
        phase_e2e(tmp)
        # 5. main path at real size
        launches = phase_a(tmp)
        # 6. where the time goes in later calls
        phase_profile(tmp, PROFILE_CALLS)

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[mod.__name__.rsplit(".", 1)[1]],
                "max_abs_err": stats["err"], "ms": stats["ms"],
                "plain_ms": stats["plain_ms"]}
               for name, src, rep, mod, stats in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
