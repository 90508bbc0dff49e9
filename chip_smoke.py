#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dentist_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA GPU must be present; prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build: compiles the three kernels from ``dentist_tpu_torch/csrc/``.
3. Kernels: each kernel, in its store/unpacked mode and its 2-bit packed
   mode (K1p, K2p full and windowed, K3p), against its plain PyTorch
   version on the card, on seeded inputs at the main path's shapes.  The
   DPs are integer, so the tolerance is 0: every output must be equal.
   Prints each mode's time beside its plain version's.
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
   Prints each run's wall seconds, the device's busy share of the
   profiled run, by kernel and copy, and the host seconds of its 2-bit
   packing.
7. Host windows: the 60 kb scenario through ``run_pipeline`` with the
   process's device store built too small for it, so every extension
   flush ships 2-bit packed host windows (K1p); the outputs must hash as
   in phase 4.
8. Two ranks on one card: two ``dentist_tpu_torch.dryrun`` workers on
   ``cuda:0`` in a gloo group run the 60 kb scenario through
   ``run_pipeline``, every dispatch split over both; rank 0's outputs
   must hash as in phase 4, and each rank must have launched K1p, K2p
   and K3p on its own lanes.  Then one NCCL lane gather in a one-rank
   group on the card.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  The record has one entry per kernel
mode that a path runs, with that mode's launches and times: K1 (store
mode) and K2p, K3p (2-bit modes) on the main path, K1p in phase 7.  K2
and K3 run only in their 2-bit modes now; their unpacked modes are the
oracles phase 3 holds K2p and K3p against, and are timed in its log.
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


def hold(what: str, kernel, plain, reps: int) -> dict:
    """``kernel()`` against ``plain()`` on the card (tolerance 0); the
    kernel's mean ms by CUDA events over ``reps`` launches, the plain
    version's by host clock over one call."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, ref)
    if err:
        fail(f"{what}: kernel != plain (max abs err {err})")
    return {"err": err, "ms": cuda_ms(kernel, reps), "plain_ms": plain_ms,
            "out": got}


def merge(stats: dict, new: dict) -> dict:
    """Keep the worst error and the last case's times."""
    return {"err": max(stats.get("err", 0), new["err"]), "ms": new["ms"],
            "plain_ms": new["plain_ms"]}


def launch_counts() -> dict:
    from dentist_tpu_torch.dryrun import launch_counts as counts

    return counts()


def reset_launch_counts() -> None:
    from dentist_tpu_torch.ops import banded, nw_dist, nw_round

    for mod in (banded, nw_round, nw_dist):
        mod.launches = 0
        mod.packed_launches = 0


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


def k1p_case(rng, R: int, N: int, bounded: bool):
    """Host-window lanes, 2-bit packed: B windows that hold a noisy copy
    of the A window from column W (three lanes in four) or random bases;
    optionally identity-diagonal bounds on some lanes."""
    import torch

    from dentist_tpu_torch.ops.banded import DIAG_UNBOUNDED, bw_for
    from dentist_tpu_torch.ops.pack2 import pack2bit

    W = 256
    BW = bw_for(R, W)
    a = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b = rng.integers(0, 4, (N, BW)).astype(np.uint8)
    for n in range(N):
        if n % 4 != 3:
            seg = a[n, : BW - W].copy()
            noise = rng.random(len(seg)) < 0.12
            seg[noise] = rng.integers(0, 4, int(noise.sum()))
            b[n, W : W + len(seg)] = seg
    meta5 = np.zeros((5, N), np.int32)
    meta5[0] = rng.integers(R, int(1.2 * R), N)
    meta5[1] = np.arange(N) % 8
    meta5[2] = rng.integers(R // 2, R + 1, N)
    meta5[3] = -DIAG_UNBOUNDED
    meta5[4] = DIAG_UNBOUNDED
    if bounded:
        meta5[4, ::3] = rng.integers(20, 200, len(meta5[4, ::3]))
        meta5[3, 1::5] = -rng.integers(20, 200, len(meta5[3, 1::5]))
    num_k = np.round(R * np.array([1.0, 0.98, 1.02, 0.95, 1.05, 1.0, 0.9, 1.1])
                     ).astype(np.int32)
    chars = np.concatenate([pack2bit(a), pack2bit(b)], axis=1)
    return torch.from_numpy(chars).cuda(), torch.from_numpy(meta5).cuda(), num_k


def k2p_pack(args, window: bool):
    """``nw_lanes``' tensors as K2p inputs: [template | read | steps]
    packed rows and the (3, N) meta, or (4, N) with ``loc0`` rows for
    windowed lanes."""
    import torch

    from dentist_tpu_torch.ops.pack2 import pack2bit

    tpl, t_lens, reads, r_lens, cen = (a.cpu().numpy() for a in args)
    steps = np.diff(cen, axis=0).astype(np.uint8).T  # already 0..2
    chars = np.concatenate([pack2bit(np.ascontiguousarray(tpl.T)),
                            pack2bit(reads), pack2bit(steps)], axis=1)
    rows = [t_lens, r_lens, cen[0]]
    if window:  # interior offsets, as the windowed dispatch ships them
        rows.append(np.minimum(33, np.maximum(t_lens - 126, 0)))
    meta = np.stack(rows).astype(np.int32)
    return torch.from_numpy(chars).cuda(), torch.from_numpy(meta).cuda()


def phase_kernels():
    import torch

    from dentist_tpu_torch.ops import banded, nw_dist, nw_round

    from dentist_tpu_torch.ops.pack2 import pack2bit

    rng = np.random.default_rng(2024)
    store = banded.device_store()
    rows = []

    # K1 at the main path's window buckets and lane buckets
    k1, k1p = {}, {}
    for R, N in ((1512, 128), (13608, 1024)):
        for bounded in (False, True):
            meta, num_k = k1_case(store, rng, R, N, bounded)
            st = hold(f"K1 extend R={R} N={N} bounded={bounded}",
                      lambda: banded.extend(store.array, meta, num_k, R=R, W=256),
                      lambda: banded.extend_reference(store.array, meta, num_k,
                                                      R=R, W=256), 3)
            aligned = int((st["out"][3] > 0).sum())
            log(f"K1 extend R={R} N={N} diag_bounds={bounded}: equal "
                f"(tolerance 0), {aligned}/{N} lanes aligned; kernel "
                f"{st['ms']:.3f} ms, plain {st['plain_ms']:.1f} ms")
            k1 = merge(k1, st)
            chars, meta5, num_k = k1p_case(rng, R, N, bounded)
            st = hold(f"K1p extend_packed R={R} N={N} bounded={bounded}",
                      lambda: banded.extend_packed(chars, meta5, num_k, R=R, W=256),
                      lambda: banded.extend_packed_reference(chars, meta5, num_k,
                                                             R=R, W=256), 3)
            aligned = int((st["out"][3] > 0).sum())
            log(f"K1p extend_packed R={R} N={N} diag_bounds={bounded}: equal "
                f"(tolerance 0), {aligned}/{N} lanes aligned; kernel "
                f"{st['ms']:.3f} ms, plain {st['plain_ms']:.1f} ms")
            k1p = merge(k1p, st)
    rows.append(("K1 extend", "dentist_tpu_torch/csrc/extend.cu",
                 "dentist_tpu/ops/banded.py:62", "main", "K1", k1))
    rows.append(("K1p extend_packed", "dentist_tpu_torch/csrc/extend.cu",
                 "dentist_tpu/ops/banded.py:249", "host_windows", "K1p", k1p))

    # K2 and K2p: a full round and a windowed round
    k2p = {}
    for T, RL, N, lead_free, window in ((512, 1024, 32, -1, False),
                                        (192, 384, 2048, 16, True)):
        args = nw_lanes(rng, T, RL, N, window)
        kw = dict(T=T, W=128, S=T + RL, NWIN=-(-T // 126), lead_free=lead_free)
        st = hold(f"K2 nw_round T={T} N={N}",
                  lambda: nw_round.nw_round(*args, **kw),
                  lambda: nw_round.nw_round_reference(*args, **kw), 3)
        log(f"K2 nw_round T={T} RL={RL} N={N} lead_free={lead_free}: equal "
            f"(tolerance 0), {int(st['out'][6].sum())}/{N} lanes covered; "
            f"kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.1f} ms")
        unpacked = st["out"]
        chars, meta = k2p_pack(args, window)
        st = hold(f"K2p nw_round_packed T={T} N={N}",
                  lambda: nw_round.nw_round_packed(chars, meta, RL=RL, **kw),
                  lambda: nw_round.nw_round_packed_reference(chars, meta, RL=RL,
                                                             **kw), 3)
        if max_abs_err(st["out"], unpacked):
            fail(f"K2p != K2 on the same lanes at T={T} N={N}")
        log(f"K2p nw_round_packed T={T} RL={RL} N={N} lead_free={lead_free}: "
            f"equal to plain and to K2 (tolerance 0); kernel {st['ms']:.3f} ms, "
            f"plain {st['plain_ms']:.1f} ms")
        k2p = merge(k2p, st)
    rows.append(("K2p nw_round_packed", "dentist_tpu_torch/csrc/nw_round.cu",
                 "dentist_tpu/ops/consensus.py:491", "main", "K2p", k2p))

    # K3 and K3p: the polish scorer at V = 256 candidates
    k3p = {}
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
        st = hold(f"K3 nw_dist V={V} NB={NB}",
                  lambda: nw_dist.nw_dist_pairs(b, m, TW, TWp, RW, NB),
                  lambda: nw_dist.nw_dist_pairs_reference(b, m, TW, TWp, RW, NB),
                  10)
        log(f"K3 nw_dist V={V} NB={NB}: equal (tolerance 0); kernel "
            f"{st['ms']:.3f} ms, plain {st['plain_ms']:.1f} ms")
        unpacked = st["out"]
        p = torch.from_numpy(pack2bit(buf)).cuda()
        st = hold(f"K3p nw_dist_packed V={V} NB={NB}",
                  lambda: nw_dist.nw_dist_pairs_packed(p, m, TW, TWp, RW, NB),
                  lambda: nw_dist.nw_dist_pairs_packed_reference(p, m, TW, TWp,
                                                                 RW, NB), 10)
        if max_abs_err(st["out"], unpacked):
            fail(f"K3p != K3 on the same rows at NB={NB}")
        log(f"K3p nw_dist_packed V={V} NB={NB}: equal to plain and to K3 "
            f"(tolerance 0); kernel {st['ms']:.3f} ms, plain "
            f"{st['plain_ms']:.1f} ms")
        k3p = merge(k3p, st)
    rows.append(("K3p nw_dist_packed", "dentist_tpu_torch/csrc/nw_dist.cu",
                 "dentist_tpu/ops/consensus.py:2065", "main", "K3p", k3p))
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

    from dentist_tpu_torch.pipeline import STAGE_SECONDS, reset_stage_seconds
    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             phase_a_scenario, write_scenario)

    d = os.path.join(tmp, "phase_a")
    sc = phase_a_scenario()
    asm, reads = write_scenario(sc, d)
    reset_stage_seconds()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    result, out, wall = run_phase_a(d, asm, reads, "")
    launches = launch_counts()
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
    for kernel in ("K1", "K2", "K3"):  # each kernel, in either mode
        if launches[kernel] + launches[kernel + "p"] <= 0:
            fail(f"kernel {kernel} was not launched on the main path")
    for mode in ("K2p", "K3p"):  # consensus ships packed inputs
        if launches[mode] <= 0:
            fail(f"{mode} was not launched on the main path")
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

    from dentist_tpu_torch.ops import pack2

    d = os.path.join(tmp, "phase_a")
    asm, reads = (os.path.join(d, f) for f in ("assembly.fasta", "reads.fasta"))
    walls = []
    for i in range(calls):
        last = i == calls - 1
        pack2.seconds, pack2.calls = 0.0, 0
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
    log(f"  host 2-bit packing in the profiled run: {pack2.seconds * 1e3:.1f} ms "
        f"over {pack2.calls} calls")


def check_e2e_hashes(d: str, what: str) -> None:
    for name, want in E2E_SHA256.items():
        got = sha256(os.path.join(d, name))
        if got != want:
            fail(f"{what}: {name} sha256 {got} != JAX {want}")


def phase_host_windows(tmp: str) -> dict:
    """The 60 kb scenario with a device store too small for it: every
    K1 flush takes the 2-bit host-window path (K1p)."""
    from dentist_tpu_torch.ops import banded
    from dentist_tpu_torch.pipeline import PipelineConfig, run_pipeline

    asm, reads = (os.path.join(tmp, "e2e", f) for f in ("assembly.fasta",
                                                        "reads.fasta"))
    d = os.path.join(tmp, "e2e_host_windows")
    os.makedirs(d)
    banded.reset_device_store(capacity=1 << 20)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run_pipeline(asm, reads, os.path.join(d, "out.fasta"),
                     PipelineConfig(read_coverage=20.0))
    finally:
        banded.reset_device_store()
    launches = launch_counts()
    check_e2e_hashes(d, "60 kb scenario on host windows")
    log(f"host windows, 60 kb / 3 gaps, 1 MiB device store: FASTA, AGP and "
        f"BED equal to the JAX package's (sha256), "
        f"{time.perf_counter() - t0:.1f} s; kernel launches {json.dumps(launches)}")
    if launches["K1"] != 0 or launches["K1p"] <= 0:
        fail(f"host-window phase: K1 flushes did not all take K1p: {launches}")
    return launches


def phase_two_ranks(tmp: str) -> None:
    """Two ranks on the one card in a gloo group (NCCL refuses two ranks
    on one card), then one NCCL lane gather in a one-rank group."""
    import torch
    import torch.distributed as dist

    from dentist_tpu_torch.dryrun import free_port, run_ranks
    from dentist_tpu_torch.parallel.dp import DPGroup, gather_lanes
    from dentist_tpu_torch.pipeline import PipelineConfig, run_pipeline

    asm, reads = (os.path.join(tmp, "e2e", f) for f in ("assembly.fasta",
                                                        "reads.fasta"))
    d = os.path.join(tmp, "e2e_two_ranks")
    os.makedirs(d)
    t0 = time.perf_counter()
    ranks = run_ranks(run_pipeline, (asm, reads, os.path.join(d, "out.fasta"),
                                     PipelineConfig(read_coverage=20.0)), {},
                      n=2, devices=["cuda:0", "cuda:0"], backend="gloo",
                      pass_group=False, threads=4)
    check_e2e_hashes(d, "60 kb scenario on two ranks")
    for r in ranks:
        log(f"two ranks on one card, rank {r['rank']}: kernel launches "
            f"{json.dumps(r['launches'])}")
        for mode in ("K1p", "K2p", "K3p"):
            if r["launches"][mode] <= 0:
                fail(f"rank {r['rank']} launched no {mode} on its lanes")
    log(f"two ranks on one card, 60 kb / 3 gaps: rank 0's FASTA, AGP and BED "
        f"equal to the JAX package's (sha256), {time.perf_counter() - t0:.1f} s")

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(24, dtype=torch.int32, device="cuda").reshape(2, 3, 4)
        got = gather_lanes(x, DPGroup(0, 1, "nccl"), 1)
        torch.cuda.synchronize()
        if got.device.type != "cuda" or not torch.equal(got, x):
            fail("NCCL lane gather in a one-rank group != its input")
    finally:
        dist.destroy_process_group()
    log("NCCL lane gather, one-rank group on the card: equal to its input")


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
        # 7. host-window path on the card
        host_windows = phase_host_windows(tmp)
        # 8. two ranks on the one card
        phase_two_ranks(tmp)

    # each mode's launches in the run that drives it: phase 5 (the main
    # path) for K1, K2p and K3p, phase 7 for K1p
    runs = {"main": launches, "host_windows": host_windows}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": runs[run][mode],
                "max_abs_err": stats["err"], "ms": stats["ms"],
                "plain_ms": stats["plain_ms"]}
               for name, src, rep, run, mode, stats in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
