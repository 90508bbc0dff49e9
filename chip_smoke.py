#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dentist_tpu_torch``) once on one GPU.

    python3 chip_smoke.py [--baseline DIR]

``--baseline DIR``: a directory holding another version's ``extend.cu``,
``nw_round.cu``, ``nw_dist.cu``, ``round_pack.cu`` and/or
``store_write.cu``, with its ``pack2.cuh`` beside them (``git show
<rev>:dentist_tpu_torch/csrc/<file>`` into an ignored directory of the
repo).  Each source it holds is built with the package's flags, one
``nvcc`` each, all started together, before phase 3, and phase 3 checks
that version's kernels equal to this one's and times them beside this
one's in the same process, in turns (baseline, kernel, kernel,
baseline): K1 and K1p, K2p and K2r, K3p, K3f, K3b, K4 and K4w, K5.

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA GPU must be present; prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build: compiles the kernels from ``dentist_tpu_torch/csrc/``, one
   ``nvcc`` per source, all started together; prints ptxas's registers,
   stack and spills per kernel, and K3's word step in the compiled
   SASS (``cuobjdump``) beside the operations its bound counts.
3. Kernels: each kernel, in each of its modes (K1 and K1p, K2 and K2p
   full and windowed, K2r, K3 and K3p, K4 and K4w sparse and dense, K5,
   K3f and K3b free-shift and global), against its plain PyTorch version
   on the card, on seeded inputs at the main path's shapes (K3f at K3's,
   and besides with every t_len past T, on bytes of any value and at
   V = 4096; K3b at a consensus round's).  The kernels are integer, so the tolerance is 0:
   every output must be equal.  Prints each mode's time beside its plain
   version's and its bound (the least time the card could take: bytes
   over HBM bandwidth or integer operations over the INT32 issue rate,
   whichever is larger; K3, K3p and K3f count 11 operations of their word
   step per template row and 32 read columns, over the rows each answer
   depends on).  K1 and K1p run after phase 5, at every (R, N)
   bucket pair it launched K1 at and at (1512, 128) and (13608, 1024),
   with their ratio to the bound (with ``--baseline``, the other K1 and
   K1p at those two pairs, on the same inputs).  K2, K2p
   and K2r also run after phase 5, at every (T, RL, N) bucket it
   launched K2p or K2r at, with as many live lanes as those launches held
   on average, with their ratio to the bound; K2p at the largest of them
   runs with S = 0 (the forward scan alone) beside the full S (scan and
   traceback); with ``--baseline``, the other K2p there (both S) and K2r
   at the largest K2r bucket, after checking equal outputs.  K3 and K3p
   also run after phase 5, at every (V, NB)
   bucket it launched K3p at, with as many live candidates and filled
   read slots as those launches held on average and lengths drawn from
   theirs (the case's word rows and cells within 15 % of theirs), with
   their ratio to the bound and their DP cell rate; with ``--baseline``,
   the other K3 and K3p checked equal to these and its K3p timed beside
   this one's at the largest bucket and at V = 256, NB = 8.  K4 and K4w
   also run after phase 5, at every bucket it launched them at (mode, T,
   N, sparse or dense, resident or host windows), on the first such
   launch's own inputs, cloned there (a resident launch's template
   windows cut into a store of their own); with ``--baseline``, the
   other K4 or K4w checked equal word for word and timed beside this
   one's there.  K5 also runs after phase 5, at every upload size it
   made (and the largest again at an unaligned offset), with its bytes,
   bound and their ratio; with ``--baseline``, the other K5 on the same
   upload in one launch.  K3b's four cases (free-shift and global, W =
   64 and 65) and K3f's eight are held with ``--baseline``'s K3b and K3f
   too; K3f's ptxas registers, stack and spills are logged beside its
   cases.  K3, K3p, K3f, K3b, K4, K4w and K5 are timed through their wrappers
   as every kernel is, and besides by device time, their launches queued
   behind a sleep kernel (a launch through the wrapper takes longer on
   the host than the kernel on the card); the turns use device time.
4. Main path, small: the 60 kb / 3-gap scenario of ``tests/test_e2e.py``
   through ``python -m dentist_tpu_torch pipeline``; the output FASTA,
   AGP and BED must hash to the JAX package's outputs.
5. Main path, real size: the 3 Mb / 16-gap scenario of ``bench.py``
   phase A through ``run_pipeline``, on the default consensus transport
   (store-resident windows, sparse result blocks, 2-bit store uploads);
   every kernel of that path (K1, K2p, K2r, K3p, K4, K4w, K5) must have
   launched (K1's (R, N, live lanes) are recorded per launch through a
   wrapper around ``banded.extend``, K2p's and K2r's (T, RL, N, live
   lanes) through wrappers around the names ``ops/consensus.py`` calls
   them by, K3p's (V, NB, live candidates, filled slots) and K4's and
   K4w's (T, N, sparse, resident, live lanes) the same way, and each K5
   upload's characters and offset through a wrapper around
   ``banded.store_write``, one launch each), the gaps closed (byte-exact against
   the simulated truth) must be at least as many as the JAX package
   closes, and the FASTA, AGP and BED must hash to the JAX package's
   outputs.
6. Profile: ``PROFILE_CALLS`` more phase-A runs in the same process, the
   last under ``torch.profiler``, then one with
   ``DENTIST_TPU_DENSE_CONS=1``; each must hash as phase 5's did.
   Prints each run's wall seconds, the device's busy share of the
   profiled run, by kernel and copy (every one), the host seconds of its 2-bit
   packing, and the consensus host sections (window building, block
   decoding, stitching) and fetch bytes of the last default call and
   of the dense call.
7. Host windows: the 60 kb scenario through ``run_pipeline`` with the
   process's device store built too small for it, so every extension
   flush ships 2-bit packed host windows (K1p); the outputs must hash as
   in phase 4.
8. Two ranks on one card: two ``dentist_tpu_torch.dryrun`` workers on
   ``cuda:0`` in a gloo group run the 60 kb scenario through
   ``run_pipeline``, every dispatch split over both; rank 0's outputs
   must hash as in phase 4, and each rank must have launched K1p, K2p,
   K3p and the sparse K4 and K4w on its own lanes (a group gathers sparse
   blocks; its windows are host-built).  Then one NCCL lane gather in a
   one-rank group on the card.
9. Dense transport: the 60 kb scenario through ``run_pipeline`` with
   ``DENTIST_TPU_DENSE_CONS=1`` (host windows, dense blocks); the outputs
   must hash as in phase 4.
10. Staged workflow: the 3 Mb scenario through the command line's
   ``cli.main``, one sub-command per stage as DENTIST's Snakemake DAG
   runs them (``scenarios.staged_commands``: masks, ``align``, ``map``,
   ``collect``, ``process`` in two batches, ``merge-insertions``,
   ``output``, ``check-results``), each stage timed with its launches.
   ``map`` must have launched K1 or K1p (so must ``align`` where it
   writes alignments: on this repeat-free genome it writes none, as in
   JAX), the two ``process`` batches K2p, K2r, K3p, K4, K4w and K5
   together; the FASTA, AGP, BED
   and scaffolding maps must hash to the JAX package's staged run, and
   the gaps closed and closed byte-exact must be at least its counts.
11. Repeats: the staged workflow's masking stages (``dust``, ``tandem``,
   ``align``, the self-coverage ``mask``) through ``cli.main`` on a 1 Mb
   assembly with planted interspersed repeats and tandem arrays
   (``scenarios.repeat_assembly``); ``tandem`` and ``align`` must have
   launched K1 or K1p and found tandem intervals and as many
   self-alignments as the JAX package, and the tandem mask, the
   self-alignments and the self-coverage mask must hash (array by array)
   to the JAX package's.

The last lines of standard output are the card's ``nvidia-smi`` line,
the kernels' JSON record and ``{"ok": true, "device": {...}}``.  The
record has one entry per kernel mode that a path runs, with that mode's
launches in the run that drives it and its times and bound from phase 3
(K4's and K4w's from each mode's largest phase-5 bucket, or phase 3's
fixed cases for a mode phase 5 did not launch):
K1, K2p, K2r, K3p, K4 and K4w sparse, K5 on the main path (phase 5), K1p
in phase 7, K4 and K4w dense in phase 9.  K2 and K3 run only in their
2-bit modes; their unpacked modes are the oracles phase 3 holds K2p and
K3p against, and are timed in its log.  K3f and K3b (the JAX package's
``_nw_dist_full`` with free-shift ends and ``_banded_nw_dist``) are on no
path: nothing in the JAX package calls them, its polish scorer being
``_nw_dist_pair_packed`` (K3p), so nothing in the port does; their
record carries their launches in phase 3.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
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

# Phase-10 constants: sha256 of the outputs of the JAX package's staged
# run of the same sub-commands, one process per stage,
#   JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 python -m dentist_tpu.cli <argv>
# for each argv of ``dentist_tpu_torch.scenarios.staged_commands(dir)``,
# on the files ``write_scenario(phase_a_scenario(), dir)`` and
# ``write_truth(phase_a_scenario(), dir)`` write (x86-64 CPU, JAX on its
# CPU backend).  It closes all 16 gaps (check-results' numClosedGaps),
# 15 byte-exact, and its FASTA, AGP and BED equal the pipeline's above.
STAGED_JAX_CLOSED = 16
STAGED_JAX_EXACT = 15
STAGED_SHA256 = {
    "out.fasta": "572fb62b403c2fb5875b5e0f7783717497c972a7f4781525950e4742f8d0a841",
    "out.agp": "f231fb48b66abb60280707599ba6ff0477711f0a0a168ee432d182f449d58f0c",
    "out.closed-gaps.bed": "b6efeff815e249ab368f5cae9d7e8df79bb73401f4c9b7b5f39a00cdfc1fac4c",
    "scaffolding.json": "e66362251991e9990b4457673e83d646ec8f9e4be1a15df98b6058f7b1dbd144",
}

# Phase-11 constants: the JAX package's run of the first four argvs of
# ``staged_commands(dir)`` (dust, tandem, align, the self-coverage mask),
# in one process through ``dentist_tpu.cli.main([*argv, "-q"])`` with
# JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 (x86-64 CPU, JAX on its CPU
# backend), on the ``assembly.fasta`` that ``write_fasta`` writes from
# ``repeat_assembly(1_000_000, 16)`` (sha256 below): 4 tandem intervals,
# 226 self-alignments, 15 self-coverage intervals; ``npz_sha256`` of its
# files.
REPEATS_LENGTH, REPEATS_COPIES = 1_000_000, 16
REPEATS_ASSEMBLY_SHA256 = "8aba22ababdd96052d6c885315a841ab7912a5f8740af789eb85b5a6e1a29f57"
REPEATS_JAX_ALIGNMENTS = 226
REPEATS_SHA256 = {
    "tan.mask.npz": "460279c8b290a49a87226fadc6bf671c83f368c3a963d945de82070c36097180",
    "self.las.npz": "7dc22fe76d45c5b87791365a16f0a2d88f9765af27432456c002cd430aafcc88",
    "self.mask.npz": "06e6cd33cb9ed3e62b556aeff70dae0565a7f68cf70a70ccb9e048fe1468df93",
}

#: phase-6 runs: the later calls of a process, without its first-call costs
PROFILE_CALLS = 3

#: the card's HBM bandwidth (bytes/s), for the bounds
HBM_BYTES_PER_S = 3.35e12
#: integer operations per cell or column that the bounds count, per
#: kernel: the recurrence's compares, adds, mins and selects (K1 adds the
#: score key and its max), or a packing's per-column work; K3b (a cell
#: DP; K3f counts word rows as K3 does)
OPS_PER_CELL = {"K1": 12, "K2": 10, "K3b": 6, "K4": 8, "K5": 3}
#: INT32 operations of one K3 word step, a template row on 32 read
#: columns: the match mask (1), the add with its carry (1), the
#: recurrence's 7 logic operations (three-input LOP3s: Xv, Eq & Pv, Xh,
#: Ph, Mh, Pv, Mv) and the two shifts (2).  Loads, loop control and the
#: kernel's own code spread are not the function's work and are not
#: counted; phase 2 prints the compiled row loop's SASS instructions
#: beside this count (:func:`sass_row_steps`)
K3_OPS_PER_WORD32 = 11
#: INT32 operations a row that K3f's free-shift search adds to its word
#: steps: D[i][rl] from the horizontal deltas at column rl (the two bits
#: extracted, one three-input add) and the running minimum
K3F_OPS_PER_SEARCH_ROW = 4
#: template rows one pass of K3's row loop advances: ``myers`` takes a
#: window's codes 16 at a time and unrolls their rows
K3_ROWS_PER_LOOP = 16
#: template rows one pass of K3f's row loop advances: ``walk_rows`` loads
#: 8 template bytes at a time and unrolls their rows
K3F_ROWS_PER_LOOP = 8
#: how far a phase-3 K3 case's word rows and cells may stray from the
#: per-launch average of the phase-5 bucket it stands for
K3_CASE_MARGIN = 0.15

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


def cuda_ms_queued(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` (CUDA events) with its
    launches queued behind a sleep kernel, so that the host's cost of a
    launch (the wrapper's checks, its allocation, the ctypes call) does
    not show in a kernel shorter than it.  The sleep is lengthened until
    it outlasts the host's enqueueing, up to 2**30 cycles; a ``fn`` that
    waits for the card never lets it, and fails there."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 21
    while cycles <= 1 << 30:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        if host_ms < 0.8 * (time.perf_counter() - t1) * 1e3:
            return start.elapsed_time(end) / reps
        cycles *= 2
    fail(f"queued timing: {reps} launches still not queued behind a sleep "
         f"of {cycles // 2} cycles")


#: INT32 operations per second of the card, set in phase 1: SMs × 64
#: INT32 lanes × the maximum SM clock
INT_OPS_PER_S = None


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``ops``
    integer operations: the larger of the two times, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sass_row_steps(so: str) -> None:
    """Print the instructions of K3's and K3f's compiled word step, beside
    the operations the bounds count (``K3_OPS_PER_WORD32``): the row
    loops (those the SASS closes with a backward branch) of
    ``nw_dist_kernel<true, 1>`` (one 64-bit word) over the
    ``K3_ROWS_PER_LOOP`` rows a pass advances, its 16-code template load
    included, and of ``nw_dist_full_kernel<true, 1>`` (global, one 32-bit
    limb: its two-plane and eight-plane loops) over
    ``K3F_ROWS_PER_LOOP``, the match and the 8-byte template load
    included.  A diagnostic only; fails where the toolkit has no
    ``cuobjdump``."""
    import re

    from dentist_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        fail(f"K3 word step: no {tool}")
    sass = re.split(r"\n\s*Function : ", subprocess.run(
        [tool, "-sass", so], capture_output=True, text=True, check=True).stdout)
    for what, kernel, rows, bits in (
            ("K3", "nw_dist_kernel", K3_ROWS_PER_LOOP, 64),
            ("K3f", "nw_dist_full_kernel", K3F_ROWS_PER_LOOP, 32)):
        # the mangled name's length prefix ends in a digit: not K3b's
        name = re.compile(rf"\S*\d{kernel}ILb1ELi1E")
        for fn in sass:
            if not name.match(fn):
                continue
            addrs = [int(a, 16) for a, op in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", fn)]
            loops = [sum(int(t, 16) <= b <= int(a, 16) for b in addrs)
                     for a, t in re.findall(
                         r"/\*([0-9a-f]{4,})\*/[^;]*?\bBRA\s+(0x[0-9a-f]+)", fn)
                     if int(t, 16) < int(a, 16)]
            loops = [n for n in loops if n >= 4 * rows]
            if loops:
                log(f"  {what} word step: {sum(loops) / len(loops) / rows:.2f} "
                    f"SASS instructions a row on one {bits}-bit word "
                    f"(cuobjdump -sass: {kernel}<1, 1>'s row loops {loops} "
                    f"instructions for {rows} rows each); the bound counts "
                    f"{bits // 32 * K3_OPS_PER_WORD32} operations, "
                    f"{K3_OPS_PER_WORD32} on each 32 read columns")
                break
        else:  # K3's count is the one PERF.md holds to; K3f's is a note
            (fail if what == "K3" else log)(
                f"{what} word step: no row loop in {kernel}<1, 1>'s SASS")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def hold(what: str, kernel, plain, reps: int, work: dict) -> dict:
    """``kernel()`` against ``plain()`` on the card (tolerance 0); the
    kernel's mean ms by CUDA events over ``reps`` launches, the plain
    version's by host clock over one call; ``work`` is the case's
    :func:`bound`."""
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
    st = {"err": err, "ms": cuda_ms(kernel, reps), "plain_ms": plain_ms,
          "out": got, **work}
    log(f"{what}: equal to plain (tolerance 0); kernel {st['ms']:.3f} ms, "
        f"plain {plain_ms:.1f} ms, bound {st['bound_ms']:.6f} ms "
        f"({st['bound_by']})")
    return st


def merge(stats: dict, new: dict) -> dict:
    """Keep the worst error and the last case's times and bound."""
    return {"err": max(stats.get("err", 0), new["err"]), "ms": new["ms"],
            "plain_ms": new["plain_ms"], "bound_ms": new["bound_ms"],
            "bound_by": new["bound_by"]}


def launch_counts() -> dict:
    from dentist_tpu_torch.dryrun import launch_counts as counts

    return counts()


def reset_launch_counts() -> None:
    from dentist_tpu_torch.dryrun import reset_launch_counts as reset

    reset()


def ptxas_lines(text: str) -> list:
    """ptxas's report per kernel from ``-Xptxas -v`` output: the kernel
    and its template arguments, registers, stack and spills."""
    import re

    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for \S*?[a-z](?:\d+)([a-z_]+_kernel)(?:I(\w*?)EEv|E)", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "spill" in line and name:
            out.append(f"{name}: {line.strip()}")
        elif "Used" in line and name:
            out[-1] += "; " + line.split(":", 1)[1].strip()
            name = None
    return out


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


def k1_work(meta, R: int, W: int, packed: bool) -> dict:
    """K1's bound: the band cells of every lane's rows up to its a_len;
    A and B windows (packed: their 2-bit rows) and meta in, the result
    block out."""
    from dentist_tpu_torch.ops.banded import bw_for

    N = meta.shape[1]
    BW = bw_for(R, W)
    cells = int(meta[2].clamp(0, R).sum()) * W
    win = N * (R + BW) // 4 if packed else N * (R + BW)
    io = win + nbytes(meta) + N * 4 * (4 + R // 126)
    return bound(io, OPS_PER_CELL["K1"] * cells)


def k2_work(t_lens, T: int, W: int, NWIN: int, inputs: int) -> dict:
    """K2's bound (every mode): the band cells of every lane's template
    rows; ``inputs`` bytes in, the seven fields out."""
    N = t_lens.numel()
    cells = int(t_lens.clamp(0, T).sum()) * W
    out = N * (T + 8 * (T + 1) + 8 + 4 + 4 * NWIN + 1)
    return bound(inputs + out, OPS_PER_CELL["K2"] * cells)


def k4_work(N: int, T: int, NWIN: int, tpl_bytes: int, out_words: int) -> dict:
    """K4's and K4w's bound: the fields of T columns per lane and the
    template (or centers) in, the blocks out."""
    fields = N * (T + 8 * (T + 1) + 8 + 4 + 4 * NWIN + 1)
    return bound(fields + tpl_bytes + 4 * N * out_words,
                 OPS_PER_CELL["K4"] * N * (T + 1))


def resident_case(store, rng, N: int):
    """Windowed lanes in the device store: N template windows (130..192
    chars) and mutated read segments with up to 8 leading slack chars,
    uploaded through ``offset_of`` (K5); (5, N) coordinates as the
    default windowed rounds ship them."""
    import torch

    T, RL = 192, 384
    tpl = rng.integers(0, 4, (N, T)).astype(np.uint8)
    seg = np.zeros((N, RL), np.uint8)
    meta = np.zeros((5, N), np.int32)
    for n in range(N):
        L = T if n % 3 else int(rng.integers(130, T + 1))
        t = tpl[n, :L]
        keep = rng.random(L) > 0.04
        r = t[keep]
        ins = rng.random(len(r)) < 0.07
        r = np.insert(r, np.flatnonzero(ins), rng.integers(0, 4, int(ins.sum())))
        sub = rng.random(len(r)) < 0.03
        r[sub] = rng.integers(0, 4, int(sub.sum()))
        r = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 9))), r])[:RL]
        seg[n, : len(r)] = r
        meta[:, n] = (L, len(r), min(33, L - 126), n * T, n * RL)
    meta[3] += store.offset_of(tpl.reshape(-1), cache=False)
    meta[4] += store.offset_of(seg.reshape(-1), cache=False)
    return torch.from_numpy(meta).cuda()


def scorer_case(rng, V: int, N: int, T: int, RL: int, over_slope: bool,
                past_t: bool = False, codes: int = 4):
    """K3f and K3b inputs on the general layout: template windows of T/2
    to T chars (one in seven a homopolymer), each against N noisy copies
    of itself; with ``over_slope`` one template in four is 32 to 64 chars
    against reads of up to RL chars that repeat it (rl >> t_len).  With
    ``past_t`` every t_len is T + 1 to T + 8 (the template cut at T: no
    row ends it, and K3f's free-shift search walks all T rows); chars
    are bytes below ``codes`` (4: the codes 0..3; 256: any byte)."""
    import torch

    tpl = np.zeros((V, T), np.uint8)
    t_lens = np.zeros(V, np.int32)
    reads = np.zeros((V, N, RL), np.uint8)
    r_lens = np.zeros((V, N), np.int32)
    for v in range(V):
        short = over_slope and v % 4 == 3
        L = int(rng.integers(32, 65) if short else rng.integers(T // 2, T + 1))
        if past_t:
            L = T
        t = (np.full(L, v % codes, np.uint8) if v % 7 == 0
             else rng.integers(0, codes, L).astype(np.uint8))
        tpl[v, :L], t_lens[v] = t, L
        if past_t:
            t_lens[v] = T + 1 + int(rng.integers(0, 8))
        for n in range(N):
            r = np.concatenate([t] * (RL // L + 1))[: int(rng.integers(RL // 2, RL + 1))] \
                if short else t.copy()
            flip = rng.random(len(r)) < 0.1
            r[flip] = rng.integers(0, codes, int(flip.sum()))
            r = r[:RL]
            reads[v, n, : len(r)], r_lens[v, n] = r, len(r)
    return [torch.from_numpy(a).cuda() for a in (tpl, t_lens, reads, r_lens)]


def k3b_work(args, T: int, W: int) -> dict:
    """K3b's bound, from the cells each pair needs: on each of its
    min(t_len, T) template rows, the read columns 0..rl inside the row's
    W-cell band (offsets as ``consensus.py:2005-2007``); the inputs in,
    the distances out."""
    tpl, t_lens, reads, r_lens = args
    RL = reads.shape[2]
    tl = t_lens.cpu().numpy().astype(np.int64)[:, None, None]  # (V, 1, 1)
    rl = np.minimum(r_lens.cpu().numpy().astype(np.int64), RL)[..., None]
    i = np.arange(1, T + 1)  # (T,)
    c = (i * rl) // np.maximum(tl, 1)
    off = np.minimum(np.maximum(c - W // 2, -W // 2),
                     np.maximum(rl - W // 2, 0))
    per_row = np.minimum(off + W - 1, rl) - np.maximum(off, 0) + 1
    cells = int((np.clip(per_row, 0, None) * (i <= tl)).sum())
    return bound(nbytes(*args) + 4 * r_lens.numel(), OPS_PER_CELL["K3b"] * cells)


def k3f_work(args, T: int, global_ends: bool) -> dict:
    """K3f's bound, as K3's: ``K3_OPS_PER_WORD32`` operations per word row
    the answers depend on.  Global: min(t_len, T) rows x ceil(rl / 32)
    a pair, none where t_len or rl is out of range or rl = 0.
    Free-shift: none where JAX's recurrence fixes the answer
    (1 <= t_len <= T and rl >= 0: 0; see ``csrc/nw_dist.cu``); T rows x
    ceil(rl / 32), and ``K3F_OPS_PER_SEARCH_ROW`` a row, for t_len > T
    and 1 <= rl <= RL.  Bytes: the lengths in and the distances out for
    every pair, and the bytes the walked rows read: the template's rows
    (once for its N pairs) and the read's rl bytes."""
    tpl, t_lens, reads, r_lens = args
    RL = reads.shape[2]
    tl = t_lens.cpu().numpy().astype(np.int64)[:, None]  # (V, 1)
    rl = r_lens.cpu().numpy().astype(np.int64)
    words = (rl + 31) // 32
    if global_ends:
        rows = np.where((tl >= 1) & (tl <= T) & (rl >= 1) & (rl <= RL), tl, 0)
        ops = K3_OPS_PER_WORD32 * rows * words
    else:
        rows = np.where((tl > T) & (rl >= 1) & (rl <= RL), T, 0)
        ops = (K3_OPS_PER_WORD32 * words + K3F_OPS_PER_SEARCH_ROW) * rows
    walked = rows > 0
    moved = (nbytes(t_lens, r_lens) + 4 * r_lens.numel()
             + int(rows.max(axis=1).sum()) + int(rl[walked].sum()))
    return {**bound(moved, int(ops.sum())),
            "word_rows": int((rows * words).sum()), "bytes": moved}


def k3_counts(meta, TW: int, RW: int) -> dict:
    """What K3's inputs need: live candidates (a base window), filled
    read slots (rl > 0), and over both halves and the filled slots, the
    DP cells min(tl, TW) x (rl + 1) and the word rows min(tl, TW) x
    ceil(rl / 32), on 32-bit words (a half runs no row where tl <= 0 or
    tl > TW, a slot none where rl <= 0 or rl > RW); and the counts of
    the live candidates' base lengths (0 .. TW + 1, longer ones at
    TW + 1) and of the filled slots' lengths (0 .. RW + 1)."""
    import torch

    tl = meta[:, :2].long()
    rl = meta[:, 2:].long()
    rows = torch.where((tl >= 1) & (tl <= TW), tl, 0).sum(1, keepdim=True)
    r = torch.where((rl >= 1) & (rl <= RW), rl, 0)
    base = tl[:, 0][tl[:, 0] > 0].clamp(max=TW + 1)
    return {"live": int((tl[:, 0] > 0).sum()), "filled": int((rl > 0).sum()),
            "cells": int((rows * (r + 1) * (r > 0)).sum()),
            "word_rows": int((rows * ((r + 31) // 32)).sum()),
            "tl_hist": torch.bincount(base, minlength=TW + 2).cpu().numpy(),
            "rl_hist": torch.bincount(rl[rl > 0].clamp(max=RW + 1),
                                      minlength=RW + 2).cpu().numpy()}


def k3_work(rows, meta, TW: int, RW: int) -> dict:
    """K3's and K3p's bound: the rows (packed or not) and meta in, the
    (2, V, NB) distances out; ``K3_OPS_PER_WORD32`` operations per word
    row of :func:`k3_counts`, whose cell count rides along for the cell
    rate."""
    counts = k3_counts(meta, TW, RW)
    out_b = 2 * meta.shape[0] * (meta.shape[1] - 2) * 4
    return {**bound(nbytes(rows, meta) + out_b,
                    K3_OPS_PER_WORD32 * counts["word_rows"]),
            "cells": counts["cells"]}


def hold_k3(what: str, b, p, m, TW: int, TWp: int, RW: int, NB: int) -> dict:
    """K3 on the rows ``b`` and K3p on their packing ``p``, each against
    its plain version (tolerance 0) and against each other, with its
    time through the wrapper (``hold``, launches back to back, as every
    kernel is timed), its device time with the launches queued
    (:func:`cuda_ms_queued`: the kernel is shorter than a launch through
    the wrapper), each one's ratio to the bound, and its DP cells a
    second of device time; K3p's stats."""
    from dentist_tpu_torch.ops import nw_dist

    stats = []
    for mode, rows, kernel, plain in (
            ("K3 nw_dist", b, nw_dist.nw_dist_pairs,
             nw_dist.nw_dist_pairs_reference),
            ("K3p nw_dist_packed", p, nw_dist.nw_dist_pairs_packed,
             nw_dist.nw_dist_pairs_packed_reference)):
        work = k3_work(rows, m, TW, RW)
        call = lambda: kernel(rows, m, TW, TWp, RW, NB)
        st = hold(f"{mode} {what}", call,
                  lambda: plain(rows, m, TW, TWp, RW, NB), 20, work)
        st["device_ms"] = cuda_ms_queued(call, 20)
        log(f"  {st['ms'] / st['bound_ms']:.1f}x the bound through the "
            f"wrapper; device {st['device_ms']:.4f} ms (launches queued), "
            f"{st['device_ms'] / st['bound_ms']:.1f}x the bound, "
            f"{work['cells'] / st['device_ms'] / 1e6:.1f} G cells/s")
        stats.append(st)
    if max_abs_err(stats[1]["out"], stats[0]["out"]):
        fail(f"K3p != K3 on the same rows at {what}")
    return stats[1]


def k3_case(rng, V: int, NB: int, TW: int, TWp: int, RW: int, live: int,
            per: int, tl_hist, rl_hist):
    """K3 rows at one of the main path's launch shapes: ``live``
    candidates, each a base window of a length drawn from ``tl_hist``
    (:func:`k3_counts`) and an edited window one deletion, insertion or
    substitution away, and ``per`` read slots each, holding noisy copies
    of the window (``sim.reads._mutate``: 13 % error, the simulator's
    mix, continued periodically past the window's end) cut to lengths
    drawn from ``rl_hist`` (a length over RW keeps RW chars and, as on
    the main path, scores INF); then padding.  Returns the rows, their
    packing and the meta on the card."""
    import torch

    from dentist_tpu_torch.ops.pack2 import pack2bit
    from dentist_tpu_torch.sim.reads import _mutate

    buf = np.zeros((V, 2 * TWp + NB * RW), np.uint8)
    meta = np.zeros((V, 2 + NB), np.int32)
    wls = rng.choice(TW + 2, live, p=tl_hist / tl_hist.sum()).clip(1, TW)
    rls = rng.choice(RW + 2, (live, per), p=rl_hist / rl_hist.sum())
    for v, wl in enumerate(wls):
        w = rng.integers(0, 4, wl).astype(np.uint8)
        d = wl // 2
        e = (np.delete(w, d), np.insert(w, d, rng.integers(0, 4)),
             np.where(np.arange(wl) == d, (w + 1) % 4, w).astype(np.uint8))[v % 3][:TWp]
        buf[v, :wl] = w
        buf[v, TWp : TWp + len(e)] = e
        meta[v, :2] = wl, len(e)
        for nb, rl in enumerate(rls[v]):
            r = np.resize(_mutate(np.resize(w, rl + 8), rng, 0.13), min(rl, RW))
            buf[v, 2 * TWp + nb * RW : 2 * TWp + nb * RW + len(r)] = r
            meta[v, 2 + nb] = rl
    return (torch.from_numpy(buf).cuda(), torch.from_numpy(pack2bit(buf)).cuda(),
            torch.from_numpy(meta).cuda())


def hold_k3f(what: str, args, T: int, ends: bool, nw_dist_old) -> dict:
    """K3f on ``args`` against its plain version (tolerance 0), with its
    time through the wrapper, its device time with the launches queued,
    its bound (:func:`k3f_work`) and both ratios, and the pairs that walk
    rows; with ``nw_dist_old``, the other version's K3f checked equal and
    timed beside it, in turns, by device time."""
    import torch

    from dentist_tpu_torch.ops import nw_dist

    V, N, RL = args[2].shape
    work = k3f_work(args, T, ends)
    kernel = lambda: nw_dist.nw_dist_full(*args, T=T, global_ends=ends)
    st = hold(f"K3f nw_dist_full {what} T={T} RL={RL} global_ends={ends}",
              kernel, lambda: nw_dist.nw_dist_full_reference(*args, T, ends),
              10, work)
    dev = cuda_ms_queued(kernel, 20)
    log(f"  {work['word_rows']} word rows, {work['bytes']} bytes; "
        f"{int((args[2] >= 4).sum())} read "
        f"bytes >= 4; {st['ms'] / st['bound_ms']:.1f}x the bound through the "
        f"wrapper; device {dev:.4f} ms (launches queued), "
        f"{dev / st['bound_ms']:.1f}x the bound")
    if nw_dist_old:
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(st["out"])
        old = lambda: nw_dist_old["dentist_nw_dist_full"](
            *(a.data_ptr() for a in args), out.data_ptr(), V, N, T, RL,
            int(ends), stream)
        old()
        torch.cuda.synchronize()
        if max_abs_err(out, st["out"]):
            fail(f"K3f baseline != kernel at {what} global_ends={ends}")
        log("  K3f baseline equal to the kernel")
        turns(f"K3f {what} global_ends={ends} (device time, launches queued):",
              kernel, old, 20, cuda_ms_queued)
    return st


def phase_kernels(nw_dist_old=None):
    """Phase 3 at fixed shapes; with ``nw_dist_old`` (:func:`build_baselines`'
    ``nw_dist.cu``), the other version's K3b and K3f checked equal and
    timed beside this one's at each of their cases, in turns, by device
    time."""
    import torch

    from dentist_tpu_torch import _build
    from dentist_tpu_torch.ops import banded, nw_dist, nw_round, round_pack
    from dentist_tpu_torch.ops.pack2 import pack2bit

    rng = np.random.default_rng(2024)
    store = banded.device_store()
    rows = []

    # K2 and K2p, a windowed round and a full round; K4w and K4 pack
    # K2p's fields (K4 also at the 4 kb template bucket).  The main path
    # runs K2p on full rounds, so the full round is K2p's last case
    k4s, k4d, k4ws, k4wd = {}, {}, {}, {}
    for T, RL, N, lead_free, window in ((192, 384, 2048, 16, True),
                                        (512, 1024, 32, -1, False),
                                        (4096, 8192, 512, -1, False)):
        NWIN = -(-T // 126)
        kw = dict(T=T, W=128, S=T + RL, NWIN=NWIN, lead_free=lead_free)
        args = nw_lanes(rng, T, RL, N, window)
        chars, meta = k2p_pack(args, window)
        work = k2_work(args[1], T, 128, NWIN, nbytes(chars, meta))
        if T <= 512 or window:  # the unpacked K2 and K2p's plain version
            st = hold(f"K2 nw_round T={T} RL={RL} N={N}",
                      lambda: nw_round.nw_round(*args, **kw),
                      lambda: nw_round.nw_round_reference(*args, **kw), 3,
                      k2_work(args[1], T, 128, NWIN, nbytes(*args)))
            log(f"  {int(st['out'][6].sum())}/{N} lanes covered")
            unpacked = st["out"]
            st = hold(f"K2p nw_round_packed T={T} RL={RL} N={N}",
                      lambda: nw_round.nw_round_packed(chars, meta, RL=RL, **kw),
                      lambda: nw_round.nw_round_packed_reference(
                          chars, meta, RL=RL, **kw), 3, work)
            if max_abs_err(st["out"], unpacked):
                fail(f"K2p != K2 on the same lanes at T={T} N={N}")
        cen = torch.empty((N, T + 1), dtype=torch.int32, device="cuda")
        fields = nw_round.nw_round_packed(chars, meta, RL=RL, centers_out=cen,
                                          **kw)
        if window:
            for sparse in (True, False):
                words = 42 if sparse else 112
                st = hold(f"K4w window_pack sparse={sparse} N={N}",
                          lambda: round_pack.window_pack(
                              chars, meta, fields[:3], cen, sparse, False),
                          lambda: round_pack.window_pack_reference(
                              chars, meta, fields[:3], cen, sparse, False), 10,
                          k4_work(N, 126, 0, N * (32 if sparse else 4 * 127),
                                  words))
                if sparse:
                    k4ws = merge(k4ws, st)
                else:
                    k4wd = merge(k4wd, st)
            continue
        for sparse in (True, False):
            words = (round_pack.sparse_words(T, NWIN) if sparse
                     else round_pack.dense_words(T, NWIN))
            st = hold(f"K4 round_pack T={T} N={N} sparse={sparse}",
                      lambda: round_pack.round_pack(chars, fields, cen, T, RL,
                                                    NWIN, sparse),
                      lambda: round_pack.round_pack_reference(
                          chars, fields, cen, T, RL, NWIN, sparse), 10,
                      k4_work(N, T, NWIN, N * (T // 4 if sparse else 4 * (T + 1)),
                              words))
            ovf = int(st["out"][:, words - NWIN - 1].sum()) if sparse else 0
            log(f"  {ovf}/{N} lanes over the sparse caps" if sparse else
                "  dense block")
            if sparse:
                k4s = merge(k4s, st)
            else:
                k4d = merge(k4d, st)

    # the resident K4w on K2r's fields: windowed lanes in the device store
    # (K2r itself is held after phase 5, at the main path's buckets)
    N, T, RL = 2048, 192, 384
    meta = resident_case(store, rng, N)
    kw = dict(T=T, RL=RL, W=128, S=T + RL, NWIN=2, lead_free=16)
    cen = torch.empty((N, T + 1), dtype=torch.int32, device="cuda")
    fields = nw_round.nw_round_resident(store.array, meta, centers_out=cen, **kw)
    for sparse in (True, False):
        st = hold(f"K4w window_pack resident sparse={sparse} N={N}",
                  lambda: round_pack.window_pack(store.array, meta, fields[:3],
                                                 cen, sparse, True),
                  lambda: round_pack.window_pack_reference(
                      store.array, meta, fields[:3], cen, sparse, True), 10,
                  k4_work(N, 126, 0, N * (126 if sparse else 4 * 127),
                          42 if sparse else 112))
        if sparse:
            k4ws = merge(k4ws, st)
        else:
            k4wd = merge(k4wd, st)

    # K5: one 4 Mi-char chunk of a store upload
    n = banded._ARENA_CHUNK
    packed = torch.from_numpy(rng.integers(0, 256, n // 4).astype(np.uint8)).cuda()
    dst_k = torch.zeros(2 * n, dtype=torch.uint8, device="cuda")
    dst_p = torch.zeros(2 * n, dtype=torch.uint8, device="cuda")

    def k5_kernel():
        banded.store_write(packed, dst_k, 4096)
        return dst_k

    def k5_plain():
        banded.store_write_reference(packed, dst_p, 4096)
        return dst_p

    k5 = hold(f"K5 store_write n={n}", k5_kernel, k5_plain, 10,
              bound(n // 4 + n, OPS_PER_CELL["K5"] * n))
    k5_dev = cuda_ms_queued(k5_kernel, 20)
    log(f"  device {k5_dev:.4f} ms (launches queued), "
        f"{k5_dev / k5['bound_ms']:.2f}x the bound")

    k4_fixed = {"K4": k4s, "K4dense": k4d, "K4w": k4ws, "K4wdense": k4wd}

    # K3 and K3p: the polish scorer at V = 256 candidates (and after
    # phase 5 at the main path's buckets, phase_k3)
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
        p = torch.from_numpy(pack2bit(buf)).cuda()
        hold_k3(f"V={V} NB={NB}", b, p, m, TW, TWp, RW, NB)

    # K3f and K3b, the scorer modes no path runs: K3f at K3's shapes,
    # K3b at a full consensus round's template and read widths
    reset_launch_counts()
    k3f, k3b = {}, {}
    T, RL, V = 34, 48, 256
    cases = []
    for N in (8, 32):  # one draw a shape, both end modes on it
        args = scorer_case(rng, V, N, T, RL, False)
        cases += [(f"V={V} N={N}", args, T, ends) for ends in (False, True)]
    T, RL, V, N = 512, 640, 64, 32
    args = scorer_case(rng, V, N, T, RL, True)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for W in (64, 65):
        for ends in (False, True):
            kernel = lambda: nw_dist.banded_nw_dist(*args, T=T, W=W,
                                                    global_ends=ends)
            st = hold(f"K3b banded_nw_dist V={V} N={N} T={T} RL={RL} W={W} "
                      f"global_ends={ends}", kernel,
                      lambda: nw_dist.banded_nw_dist_reference(*args, T, W, ends),
                      3, k3b_work(args, T, W))
            log(f"  {int((st['out'] < nw_dist.INF).sum())}/{V * N} pairs "
                f"within the band")
            dev = cuda_ms_queued(kernel, 5)
            log(f"  {st['ms'] / st['bound_ms']:.1f}x the bound through the "
                f"wrapper; device {dev:.4f} ms (launches queued), "
                f"{dev / st['bound_ms']:.1f}x the bound")
            k3b = merge(k3b, st)
            if nw_dist_old:
                out = torch.empty_like(st["out"])
                old = lambda: nw_dist_old["dentist_banded_nw_dist"](
                    *(a.data_ptr() for a in args), out.data_ptr(), V, N, T,
                    RL, W, int(ends), stream())
                old()
                torch.cuda.synchronize()
                if max_abs_err(out, st["out"]):
                    fail(f"K3b baseline != kernel at W={W} global_ends={ends}")
                log("  K3b baseline equal to the kernel")
                turns(f"K3b W={W} global_ends={ends} (device time, launches "
                      f"queued):", kernel, old, 5, cuda_ms_queued)
    # K3f beyond K3's shapes: the free-shift search on every pair (each
    # t_len past T), bytes of any value (the eight-plane compare), and the
    # card full (V = 4096)
    rng_f = np.random.default_rng(2027)
    T, RL = 34, 48
    cases += [("V=256 N=32 t_len>T", scorer_case(rng_f, 256, 32, T, RL, False,
                                                 past_t=True), T, False)]
    args = scorer_case(rng_f, 256, 32, T, RL, False, codes=256)
    cases += [("V=256 N=32 bytes", args, T, ends) for ends in (False, True)]
    cases += [("V=4096 N=32", scorer_case(rng_f, 4096, 32, T, RL, False), T,
               True)]
    for line in ptxas_lines(_build.build_log):
        if "nw_dist_full_kernel" in line:
            log(f"  K3f ptxas: {line}")
    for what, args, T, ends in cases:
        k3f = merge(k3f, hold_k3f(what, args, T, ends, nw_dist_old))
    if not nw_dist_old:
        log("  no nw_dist.cu in --baseline: no other K3b or K3f version timed")
    phase3 = launch_counts()
    rows.append(("K3f nw_dist_full", "dentist_tpu_torch/csrc/nw_dist.cu",
                 "dentist_tpu/ops/consensus.py:1936", "phase3", "K3f", k3f))
    rows.append(("K3b banded_nw_dist", "dentist_tpu_torch/csrc/nw_dist.cu",
                 "dentist_tpu/ops/consensus.py:1991", "phase3", "K3b", k3b))
    return rows, phase3, k4_fixed


#: the K1 shapes whose parent kernel ``--baseline-extend`` times, and
#: where phase 3 also holds lanes with diagonal bounds
K1_LEGACY = ((1512, 128), (13608, 1024))


#: the C entry points of each kernel source a ``--baseline`` directory may
#: hold: (pointers, ints) before the stream argument
BASELINE_ENTRIES = {
    "extend.cu": {"dentist_extend": (4, 5), "dentist_extend_packed": (4, 4)},
    "nw_round.cu": {"dentist_nw_round": (13, 8),
                    "dentist_nw_round_packed": (11, 8),
                    "dentist_nw_round_resident": (11, 9)},
    "nw_dist.cu": {"dentist_nw_dist": (3, 5), "dentist_nw_dist_packed": (3, 5),
                   "dentist_nw_dist_full": (5, 5),
                   "dentist_banded_nw_dist": (5, 6)},
    "round_pack.cu": {"dentist_round_pack": (10, 6),
                      "dentist_window_pack": (7, 6)},
    "store_write.cu": {"dentist_store_write": (2, 2)},
}


def build_baselines(path) -> dict:
    """The kernels of another version: each source of ``BASELINE_ENTRIES``
    that the directory ``path`` holds (with its ``pack2.cuh`` beside
    them), built with the package's flags into a temporary directory,
    one ``nvcc`` per source, all started together; returns {source:
    {entry point: function}}, empty without ``path``."""
    import ctypes
    import shutil

    from dentist_tpu_torch import _build

    if not path:
        return {}
    srcs = [f for f in BASELINE_ENTRIES if os.path.exists(os.path.join(path, f))]
    if not srcs:
        fail(f"--baseline {path} holds none of {', '.join(BASELINE_ENTRIES)}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_baseline_")
    try:
        sos = {f: os.path.join(tmp, f"lib{f[:-3]}.so") for f in srcs}
        procs = {f: subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-o", sos[f],
             os.path.join(path, f)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for f in srcs}
        libs = {}
        for f, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                fail(f"baseline {f} did not build:\n{out}")
            for line in ptxas_lines(out):
                log(f"  baseline {f}: {line}")
            libs[f] = ctypes.CDLL(sos[f])
    finally:
        shutil.rmtree(tmp)
    fns = {}
    for f, lib in libs.items():
        fns[f] = {}
        for name, (n_ptr, n_int) in BASELINE_ENTRIES[f].items():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[f][name] = fn
    log(f"baseline {path}: built {', '.join(srcs)}")
    return fns


def phase_k1(buckets: dict, baseline) -> list:
    """Phase 3 for K1 and K1p, after phase 5: each against its plain
    version at every (R, N) bucket pair the main path launched (and at
    ``K1_LEGACY``), with its time, bound and their ratio; with
    ``baseline`` (:func:`build_baselines`' ``extend.cu``), the other version's kernel
    timed beside this one at ``K1_LEGACY`` on the same inputs, in turns
    (baseline, kernel, kernel, baseline)."""
    import torch

    from dentist_tpu_torch.ops import banded

    rng = np.random.default_rng(2024)
    store = banded.device_store()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    shapes = sorted(set(buckets) | set(K1_LEGACY), key=lambda rn: rn[0] * rn[1])
    k1, k1p = {}, {}
    for R, N in shapes:
        BW = banded.bw_for(R, 256)
        for bounded in ((False, True) if (R, N) in K1_LEGACY else (False,)):
            meta, num_k = k1_case(store, rng, R, N, bounded)
            nd = torch.from_numpy(num_k).cuda()
            kernel = lambda: banded.extend(store.array, meta, num_k, R=R, W=256)
            st = hold(f"K1 extend R={R} N={N} diag_bounds={bounded}", kernel,
                      lambda: banded.extend_reference(store.array, meta, num_k,
                                                      R=R, W=256), 3,
                      k1_work(meta, R, 256, False))
            log(f"  {int((st['out'][3] > 0).sum())}/{N} lanes aligned; "
                f"{st['ms'] / st['bound_ms']:.2f}x the bound")
            k1 = merge(k1, st)
            if baseline and not bounded and (R, N) in K1_LEGACY:
                out = torch.empty_like(st["out"])
                old = lambda: baseline["dentist_extend"](
                    store.array.data_ptr(), meta.data_ptr(), nd.data_ptr(),
                    out.data_ptr(), store.array.numel(), N, R, 256, BW, stream())
                compare("K1", R, N, kernel, old, out, st)
            chars, meta5, num_k = k1p_case(rng, R, N, bounded)
            nd = torch.from_numpy(num_k).cuda()
            kernel = lambda: banded.extend_packed(chars, meta5, num_k, R=R, W=256)
            st = hold(f"K1p extend_packed R={R} N={N} diag_bounds={bounded}",
                      kernel,
                      lambda: banded.extend_packed_reference(chars, meta5, num_k,
                                                             R=R, W=256), 3,
                      k1_work(meta5, R, 256, True))
            log(f"  {int((st['out'][3] > 0).sum())}/{N} lanes aligned; "
                f"{st['ms'] / st['bound_ms']:.2f}x the bound")
            k1p = merge(k1p, st)
            if baseline and not bounded and (R, N) in K1_LEGACY:
                out = torch.empty_like(st["out"])
                old = lambda: baseline["dentist_extend_packed"](
                    chars.data_ptr(), meta5.data_ptr(), nd.data_ptr(),
                    out.data_ptr(), N, R, 256, BW, stream())
                compare("K1p", R, N, kernel, old, out, st)
    if not baseline:
        log("  no extend.cu in --baseline: no other K1 version timed")
    return [("K1 extend", "dentist_tpu_torch/csrc/extend.cu",
             "dentist_tpu/ops/banded.py:62", "main", "K1", k1),
            ("K1p extend_packed", "dentist_tpu_torch/csrc/extend.cu",
             "dentist_tpu/ops/banded.py:249", "host_windows", "K1p", k1p)]


def compare(what: str, R: int, N: int, kernel, old, out, st: dict) -> None:
    """The baseline kernel ``old`` (writing ``out``) against ``kernel`` on
    the same inputs: equal outputs, then both timed in turns."""
    import torch

    old()
    torch.cuda.synchronize()
    if max_abs_err(out, st["out"]):
        fail(f"{what} baseline != kernel at R={R} N={N}")
    ms = [cuda_ms(old, 3), cuda_ms(kernel, 3), cuda_ms(kernel, 3), cuda_ms(old, 3)]
    log(f"  {what} R={R} N={N} baseline, kernel, kernel, baseline ms: "
        f"{', '.join(f'{m:.3f}' for m in ms)}; equal outputs; kernel "
        f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x faster")


def k2_case(rng, T: int, RL: int, N: int, live: int, window: bool):
    """K2 lanes at one of the main path's launch shapes: ``live`` lanes of
    :func:`nw_lanes`, then padding lanes (a one-character template, no
    read) as the dispatches fill their lane buckets."""
    import torch

    tpl, t_lens, reads, r_lens, cen = nw_lanes(rng, T, RL, live, window)
    pad = N - live
    z = lambda *shape, dt=torch.int32: torch.zeros(shape, dtype=dt, device="cuda")
    return [torch.cat([tpl, z(T, pad, dt=torch.uint8)], 1).contiguous(),
            torch.cat([t_lens, z(pad) + 1]), torch.cat([reads, z(pad, RL, dt=torch.uint8)]),
            torch.cat([r_lens, z(pad)]), torch.cat([cen, z(T + 1, pad)], 1).contiguous()]


def k2_baseline_run(fn, src_args, T: int, RL: int, N: int, kw: dict, extra=()):
    """A call of another version's K2p or K2r entry point ``fn`` on the
    same inputs, with its own scratch (a W-byte move per cell) and
    outputs; returns (call, outputs)."""
    import torch

    W, NWIN = kw["W"], kw["NWIN"]
    e = lambda *shape, dt=torch.int32: torch.empty(shape, dtype=dt, device="cuda")
    cen, moves = e(N, T + 1), e(N, T, W, dt=torch.uint8)
    outs = (e(N, T, dt=torch.int8), e(N, T + 1, 4, dt=torch.int8), e(N, T + 1),
            e(N, 2), e(N), e(N, NWIN), e(N, dt=torch.bool))
    ptrs = [a.data_ptr() for a in (*src_args, cen, moves, *outs)]

    def call():
        fn(*ptrs, *extra, N, T, RL, W, kw["S"], NWIN, kw["lead_free"], 126,
           torch.cuda.current_stream().cuda_stream)
        return outs
    return call, outs


def turns(what: str, kernel, old, reps: int = 3, timer=cuda_ms) -> list:
    """``old`` and ``kernel`` timed in turns (old, kernel, kernel, old),
    each the mean of ``reps`` launches by ``timer``."""
    ms = [timer(old, reps), timer(kernel, reps), timer(kernel, reps),
          timer(old, reps)]
    log(f"  {what} baseline, kernel, kernel, baseline ms: "
        f"{', '.join(f'{m:.4f}' for m in ms)}; kernel "
        f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x faster")
    return ms


def phase_k2(k2_buckets: dict, baseline) -> list:
    """Phase 3 for K2, K2p and K2r, after phase 5: each against its plain
    version at every (T, RL, N) bucket of the main path's launches, with
    as many live lanes as the launches held on average, with its time,
    bound and their ratio.  K2p at the largest of them runs again with
    S = 0 (the forward scan alone) beside the full S (scan and
    traceback).  With ``baseline`` (:func:`build_baselines`'
    ``nw_round.cu``), the other
    version's K2p there and its K2r at the largest K2r bucket are checked
    equal and timed beside these, in turns."""
    import torch

    from dentist_tpu_torch.ops import banded, nw_round
    from dentist_tpu_torch.ops.round_pack import TB_nwin

    rng = np.random.default_rng(2025)
    store = banded.device_store()
    k2, k2p, k2r = {}, {}, {}
    largest = last_r = None
    ratio = lambda st: f"{st['ms'] / st['bound_ms']:.1f}x the bound"
    for (mode, T, RL, N), (count, live) in sorted(
            k2_buckets.items(), key=lambda kv: (kv[0][0], kv[0][1] * kv[0][3])):
        live = max(1, round(live / count))
        NWIN = max(TB_nwin(T), 1)
        if mode == "K2p":
            window = T == 192
            kw = dict(T=T, W=128, S=T + RL, NWIN=NWIN,
                      lead_free=16 if window else -1)
            args = k2_case(rng, T, RL, N, live, window)
            chars, meta = k2p_pack(args, window)
            st = hold(f"K2 nw_round T={T} RL={RL} N={N} live={live}",
                      lambda: nw_round.nw_round(*args, **kw),
                      lambda: nw_round.nw_round_reference(*args, **kw), 3,
                      k2_work(args[1], T, 128, NWIN, nbytes(*args)))
            log(f"  {int(st['out'][6].sum())}/{N} lanes covered; {ratio(st)}")
            k2, unpacked = merge(k2, st), st["out"]
            st = hold(f"K2p nw_round_packed T={T} RL={RL} N={N} live={live}",
                      lambda: nw_round.nw_round_packed(chars, meta, RL=RL, **kw),
                      lambda: nw_round.nw_round_packed_reference(
                          chars, meta, RL=RL, **kw), 3,
                      k2_work(args[1], T, 128, NWIN, nbytes(chars, meta)))
            log(f"  {ratio(st)}")
            if max_abs_err(st["out"], unpacked):
                fail(f"K2p != K2 on the same lanes at T={T} N={N}")
            k2p = merge(k2p, st)
            if largest is None or T * live > largest[0] * largest[3]:
                largest = (T, RL, N, live, chars, meta, kw, st)
        else:
            meta = resident_case(store, rng, N)
            meta[:, live:] = torch.tensor([1, 0, 0, 0, 0], dtype=torch.int32,
                                          device="cuda")[:, None]
            kw = dict(T=T, RL=RL, W=128, S=T + RL, NWIN=NWIN, lead_free=16)

            def k2r_plain(meta=meta, T=T, RL=RL, NWIN=NWIN):
                tpl, reads, tl, sl, c, _ = nw_round.window_resident_inputs(
                    store.array, meta, T, RL)
                return nw_round.nw_round_reference(tpl, tl, reads, sl, c, T,
                                                   128, T + RL, NWIN, 16)

            win_bytes = int(meta[0].sum() + meta[1].sum())
            st = hold(f"K2r nw_round_resident T={T} RL={RL} N={N} live={live}",
                      lambda: nw_round.nw_round_resident(store.array, meta, **kw),
                      k2r_plain, 3,
                      k2_work(meta[0], T, 128, NWIN, nbytes(meta) + win_bytes))
            log(f"  {ratio(st)}")
            k2r = merge(k2r, st)
            last_r = (T, RL, N, meta, kw, st)

    # the forward scan (S = 0) against scan and traceback, at the largest
    # K2p bucket (by live rows), in this version and the baseline's
    T, RL, N, live, chars, meta, kw, st = largest
    kernel = lambda S: (lambda: nw_round.nw_round_packed(chars, meta, RL=RL,
                                                         **dict(kw, S=S)))
    if baseline:
        old_full, outs = k2_baseline_run(baseline["dentist_nw_round_packed"],
                                         (chars, meta), T, RL, N, kw)
        old_full()
        torch.cuda.synchronize()
        if max_abs_err(outs, st["out"]):
            fail(f"K2p baseline != kernel at T={T} N={N}")
        old_s0, _ = k2_baseline_run(baseline["dentist_nw_round_packed"],
                                    (chars, meta), T, RL, N, dict(kw, S=0))
        for S, old in ((T + RL, old_full), (0, old_s0)):
            turns(f"K2p T={T} N={N} live={live} S={S}:", kernel(S), old)
        T, RL, N, meta, kw, st = last_r
        old, outs = k2_baseline_run(baseline["dentist_nw_round_resident"],
                                    (store.array, meta), T, RL, N, kw,
                                    (store.array.numel(),))
        old()
        torch.cuda.synchronize()
        if max_abs_err(outs, st["out"]):
            fail(f"K2r baseline != kernel at N={N}")
        turns(f"K2r T={T} N={N}:",
              lambda: nw_round.nw_round_resident(store.array, meta, **kw), old)
    else:
        ms = [cuda_ms(kernel(S), 3) for S in (T + RL, 0)]
        log(f"  K2p T={T} N={N} live={live}: S={T + RL} {ms[0]:.3f} ms, S=0 "
            f"{ms[1]:.3f} ms (traceback {ms[0] - ms[1]:.3f} ms); no "
            f"nw_round.cu in --baseline: no other K2 version timed")
    src = "dentist_tpu_torch/csrc/nw_round.cu"
    return [("K2p nw_round_packed", src, "dentist_tpu/ops/consensus.py:491",
             "main", "K2p", k2p),
            ("K2r nw_round_resident", src, "dentist_tpu/ops/consensus.py:945",
             "main", "K2r", k2r)]


def phase_k3(k3_buckets: dict, baseline) -> list:
    """Phase 3 for K3 and K3p, after phase 5: each against its plain
    version at every (V, NB) bucket of the main path's K3p launches, on
    inputs with as many live candidates and filled read slots as those
    launches held on average and lengths drawn from theirs
    (:func:`k3_case`), with its time, bound, their ratio and its cell
    rate.  Each case's word rows and cells must be within
    ``K3_CASE_MARGIN`` of the launches' average.  With ``baseline``
    (:func:`build_baselines`' ``nw_dist.cu``), the other version's K3 and K3p are checked
    equal to these at the largest bucket and at V = 256, NB = 8, and its
    K3p is timed beside this one's there, in turns, by device time
    (:func:`cuda_ms_queued`)."""
    import torch

    from dentist_tpu_torch.ops import nw_dist

    rng = np.random.default_rng(2026)
    k3p, cases = {}, {}
    for (V, NB, TW, TWp, RW), rec in sorted(
            k3_buckets.items(), key=lambda kv: kv[0][0] * kv[0][1]):
        n = rec["launches"]
        live = max(1, round(rec["live"] / n))
        per = min(NB, max(1, round(rec["filled"] / max(1, rec["live"]))))
        b, p, m = k3_case(rng, V, NB, TW, TWp, RW, live, per,
                          rec["tl_hist"], rec["rl_hist"])
        c = k3_counts(m, TW, RW)
        for name in ("word_rows", "cells"):
            want = rec[name] / n
            log(f"  K3 case V={V} NB={NB}: {c[name]} {name.replace('_', ' ')}, "
                f"{c[name] / want:.3f}x phase 5's {want:.0f} a launch")
            if abs(c[name] / want - 1) > K3_CASE_MARGIN:
                fail(f"K3 case V={V} NB={NB}: {name} {c[name]} not within "
                     f"{K3_CASE_MARGIN:.0%} of phase 5's {want:.0f}")
        st = hold_k3(f"V={V} NB={NB} live={c['live']} filled={c['filled']}",
                     b, p, m, TW, TWp, RW, NB)
        k3p = merge(k3p, st)
        cases[V, NB] = (b, p, m, TW, TWp, RW, st)
    if not baseline:
        log("  no nw_dist.cu in --baseline: no other K3 version timed")
        return [("K3p nw_dist_packed", "dentist_tpu_torch/csrc/nw_dist.cu",
                 "dentist_tpu/ops/consensus.py:2065", "main", "K3p", k3p)]
    if (256, 8) not in cases:  # the phase-3 shape, every slot filled
        rec = k3_buckets[max(k3_buckets, key=lambda k: k[0] * k[1])]
        b, p, m = k3_case(rng, 256, 8, 34, 36, 48, 256, 8, rec["tl_hist"],
                          rec["rl_hist"])
        cases[256, 8] = (b, p, m, 34, 36, 48,
                         hold_k3("V=256 NB=8", b, p, m, 34, 36, 48, 8))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for V, NB in sorted({max(cases, key=lambda k: k[0] * k[1]), (256, 8)},
                        key=lambda k: -k[0] * k[1]):
        b, p, m, TW, TWp, RW, st = cases[V, NB]
        calls = {}
        for name, rows in (("dentist_nw_dist", b), ("dentist_nw_dist_packed", p)):
            out = torch.empty((2, V, NB), dtype=torch.int32, device="cuda")
            calls[name] = (lambda fn=baseline[name], rows=rows, out=out: fn(
                rows.data_ptr(), m.data_ptr(), out.data_ptr(), V, TW, TWp, RW,
                NB, stream()))
            calls[name]()
            torch.cuda.synchronize()
            if max_abs_err(out, st["out"]):
                fail(f"{name} baseline != kernel at V={V} NB={NB}")
        log(f"  K3 and K3p baseline equal to the kernel at V={V} NB={NB}")
        turns(f"K3p V={V} NB={NB} (device time, launches queued):",
              lambda: nw_dist.nw_dist_pairs_packed(p, m, TW, TWp, RW, NB),
              calls["dentist_nw_dist_packed"], 20, cuda_ms_queued)
    return [("K3p nw_dist_packed", "dentist_tpu_torch/csrc/nw_dist.cu",
             "dentist_tpu/ops/consensus.py:2065", "main", "K3p", k3p)]


def k4_what(key) -> str:
    """A K4 or K4w bucket (mode, T, N, sparse, resident) in words."""
    mode, T, N, sparse, resident = key
    kind = "sparse" if sparse else "dense"
    if mode == "K4w":
        kind += " resident" if resident else " host windows"
    return f"{mode} {kind} (T={T}, N={N})"


#: the ``kernels`` line's K4 and K4w rows: (name, replaces, run, mode),
#: each taking its largest main-path bucket (by T x N) from phase_k4
K4_ROWS = (("K4 round_pack sparse", "dentist_tpu/ops/consensus.py:397", "main", "K4"),
           ("K4 round_pack dense", "dentist_tpu/ops/consensus.py:318", "dense", "K4dense"),
           ("K4w window_pack sparse", "dentist_tpu/ops/consensus.py:1023", "main", "K4w"),
           ("K4w window_pack dense", "dentist_tpu/ops/consensus.py:914", "dense", "K4wdense"))


def phase_k4(k4_buckets: dict, baseline, fixed: dict) -> list:
    """Phase 3 for K4 and K4w, after phase 5: at every bucket the main path
    launched them at, on the first such launch's own inputs (cloned in
    phase 5), each against its plain version (tolerance 0), with its time
    through the wrapper (back to back, as every kernel is timed), its
    device time with the launches queued (:func:`cuda_ms_queued`), its
    bound and both ratios.  With ``baseline`` (:func:`build_baselines`'
    ``round_pack.cu``), the other version's kernel is checked equal word
    for word and timed beside this one in turns, by device time.  Each
    mode's row takes its largest bucket; a mode that phase 5 did not
    launch keeps phase 3's fixed cases (``fixed``)."""
    import torch

    from dentist_tpu_torch.ops import round_pack as RP

    stream = lambda: torch.cuda.current_stream().cuda_stream
    best = {}
    for key in sorted(k4_buckets):
        mode, T, N, sparse, resident = key
        rec = k4_buckets[key]
        if mode == "K4":
            chars, fields, cen, RL, NWIN = rec["inputs"]
            words = RP.sparse_words(T, NWIN) if sparse else RP.dense_words(T, NWIN)
            kernel = lambda: RP.round_pack(chars, fields, cen, T, RL, NWIN, sparse)
            plain = lambda: RP.round_pack_reference(chars, fields, cen, T, RL,
                                                    NWIN, sparse)
            work = k4_work(N, T, NWIN, N * (T // 4 if sparse else 4 * (T + 1)),
                           words)
            old = lambda out: baseline["dentist_round_pack"](
                chars.data_ptr(), *(f.data_ptr() for f in fields), cen.data_ptr(),
                out.data_ptr(), N, T, RL, NWIN, words, int(sparse), stream())
        else:
            tsrc, meta, fields, cen = rec["inputs"]
            words = 42 if sparse else 112
            kernel = lambda: RP.window_pack(tsrc, meta, fields, cen, sparse,
                                            resident)
            plain = lambda: RP.window_pack_reference(tsrc, meta, fields, cen,
                                                     sparse, resident)
            work = k4_work(N, 126, 0, N * ((126 if resident else 32) if sparse
                                           else 4 * 127), words)
            old = lambda out: baseline["dentist_window_pack"](
                tsrc.data_ptr(), meta.data_ptr(), *(f.data_ptr() for f in fields),
                cen.data_ptr(), out.data_ptr(), int(resident), int(sparse),
                tsrc.numel() if resident else 0, N, T, 384, stream())
        what = (f"{k4_what(key)}, {rec['launches']} launches with "
                f"{rec['live'] / rec['launches']:.0f} live lanes a launch")
        st = hold(what, kernel, plain, 20, work)
        st["device_ms"] = cuda_ms_queued(kernel, 20)
        log(f"  device {st['device_ms']:.4f} ms (launches queued), "
            f"{st['device_ms'] / st['bound_ms']:.1f}x the bound; through the "
            f"wrapper {st['ms'] / st['bound_ms']:.1f}x")
        if baseline:
            out = torch.empty_like(st["out"])
            status = []
            parent = lambda: status.append(old(out))
            parent()
            torch.cuda.synchronize()
            if any(status) or max_abs_err(out, st["out"]):
                fail(f"{k4_what(key)}: the baseline's block != the kernel's "
                     f"(status {set(status)})")
            log("  the baseline's block equal to the kernel's, word for word")
            turns(f"{k4_what(key)} (device time, launches queued):", kernel,
                  parent, 20, cuda_ms_queued)
            if any(status):
                fail(f"{k4_what(key)}: a baseline launch failed")
        row = mode + ("" if sparse else "dense")
        if row not in best or T * N > best[row][0]:
            best[row] = (T * N, st)
    if not baseline:
        log("  no round_pack.cu in --baseline: no other K4 version timed")
    for _, _, _, row in K4_ROWS:
        if row not in best:
            log(f"  {row}: not launched in phase 5; its row keeps phase 3's cases")
    return [(name, "dentist_tpu_torch/csrc/round_pack.cu", rep, run, row,
             best[row][1] if row in best else fixed[row])
            for name, rep, run, row in K4_ROWS]


# ----------------------------------------------------------------------
# phases 4 and 5: the main path


def phase_k5(uploads: list, baseline) -> list:
    """Phase 3 for K5, after phase 5: one upload of each size phase 5 made
    (its characters, at a 16-byte aligned offset as the main path's
    are), and the largest again at an unaligned offset, against the
    plain version (tolerance 0), with the bytes it moves, its bound, its
    device time (launches queued) and their ratio.  With ``baseline``
    (:func:`build_baselines`' ``store_write.cu``), the other version's K5
    is checked equal on the same upload, in one launch, and timed beside
    this one's, in turns, by device time."""
    import torch

    from dentist_tpu_torch.ops import banded

    if not uploads:
        fail("phase 5 made no K5 upload")
    sizes = sorted({n for n, _ in uploads})
    rng = np.random.default_rng(2028)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    k5 = {}
    for n, off in [(n, 4096) for n in sizes] + [(sizes[-1], 4096 + 3)]:
        packed = torch.from_numpy(rng.integers(0, 256, n // 4).astype(np.uint8)).cuda()
        dst_k = torch.zeros(off + n + 16, dtype=torch.uint8, device="cuda")
        dst_p = torch.zeros_like(dst_k)

        def kernel():
            banded.store_write(packed, dst_k, off)
            return dst_k

        def plain():
            banded.store_write_reference(packed, dst_p, off)
            return dst_p

        st = hold(f"K5 store_write n={n} off % 16 = {off % 16}", kernel, plain,
                  20, bound(n // 4 + n, OPS_PER_CELL["K5"] * n))
        dev = cuda_ms_queued(kernel, 20)
        log(f"  {n // 4 + n} bytes; device {dev:.4f} ms (launches queued), "
            f"{dev / st['bound_ms']:.2f}x the bound; through the wrapper "
            f"{st['ms'] / st['bound_ms']:.1f}x")
        if off % 16:
            k5["err"] = max(k5["err"], st["err"])
            continue
        k5 = merge(k5, st)
        if baseline:
            out = torch.zeros_like(dst_k)
            old = lambda: baseline["dentist_store_write"](
                packed.data_ptr(), out.data_ptr(), off, n, stream())
            old()
            torch.cuda.synchronize()
            if max_abs_err(out, dst_k):
                fail(f"K5 baseline != kernel at n={n}")
            turns(f"K5 n={n}, one launch each (device time, launches queued):",
                  kernel, old, 20, cuda_ms_queued)
    if not baseline:
        log("  no store_write.cu in --baseline: no other K5 version timed")
    return [("K5 store_write", "dentist_tpu_torch/csrc/store_write.cu",
             "dentist_tpu/ops/banded.py:448", "main", "K5", k5)]


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

    from dentist_tpu_torch.ops import banded, consensus
    from dentist_tpu_torch.pipeline import STAGE_SECONDS, reset_stage_seconds
    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             phase_a_scenario, write_scenario)

    d = os.path.join(tmp, "phase_a")
    sc = phase_a_scenario()
    asm, reads = write_scenario(sc, d)
    reset_stage_seconds()
    torch.cuda.reset_peak_memory_stats()
    shapes = []  # (R, N, a_len row) of each K1 launch
    extend = banded.extend

    def recorded(store, meta12, num_k, R, W=256):
        shapes.append((R, meta12.shape[1], meta12[2].clone()))
        return extend(store, meta12, num_k, R, W)

    # each K2p and K2r launch's (T, RL, N, live lanes: a template and a
    # read), through wrappers around the names consensus calls them by;
    # a thread's last live count goes to the K4 or K4w launch that packs
    # the round's fields (the same thread, next)
    k2_shapes = []
    tls = threading.local()

    def k2_recorder(mode, fn):
        def recorded_k2(src, meta, **kw):
            live = int(((meta[0] > 0) & (meta[1] > 0)).sum())
            k2_shapes.append((mode, kw["T"], kw["RL"], meta.shape[1], live))
            tls.live = live
            return fn(src, meta, **kw)
        return recorded_k2

    # each K4 and K4w launch's bucket (mode, T, N, sparse, resident) and
    # live lanes, and the first launch of each bucket's inputs, cloned
    # (a resident launch's template windows are cut from the store into
    # a store of their own, their offsets moved with them)
    k4_shapes, k4_inputs = [], {}
    k4_lock = threading.Lock()
    k4_fns = (consensus.round_pack, consensus.window_pack)

    def k4_record(key, inputs):
        with k4_lock:
            k4_shapes.append((key, getattr(tls, "live", 0)))
            if key not in k4_inputs:
                k4_inputs[key] = inputs()

    def recorded_k4(chars, fields, centers, T, RL, NWIN, sparse):
        k4_record(("K4", T, fields[0].shape[0], bool(sparse), False),
                  lambda: (chars.clone(), tuple(f.clone() for f in fields),
                           centers.clone(), RL, NWIN))
        return k4_fns[0](chars, fields, centers, T, RL, NWIN, sparse=sparse)

    def recorded_k4w(tsrc, meta, fields, centers, sparse, resident):
        def inputs():
            if not resident:
                return tsrc.clone(), meta.clone(), tuple(f.clone() for f in fields), centers.clone()
            N, T = meta.shape[1], fields[0].shape[1]
            start = meta[3].long().clamp(0, tsrc.numel() - T)
            store = tsrc[start[:, None] + torch.arange(T, device=tsrc.device)]
            moved = meta.clone()
            moved[3] = torch.arange(N, dtype=torch.int32, device=meta.device) * T
            return (store.reshape(-1).contiguous(), moved,
                    tuple(f.clone() for f in fields), centers.clone())
        k4_record(("K4w", fields[0].shape[1], fields[0].shape[0], bool(sparse),
                   bool(resident)), inputs)
        return k4_fns[1](tsrc, meta, fields, centers, sparse, resident=resident)

    # each K5 upload's characters and store offset, through a wrapper
    # around the name ``DeviceStore.offset_of`` calls
    k5_uploads = []
    store_write = banded.store_write

    def recorded_k5(packed, store, off):
        k5_uploads.append((4 * packed.numel(), off))
        return store_write(packed, store, off)

    k2_fns = (consensus.nw_round_packed, consensus.nw_round_resident)
    # each K3p launch's (V, NB, TW, TWp, RW) and what its inputs need
    # (k3_counts), through a wrapper around the name consensus calls
    k3_shapes = []
    k3_fn = consensus.nw_dist_pairs_packed

    def recorded_k3(chars, meta, TW, TWp, RW, NB):
        k3_shapes.append(((meta.shape[0], NB, TW, TWp, RW),
                          k3_counts(meta, TW, RW)))
        return k3_fn(chars, meta, TW=TW, TWp=TWp, RW=RW, NB=NB)

    banded.extend = recorded
    banded.store_write = recorded_k5
    consensus.nw_round_packed = k2_recorder("K2p", k2_fns[0])
    consensus.nw_round_resident = k2_recorder("K2r", k2_fns[1])
    consensus.nw_dist_pairs_packed = recorded_k3
    consensus.round_pack, consensus.window_pack = recorded_k4, recorded_k4w
    reset_launch_counts()
    try:
        result, out, wall = run_phase_a(d, asm, reads, "")
    finally:
        banded.extend = extend
        banded.store_write = store_write
        consensus.nw_round_packed, consensus.nw_round_resident = k2_fns
        consensus.nw_dist_pairs_packed = k3_fn
        consensus.round_pack, consensus.window_pack = k4_fns
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
    buckets: dict = {}
    for R, N, a_len in shapes:
        row = buckets.setdefault((R, N), [0, 0, 0])
        row[0] += 1
        row[1] += int((a_len > 0).sum())
        row[2] += int(a_len.clamp(0, R).sum())
    log("  K1 launches by (R, N): " + "; ".join(
        f"({R}, {N}) x{c}, {live} live lanes, {rows} rows"
        for (R, N), (c, live, rows) in sorted(buckets.items())))
    k2_buckets: dict = {}
    for mode, T, RL, N, live in k2_shapes:
        row = k2_buckets.setdefault((mode, T, RL, N), [0, 0])
        row[0] += 1
        row[1] += live
    log("  K2p and K2r launches by (T, RL, N): " + "; ".join(
        f"{mode} ({T}, {RL}, {N}) x{c}, {live} live lanes"
        for (mode, T, RL, N), (c, live) in sorted(k2_buckets.items())))
    k3_buckets: dict = {}
    for key, counts in k3_shapes:
        rec = k3_buckets.setdefault(key, {"launches": 0})
        rec["launches"] += 1
        for name, x in counts.items():
            rec[name] = rec.get(name, 0) + x
    log("  K3p launches by (V, NB, TW, TWp, RW): " + "; ".join(
        f"{key} x{r['launches']}, {r['live']} live candidates, {r['filled']} "
        f"filled slots, {r['cells']} cells, {r['word_rows']} word rows "
        f"(32-bit), mean lengths {(np.arange(len(r['tl_hist'])) * r['tl_hist']).sum() / max(1, r['live']):.2f} "
        f"(base windows), {(np.arange(len(r['rl_hist'])) * r['rl_hist']).sum() / max(1, r['filled']):.2f} (reads)"
        for key, r in sorted(k3_buckets.items())))
    k4_buckets: dict = {}
    for key, live in k4_shapes:
        rec = k4_buckets.setdefault(key, {"launches": 0, "live": 0,
                                          "inputs": k4_inputs[key]})
        rec["launches"] += 1
        rec["live"] += live
    log("  K4 and K4w launches by (T, N): " + "; ".join(
        f"{k4_what(key)} x{r['launches']}, {r['live']} live lanes"
        for key, r in sorted(k4_buckets.items())))
    log(f"  K5 uploads (characters): {[n for n, _ in k5_uploads]}, "
        f"{sum(n for n, _ in k5_uploads)} in all; offsets a multiple of 16: "
        f"{sum(o % 16 == 0 for _, o in k5_uploads)}/{len(k5_uploads)}")
    if len(k5_uploads) != launches["K5"]:
        fail(f"{launches['K5']} K5 launches for {len(k5_uploads)} uploads")
    for name, want in PHASE_A_SHA256.items():
        got = sha256(os.path.join(d, name))
        if got != want:
            fail(f"3 Mb scenario: {name} sha256 {got} != JAX {want}")
    log("  FASTA, AGP and BED equal to the JAX package's (sha256)")
    # the default path: resident K1, packed full rounds (K2p) and polish
    # (K3p), store-resident windows (K2r), sparse blocks (K4, K4w), 2-bit
    # store uploads (K5)
    for mode in ("K1", "K2p", "K2r", "K3p", "K4", "K4w", "K5"):
        if launches[mode] <= 0:
            fail(f"{mode} was not launched on the main path")
    if result.n_closed_gaps < PHASE_A_JAX_CLOSED:
        fail(f"closed {result.n_closed_gaps} gaps, JAX closes {PHASE_A_JAX_CLOSED}")
    if exact < PHASE_A_JAX_EXACT:
        fail(f"{exact} gaps closed byte-exact, JAX closes {PHASE_A_JAX_EXACT}")
    return (launches, sc, buckets, k2_buckets, k3_buckets, k4_buckets,
            k5_uploads)


def consensus_sections(sections: dict) -> dict:
    """The consensus host sections of the port's ``prof`` counters:
    name → [seconds, hits, bytes]."""
    return {k: [round(v[0], 4), v[1], v[2]] for k, v in sorted(sections.items())
            if k.startswith(("cons.", "process."))}


def phase_profile(tmp: str, calls: int) -> None:
    """``calls`` more phase-A runs, the last under ``torch.profiler``,
    then one with ``DENTIST_TPU_DENSE_CONS=1``.  The device is busy where
    any kernel or copy runs: the union of their intervals, against the
    profiled run's wall.  The port's section counters (``utils/prof``)
    are on for these runs: the consensus host sections of the last
    default call and of the dense call are printed side by side."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dentist_tpu_torch.ops import pack2
    from dentist_tpu_torch.utils import prof as sections

    d = os.path.join(tmp, "phase_a")
    asm, reads = (os.path.join(d, f) for f in ("assembly.fasta", "reads.fasta"))
    walls = []
    sections.ENABLED = True
    try:
        for i in range(calls + 1):
            last = i == calls - 1
            dense = i == calls
            pack2.seconds, pack2.calls = 0.0, 0
            sections._acc.clear()
            if dense:
                os.environ["DENTIST_TPU_DENSE_CONS"] = "1"
            try:
                with (profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
                      if last else contextlib.nullcontext()) as p:
                    _, out, wall = run_phase_a(d, asm, reads, f"_profile{i}")
            finally:
                os.environ.pop("DENTIST_TPU_DENSE_CONS", None)
            for name, want in PHASE_A_SHA256.items():
                got = sha256(out[: -len("fasta")] + name[len("out."):])
                if got != want:
                    fail(f"3 Mb run {i} (dense={dense}): {name} sha256 {got} "
                         f"!= JAX {want}")
            if last:
                prof, default_sections = p, consensus_sections(sections._acc)
                default_wall = wall
                pack_ms, pack_calls = pack2.seconds * 1e3, pack2.calls
            elif dense:
                dense_sections, dense_wall = consensus_sections(sections._acc), wall
            else:
                walls.append(wall)
    finally:
        sections.ENABLED = False
        sections._acc.clear()
    walls.append(default_wall)
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
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        log(f"  {us / 1e3:10.3f} ms {n:6d}x  {name[:90]}")
    log(f"  host 2-bit packing in the profiled run: {pack_ms:.1f} ms "
        f"over {pack_calls} calls")
    log(f"consensus sections [s, hits, bytes], default transport "
        f"({default_wall:.3f} s, profiled): {json.dumps(default_sections)}")
    log(f"consensus sections [s, hits, bytes], DENTIST_TPU_DENSE_CONS=1 "
        f"({dense_wall:.3f} s): {json.dumps(dense_sections)}")


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
        for mode in ("K1p", "K2p", "K3p", "K4", "K4w"):
            if r["launches"][mode] <= 0:
                fail(f"rank {r['rank']} launched no {mode} on its lanes")
        if r["launches"]["K2r"]:
            fail(f"rank {r['rank']} ran store-resident windows in a group")
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


def phase_dense(tmp: str) -> dict:
    """The 60 kb scenario on the dense transport
    (``DENTIST_TPU_DENSE_CONS=1``): host-built windows (K2p) and dense
    result blocks (K4 and K4w dense) only."""
    from dentist_tpu_torch.pipeline import PipelineConfig, run_pipeline

    asm, reads = (os.path.join(tmp, "e2e", f) for f in ("assembly.fasta",
                                                        "reads.fasta"))
    d = os.path.join(tmp, "e2e_dense")
    os.makedirs(d)
    reset_launch_counts()
    os.environ["DENTIST_TPU_DENSE_CONS"] = "1"
    t0 = time.perf_counter()
    try:
        run_pipeline(asm, reads, os.path.join(d, "out.fasta"),
                     PipelineConfig(read_coverage=20.0))
    finally:
        os.environ.pop("DENTIST_TPU_DENSE_CONS", None)
    launches = launch_counts()
    check_e2e_hashes(d, "60 kb scenario on the dense transport")
    log(f"dense transport, 60 kb / 3 gaps: FASTA, AGP and BED equal to the "
        f"JAX package's (sha256), {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {json.dumps(launches)}")
    for mode in ("K4dense", "K4wdense"):
        if launches[mode] <= 0:
            fail(f"dense transport: {mode} was not launched: {launches}")
    for mode in ("K2r", "K4", "K4w"):
        if launches[mode]:
            fail(f"dense transport: {mode} was launched: {launches}")
    return launches


def run_stages(commands, what: str):
    """Each (stage, argv) of ``commands`` through ``cli.main``, the entry
    point of ``python -m dentist_tpu_torch``, with the launch counts set
    to 0 before it; returns each stage's wall seconds, launches and
    printout, and the total seconds."""
    import contextlib
    import io

    import torch

    from dentist_tpu_torch import cli

    walls, launches, printed = {}, {}, {}
    t_all = time.perf_counter()
    for stage, argv in commands:
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*argv, "-q"])
        torch.cuda.synchronize()
        walls[stage] = time.perf_counter() - t0
        if rc:
            fail(f"{what}: {stage} exited {rc}")
        launches[stage] = {k: v for k, v in launch_counts().items() if v}
        printed[stage] = buf.getvalue()
        log(f"{what} {stage}: {walls[stage]:.2f} s; kernel launches "
            f"{json.dumps(launches[stage])}")
    return walls, launches, printed, time.perf_counter() - t_all


def extended_on_card(d: str, launches: dict, stage: str, out: str,
                     what: str) -> int:
    """The alignments ``stage`` wrote to ``out``; fails if it wrote some
    and launched neither K1 nor K1p."""
    from dentist_tpu_torch.io.store import load_alignments

    n = len(load_alignments(os.path.join(d, out))[0].a_id)
    k1 = launches[stage].get("K1", 0) + launches[stage].get("K1p", 0)
    log(f"  {what} {stage}: {n} alignments")
    if n and not k1:
        fail(f"{what} {stage} wrote {n} alignments and launched neither "
             f"K1 nor K1p")
    return n


def npz_sha256(path: str) -> str:
    """sha256 of an npz container's arrays (each one's name, dtype, shape
    and bytes, by name), not of its zip headers, which carry times."""
    h = hashlib.sha256()
    with np.load(path, allow_pickle=False) as z:
        for key in sorted(z.files):
            a = np.ascontiguousarray(z[key])
            h.update(f"{key} {a.dtype.str} {a.shape}\n".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def phase_staged(tmp: str, sc) -> None:
    """The staged workflow on the 3 Mb scenario through ``cli.main``; each
    stage timed with its launches."""
    import shutil

    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             staged_commands, write_truth)

    d = os.path.join(tmp, "staged")
    os.makedirs(d)
    for name in ("assembly.fasta", "reads.fasta"):
        shutil.copy(os.path.join(tmp, "phase_a", name), d)
    write_truth(sc, d)
    walls, launches, printed, total = run_stages(staged_commands(d), "staged")
    # the phase-A assembly is a random genome without repeats, so its
    # self-alignment (``align``) finds none, as the JAX package's does;
    # phase 11 runs ``align`` where there are repeats
    extended_on_card(d, launches, "align", "self.las.npz", "staged")
    if not extended_on_card(d, launches, "map", "reads.las.npz", "staged"):
        fail("staged map wrote no alignments")
    process = {}
    for stage in ("process-0", "process-1"):
        for k, v in launches[stage].items():
            process[k] = process.get(k, 0) + v
    for mode in ("K2p", "K2r", "K3p", "K4", "K4w", "K5"):
        if not process.get(mode):
            fail(f"staged process launched no {mode}: {process}")
    for name, want in STAGED_SHA256.items():
        got = sha256(os.path.join(d, name))
        if got != want:
            fail(f"staged workflow: {name} sha256 {got} != JAX {want}")
    stats = json.loads(printed["check-results"])
    exact = closed_exactly_in(sc, os.path.join(d, "out.fasta"))
    log(f"staged workflow, 3 Mb / 16 gaps, {len(walls)} stages: {total:.1f} s; "
        f"gaps closed {stats['numClosedGaps']} ({exact} byte-exact; JAX staged: "
        f"{STAGED_JAX_CLOSED} closed, {STAGED_JAX_EXACT} byte-exact); FASTA, AGP, "
        f"BED and scaffolding maps equal to the JAX package's staged run (sha256)")
    if stats["numClosedGaps"] < STAGED_JAX_CLOSED:
        fail(f"staged: closed {stats['numClosedGaps']} gaps, JAX closes "
             f"{STAGED_JAX_CLOSED}")
    if exact < STAGED_JAX_EXACT:
        fail(f"staged: {exact} gaps closed byte-exact, JAX {STAGED_JAX_EXACT}")


def phase_repeats(tmp: str) -> None:
    """The masking stages of the staged workflow on an assembly with
    repeats, where ``tandem`` and ``align`` have alignments to extend."""
    from dentist_tpu_torch.io.fasta import codes_to_seq, write_fasta
    from dentist_tpu_torch.io.store import load_mask
    from dentist_tpu_torch.scenarios import repeat_assembly, staged_commands

    d = os.path.join(tmp, "repeats")
    os.makedirs(d)
    asm = os.path.join(d, "assembly.fasta")
    write_fasta(asm, [(r.header, codes_to_seq(r.codes))
                      for r in repeat_assembly(REPEATS_LENGTH, REPEATS_COPIES)])
    if sha256(asm) != REPEATS_ASSEMBLY_SHA256:
        fail(f"repeats: assembly.fasta sha256 {sha256(asm)} != "
             f"{REPEATS_ASSEMBLY_SHA256}")
    stages = staged_commands(d)[:4]
    _, launches, _, total = run_stages(stages, "repeats")
    n = extended_on_card(d, launches, "align", "self.las.npz", "repeats")
    tan = len(load_mask(os.path.join(d, "tan.mask.npz")))
    k1 = launches["tandem"].get("K1", 0) + launches["tandem"].get("K1p", 0)
    log(f"repeats, {REPEATS_LENGTH // 1000} kb / {REPEATS_COPIES} copies, "
        f"{len(stages)} stages: {total:.1f} s; {tan} tandem intervals, {n} "
        f"self-alignments (JAX: {REPEATS_JAX_ALIGNMENTS})")
    if not k1 or not tan:
        fail(f"repeats tandem: {tan} intervals, {k1} K1/K1p launches")
    if n != REPEATS_JAX_ALIGNMENTS:
        fail(f"repeats align: {n} self-alignments, JAX {REPEATS_JAX_ALIGNMENTS}")
    for name, want in REPEATS_SHA256.items():
        got = npz_sha256(os.path.join(d, name))
        if got != want:
            fail(f"repeats: {name} arrays sha256 {got} != JAX {want}")
    log(f"  tandem, self-alignment and self-coverage masks equal to the JAX "
        f"package's (arrays sha256)")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port once on one GPU.")
    ap.add_argument("--baseline", metavar="DIR",
                    help="a directory holding another version's extend.cu, "
                         "nw_round.cu, nw_dist.cu, round_pack.cu and/or "
                         "store_write.cu with its pack2.cuh: phase 3 times "
                         "each one's kernels beside this version's, in the "
                         "same process")
    args = ap.parse_args()
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
    global INT_OPS_PER_S
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT_OPS_PER_S = sms * 64 * clock_mhz * 1e6
    log(f"bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM; INT32 {sms} SMs x 64 "
        f"lanes x {clock_mhz:.0f} MHz = {INT_OPS_PER_S / 1e12:.2f} Tops/s")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"built the kernels in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    for line in ptxas_lines(_build.build_log):
        log(f"  {line}")
    sass_row_steps(_build.library()._name)

    # 3. kernels against their plain versions (K1, K1p, K2, K2p, K2r, K3,
    # K3p, K4, K4w and K5 again after phase 5)
    baselines = build_baselines(args.baseline)
    rows, phase3, k4_fixed = phase_kernels(baselines.get("nw_dist.cu"))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 4. main path, small, against the JAX package's hashes
        phase_e2e(tmp)
        # 5. main path at real size
        (launches, sc, buckets, k2_buckets, k3_buckets, k4_buckets,
         k5_uploads) = phase_a(tmp)
        # 3, K1, K1p, K2, K2p, K2r, K3, K3p, K4, K4w and K5: at the buckets
        # and upload sizes phase 5 launched
        rows = (phase_k1(buckets, baselines.get("extend.cu"))
                + phase_k2(k2_buckets, baselines.get("nw_round.cu"))
                + phase_k3(k3_buckets, baselines.get("nw_dist.cu"))
                + phase_k4(k4_buckets, baselines.get("round_pack.cu"), k4_fixed)
                + phase_k5(k5_uploads, baselines.get("store_write.cu"))
                + rows)
        # 6. where the time goes in later calls
        phase_profile(tmp, PROFILE_CALLS)
        # 7. host-window path on the card
        host_windows = phase_host_windows(tmp)
        # 8. two ranks on the one card
        phase_two_ranks(tmp)
        # 9. the dense consensus transport
        dense = phase_dense(tmp)
        # 10. the staged workflow through the command line
        phase_staged(tmp, sc)
        # 11. the masking stages where there are repeats
        phase_repeats(tmp)

    # each mode's launches in the run that drives it: phase 5 (the main
    # path), phase 7 for K1p, phase 9 for the dense K4 and K4w, phase 3
    # for K3f and K3b, which no path runs
    runs = {"main": launches, "host_windows": host_windows, "dense": dense,
            "phase3": phase3}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": runs[run][mode],
                "max_abs_err": stats["err"], "ms": stats["ms"],
                "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
                "bound_by": stats["bound_by"], "library_ms": None}
               for name, src, rep, run, mode, stats in rows]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
