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
   depends on).  K1t, K1's table mode (the JAX package's eight-array
   dispatch, which no path runs), at the shapes of its tests
   (``K1T_CASES``: W = 64, R = 252) and at (R, N) = (1512, 1024), each on
   the ladder of its slopes (and there equal to K1 on the same lanes) and
   on a table with random-walk schedules.  K1 and K1p run after phase 5, at every (R, N)
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
   windows cut into a store of their own; phase 5's launches are
   recorded by ``dryrun.LaunchRecorder``); with ``--baseline``, the
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
12. Resume: phase 5's call again from its workdir, complete (no launch)
   and with the insertions and skip list removed (consensus and
   validation again); both must hash as phase 5.
13. Two scaffolds with repeats: ``scenarios.scaffolds_repeats_scenario()``
   through ``run_pipeline`` with validation, against the hashes and
   counts of the JAX package's run, then its validation pass against
   unrelated reads, which must purge as JAX's does.
14. Two processes: phase 10's two ``process-pile-ups --batch`` stages as
   two processes on the card at once; the merged insertions must equal
   phase 10's.
15. Scripts: ``scripts/profile_e2e_torch.py`` (phase C's model at
   ``PROFILE_E2E_SIZE``, 0.2 Mb / 3 gaps, one call: phases 16 and 18 run
   phase C at 3 Mb and hold it by digest, so this is the script's run
   check alone), ``scripts/profile_process_torch.py`` and
   ``scripts/bench_consensus_kernel_torch.py`` as processes on the card;
   each must exit 0 and print its JSON line, the first two must launch
   every kernel of the main path, and the bench must take every shape,
   equal to its plain version where it holds it.
16. Phase C by digest: ``scenarios.phase_c_scenario`` at 3 Mb / 16 gaps
   and at 28 Mb / 147 gaps (the reference example's scale) through
   ``run_pipeline`` with a workdir, each from a fresh device store, in a
   process of its own (``scripts/phase_c_torch.py``; the 3 Mb call is its
   first), against the JAX package's CPU run of the same files
   (``scripts/phase_c_reference.json``, written by
   ``scripts/phase_c_reference.py``): the inputs must hash as the
   reference's before the pipeline runs (a drift of the data generator
   fails as such), then the FASTA, AGP and BED, every stage artifact
   (masks, alignments, pile-ups, insertions by their arrays' sha256;
   the validation skip list) and every closed gap (its BED row and
   inserted sequence) must equal the reference's, the gaps closed and
   closed byte-exact must be at least its counts, and every kernel of
   the main path must have launched.  Logs the wall and stage seconds,
   K1p launches and store resets, peak device memory and RSS, launches
   per kernel and per bucket, and what differs, if anything.  Then a
   third run in this process: phase C at ``OVERFLOW_SIZE`` (3 Mb) with a
   device store of ``OVERFLOW_STORE_MB`` MiB, which holds the assembly
   and not the reads, so their alignment takes host windows and the store
   resets, as a user's does at 100 Mb and above: it must equal the same
   reference entry in every digest and launch K1 (the assembly's
   self-alignment, resident), K1p and at least one reset; logs the store
   size, the wall and the K1, K1p and K5 launches.  Then phase
   3 once more: every kernel of the main path against its plain version
   (tolerance 0) at each bucket and K5 upload size the three runs launched
   and phase 5 did not (the ``LaunchRecorder`` tables, with the
   first K4 and K4w inputs of each bucket; K1 without K1p, K2p without
   K2).
17. The installed port: what the images of ``packaging/torch/`` do,
   without ``docker``.  A wheel of the files the image copies
   (``pyproject.toml``, ``README.md``, the port) is built with ``pip wheel
   --no-deps --no-build-isolation`` and installed with ``pip install
   --target`` into a temporary prefix; the packaging's kernel build
   command (``python -m dentist_tpu_torch._build``) builds the kernels
   into it from a directory outside the repo; then
   ``packaging/torch/smoke-test.sh`` runs from there with only the prefix
   on ``PYTHONPATH``, no ``nvcc`` on ``PATH`` and ``CUDA_HOME`` unset.
   The smoke test must import the prefix's package, load the prebuilt
   library without a build (its ``build_seconds`` 0.0, and the prefix's
   ``_build/`` listing and mtimes as they were), and write phase 4's
   FASTA, AGP and BED with the JAX package's hashes, launching K1 and a
   consensus kernel (K2p or K2r).  The ``/usr/local/cuda`` that
   ``_build`` also probes is still there, so "no build" is shown by that
   evidence, not by making a build impossible.
18. The bench: ``bench_torch.py --small --trials 1`` (``bench.py``'s
   phases A and B, then phase C at 3 Mb / 16 gaps through
   ``run_pipeline``, one trial of each: phase 16 holds that run by
   digest, so this is the bench's run check) as a process on the card.
   It must exit 0 and print its JSON line, with every gate passed (phase
   A's and B's trial equal to the JAX package's digests in
   ``scripts/bench_reference.json``, phase C's inputs and its trial's
   digests to ``scripts/phase_c_reference.json``'s 3 Mb entry), the
   phase C trial timed, and every kernel of the main path launched in it.
   Logs the headline.
19. The JAX package's tests: every scenario of
   ``dentist_tpu_torch.scenarios.SUITE`` (the gap-closing cases of its
   ``tests/test_anchor_unique.py``, ``test_bubbles.py``,
   ``test_overlap_crop.py``, ``test_multiscaffold.py`` and
   ``test_validation_pass.py``, and the read sets of
   ``tests/test_consensus.py``) through the port in this process
   (``scenarios.run_suite``), each held to the JAX package's CPU run of
   the same scenario by its ``scenarios.suite_digests``
   (``scenarios.SUITE_REFERENCE``), every kernel of the main path
   launched.  Then phase 3 once more, at each bucket and K5 upload size
   those runs launched that phases 5 and 16 did not.  Logs each
   scenario's seconds.

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
record carries their launches in phase 3, as K1t's does (the JAX
package calls ``extend_batch_multi_async`` only from its tests).
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

# Phase-13 constants: the JAX package's run of
#   JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 \
#       python scripts/scaffolds_repeats_reference.py DIR
# (x86-64 CPU, JAX on its CPU backend, 488 s): ``run_pipeline`` with read
# coverage 20 and validation on the two files ``write_scenario(
# scaffolds_repeats_scenario(), DIR)`` writes (sha256 below), then
# ``_validation_pass`` on its result against ``unrelated_reads()``.  Its
# validation purges one of the 8 closed gaps (contigs 9-10, a weak
# window), so 7 stay closed, all 7 byte-exact; its repeat mask has 8
# intervals and its dust mask none; against the unrelated reads it
# purges all 7.
SCAFFOLDS_INPUT_SHA256 = {
    "assembly.fasta": "19658c623769fd650f63513388ad5ac26b25e145a07deda1ba59eda47e2c3fb2",
    "reads.fasta": "6d8da960f9b0e8ce25f2be3d951e28ea196d5d244a68d11298b0de7468f01e19",
}
SCAFFOLDS_JAX_CLOSED = 7
SCAFFOLDS_JAX_EXACT = 7
SCAFFOLDS_JAX_SKIP = {(1, 2), (2, 3), (3, 4), (4, 5), (6, 7), (7, 8), (8, 9)}
SCAFFOLDS_SHA256 = {
    "out.fasta": "3d9bd61541e80579ef3d606d931f5cf7afc36dfbe93236ece9971f950b98318e",
    "out.agp": "8123a907b96074fb265462bea297fdf9cada12d3b2a2212cc5240984e9a033ec",
    "out.closed-gaps.bed": "43cee961c1845b46d08070395f5bba77bbd7271c50d05a68a74d5efc6b2432cd",
}

# Phase 16: the JAX package's runs of phase C at 3 Mb / 16 gaps
# and 28 Mb / 147 gaps, by
#   JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 \
#       python scripts/phase_c_reference.py DIR --mb MB --gaps GAPS
# (x86-64 CPU, JAX on its CPU backend): ``python -m dentist_tpu.cli
# pipeline`` with read coverage 20 and a workdir on the files
# ``write_scenario(phase_c_scenario(MB, GAPS), DIR)`` writes, then
# ``check-results`` against ``write_truth``'s truth; each size's digests
# (``scenarios.phase_c_digests``), counts, times and provenance under its
# key (``"3"``, ``"28"``) of this file.
PHASE_C_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "scripts", "phase_c_reference.json")
#: phase 16's sizes (Mb, gaps), each against its entry of the file above
PHASE_C_SIZES = ((3, 16), (28, 147))
#: phase 16's third run: phase C at this size (Mb, gaps), against the same
#: entry, with a device store of ``OVERFLOW_STORE_MB`` MiB, which holds
#: the assembly and not the reads (about 62 M characters): their
#: alignment takes host windows (K1p) and the store resets, as a user's
#: does at 100 Mb and above, while the assembly's self-alignment stays
#: resident (K1)
OVERFLOW_SIZE = (3, 16)
OVERFLOW_STORE_MB = 32
# Phase 19 reads the JAX package's run of the suite scenarios
# (``dentist_tpu_torch.scenarios.SUITE``: the cases of its tests of the
# modules that reach the device) from ``scenarios.SUITE_REFERENCE``, which
# the reference script it names writes (x86-64 CPU, JAX on its CPU
# backend): each scenario's ``scenarios.suite_digests`` under its key of
# ``"scenarios"``.
#: the kernels of the main path, which the pipeline runs of phases 5, 15,
#: 16 and 19 must launch
MAIN_PATH_KERNELS = ("K1", "K2p", "K2r", "K3p", "K4", "K4w", "K5")

#: phase 15: the size (Mb, gaps) of phase C's model that
#: ``scripts/profile_e2e_torch.py`` runs, a check that the script runs
#: and launches every kernel of the main path
PROFILE_E2E_SIZE = (0.2, 3)

#: phase 18: the trials of each phase that ``bench_torch.py --small`` runs
#: (phases 16 and 19 hold the port's runs by digest; this is the bench's
#: run check)
BENCH_TRIALS = 1
#: the gates it passes, in order: phase A's trial, phase B's pile-ups and
#: trial, phase C's inputs and trial
BENCH_GATES = ["A0", "collect", "B0", "C inputs", "C0"]

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


def k1_work(meta, R: int, W: int, packed: bool, table=None) -> dict:
    """K1's bound: the band cells of every lane's rows up to its a_len;
    A and B windows (packed: their 2-bit rows), meta and (K1t) the int32
    offset ``table`` in, the result block out."""
    from dentist_tpu_torch.ops.banded import bw_for

    N = meta.shape[1]
    BW = bw_for(R, W)
    cells = int(meta[2].clamp(0, R).sum()) * W
    win = N * (R + BW) // 4 if packed else N * (R + BW)
    io = (win + nbytes(meta) + N * 4 * (4 + R // 126)
          + (4 * table.size if table is not None else 0))
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


def k3_work(rows, meta, TW: int, RW: int) -> dict:
    """K3's and K3p's bound: the rows (packed or not) and meta in, the
    (2, V, NB) distances out; ``K3_OPS_PER_WORD32`` operations per word
    row of ``dryrun.k3_counts``, whose cell count rides along for the cell
    rate."""
    from dentist_tpu_torch.dryrun import k3_counts

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
    (``dryrun.k3_counts``) and an edited window one deletion, insertion or
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
    rows.append(phase_k1t())
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


def phase_k1(buckets: dict, baseline, legacy=K1_LEGACY, packed: bool = True) -> list:
    """Phase 3 for K1 and K1p, after phase 5: each against its plain
    version at every (R, N) bucket pair the main path launched (and at
    ``legacy``, with and without diagonal bounds), with its time, bound
    and their ratio; K1 alone where ``packed`` is false; with
    ``baseline`` (:func:`build_baselines`' ``extend.cu``), the other version's kernel
    timed beside this one at ``legacy`` on the same inputs, in turns
    (baseline, kernel, kernel, baseline)."""
    import torch

    from dentist_tpu_torch.ops import banded

    rng = np.random.default_rng(2024)
    store = banded.device_store()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    shapes = sorted(set(buckets) | set(legacy), key=lambda rn: rn[0] * rn[1])
    k1, k1p = {}, {}
    for R, N in shapes:
        BW = banded.bw_for(R, 256)
        for bounded in ((False, True) if (R, N) in legacy else (False,)):
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
            if baseline and not bounded and (R, N) in legacy:
                out = torch.empty_like(st["out"])
                old = lambda: baseline["dentist_extend"](
                    store.array.data_ptr(), meta.data_ptr(), nd.data_ptr(),
                    out.data_ptr(), store.array.numel(), N, R, 256, BW, stream())
                compare("K1", R, N, kernel, old, out, st)
            if not packed:
                continue
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
            if baseline and not bounded and (R, N) in legacy:
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


#: phase 3's K1t cases (W, N, R, K, seed, diagonal bounds): the shapes of
#: the JAX package's tests of the eight-array dispatch
#: (``tests/test_parallel.py:82``, ``:106``, ``:134``) and one of the
#: main path's (R, N) buckets
K1T_CASES = ((64, 16, 252, 4, 11, False), (64, 8, 252, 2, 12, True),
             (64, 16, 252, 4, 13, False), (256, 1024, 1512, 4, 2028, False))


def k1t_case(W: int, N: int, R: int, K: int, seed: int, bounded: bool):
    """Host-window lanes as ``extend_batch_multi`` lays them out, drawn as
    the JAX tests draw theirs (at the main path's shape, B windows that
    hold a noisy copy of A from column W in three lanes of four), with
    the ladder of slopes R, 1.05R, 0.95R, R; returns the store, meta12,
    the slopes and a table whose later half of schedules are random
    walks of 0..2 columns a row from the ladder's row 0 instead."""
    import torch

    from dentist_tpu_torch.ops.banded import (DIAG_UNBOUNDED, bw_for,
                                              host_window_meta, ladder)

    rng = np.random.default_rng(seed)
    BW = bw_for(R, W)
    a = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b = rng.integers(0, 4, (N, BW)).astype(np.uint8)
    if N > 16:
        for n in range(N):
            if n % 4 != 3:
                seg = a[n, : BW - W].copy()
                noise = rng.random(len(seg)) < 0.12
                seg[noise] = rng.integers(0, 4, int(noise.sum()))
                b[n, W : W + len(seg)] = seg
    if bounded:
        a_len = b_len = np.full(N, R, np.int32)
    else:
        a_len = rng.integers(R // 2, R + 1, N).astype(np.int32)
        b_len = rng.integers(R // 2, int(1.1 * R), N).astype(np.int32)
    diag_lo = np.full(N, -DIAG_UNBOUNDED, np.int32)
    diag_hi = np.full(N, DIAG_UNBOUNDED, np.int32)
    if bounded:
        diag_hi[::2] = 40
    num_k = np.array([R, int(1.05 * R), int(0.95 * R), R][:K], np.int32)
    lane_k = (np.arange(N) % K).astype(np.int32)
    offs = ladder(num_k, R, W)
    walks = offs.copy()
    for k in range(K // 2, K):
        steps = rng.choice(3, size=R, p=(0.25, 0.5, 0.25))
        walks[1:, k] = walks[0, k] + np.cumsum(steps)
    store = np.concatenate([a.reshape(-1), b.reshape(-1)])
    meta = host_window_meta(a_len, b_len, lane_k, diag_lo, diag_hi, N, R, BW)
    return (torch.from_numpy(store).cuda(), torch.from_numpy(meta).cuda(),
            num_k, offs, walks)


def phase_k1t() -> tuple:
    """Phase 3 for K1t, the table mode no path runs: at each of
    ``K1T_CASES``, on the ladder table (and there equal to K1 on the same
    lanes) and on a table with random-walk schedules, against its plain
    version (tolerance 0); returns its ``kernels`` row."""
    from dentist_tpu_torch.ops import banded

    k1t = {}
    for W, N, R, K, seed, bounded in K1T_CASES:
        store, meta, num_k, offs, walks = k1t_case(W, N, R, K, seed, bounded)
        work = k1_work(meta, R, W, False, table=offs)
        for what, table in (("ladder", offs), ("walks", walks)):
            st = hold(f"K1t extend_table W={W} R={R} N={N} K={K} {what} "
                      f"diag_bounds={bounded}",
                      lambda: banded.extend_table(store, meta, table, R=R, W=W),
                      lambda: banded.extend_table_reference(store, meta, table,
                                                            R=R, W=W), 3, work)
            log(f"  {int((st['out'][3] > 0).sum())}/{N} lanes aligned; "
                f"{st['ms'] / st['bound_ms']:.2f}x the bound")
            k1t = merge(k1t, st)
            if what == "ladder":
                k1 = banded.extend(store, meta, num_k, R=R, W=W)
                if max_abs_err(st["out"], k1):
                    fail(f"K1t != K1 on the ladder of num_k at R={R} N={N}")
                log("  equal to K1 on the same lanes and slopes")
    return ("K1t extend_table", "dentist_tpu_torch/csrc/extend.cu",
            "dentist_tpu/ops/banded.py:62", "phase3", "K1t", k1t)


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


def phase_k2(k2_buckets: dict, baseline, full: bool = True) -> list:
    """Phase 3 for K2, K2p and K2r, after phase 5: each against its plain
    version at every (T, RL, N) bucket of the main path's launches, with
    as many live lanes as the launches held on average, with its time,
    bound and their ratio.  K2p at the largest of them runs again with
    S = 0 (the forward scan alone) beside the full S (scan and
    traceback).  Where ``full`` is false, K2p and K2r alone, the modes
    the main path launches: no K2 beside K2p and no S = 0.  With ``baseline`` (:func:`build_baselines`'
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
            if full:
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
            if full and max_abs_err(st["out"], unpacked):
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

    src = "dentist_tpu_torch/csrc/nw_round.cu"
    rows = [("K2p nw_round_packed", src, "dentist_tpu/ops/consensus.py:491",
             "main", "K2p", k2p),
            ("K2r nw_round_resident", src, "dentist_tpu/ops/consensus.py:945",
             "main", "K2r", k2r)]
    if not full:
        return rows
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
    return rows


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

    from dentist_tpu_torch.dryrun import k3_counts
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
    launch keeps phase 3's fixed cases (``fixed``; none for phase 16's
    buckets)."""
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
        if row not in best and fixed:
            log(f"  {row}: not launched in phase 5; its row keeps phase 3's cases")
    return [(name, "dentist_tpu_torch/csrc/round_pack.cu", rep, run, row,
             best[row][1] if row in best else fixed.get(row))
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
    check_hashes(d, "out", E2E_SHA256, "60 kb scenario")
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


def log_buckets(t: dict) -> None:
    """The launches of a :class:`~dentist_tpu_torch.dryrun.LaunchRecorder`
    (its ``tables()``, or ``vars()`` of it) by bucket, with their live
    lanes."""
    log("  K1 launches by (R, N): " + "; ".join(
        f"({R}, {N}) x{c}, {live} live lanes, {rows} rows"
        for (R, N), (c, live, rows) in sorted(t["k1"].items())))
    log("  K2p and K2r launches by (T, RL, N): " + "; ".join(
        f"{mode} ({T}, {RL}, {N}) x{c}, {live} live lanes"
        for (mode, T, RL, N), (c, live) in sorted(t["k2"].items())))
    log("  K3p launches by (V, NB, TW, TWp, RW): " + "; ".join(
        f"{key} x{r['launches']}, {r['live']} live candidates, {r['filled']} "
        f"filled slots, {r['cells']} cells, {r['word_rows']} word rows "
        f"(32-bit), mean lengths {(np.arange(len(r['tl_hist'])) * r['tl_hist']).sum() / max(1, r['live']):.2f} "
        f"(base windows), {(np.arange(len(r['rl_hist'])) * r['rl_hist']).sum() / max(1, r['filled']):.2f} (reads)"
        for key, r in sorted(t["k3"].items())))
    log("  K4 and K4w launches by (T, N): " + "; ".join(
        f"{k4_what(key)} x{r['launches']}, {r['live']} live lanes"
        for key, r in sorted(t["k4"].items())))
    log(f"  K5 uploads (characters): {[n for n, _ in t['k5']]}, "
        f"{sum(n for n, _ in t['k5'])} in all; offsets a multiple of 16: "
        f"{sum(o % 16 == 0 for _, o in t['k5'])}/{len(t['k5'])}")


def phase_a(tmp: str) -> dict:
    import torch

    from dentist_tpu_torch.dryrun import LaunchRecorder
    from dentist_tpu_torch.pipeline import STAGE_SECONDS, reset_stage_seconds
    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             phase_a_scenario, write_scenario)

    d = os.path.join(tmp, "phase_a")
    sc = phase_a_scenario()
    asm, reads = write_scenario(sc, d)
    reset_stage_seconds()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with LaunchRecorder() as rec:
        result, out, wall = run_phase_a(d, asm, reads, "")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_pileups = None
    with open(os.path.join(d, "work", "pipeline.log")) as fh:
        for line in fh:
            row = json.loads(line)
            if row.get("event") == "collectPileUps":
                n_pileups = row["numPileUps"]
    exact = closed_exactly_in(sc, out)
    stages = {k.rsplit(".", 1)[-1]: round(v, 3) for k, v in STAGE_SECONDS.items()}
    log(f"main path 3 Mb / 16 gaps: {wall:.1f} s wall; stages {json.dumps(stages)}")
    log(f"  pile-ups {n_pileups}, gaps closed {result.n_closed_gaps} "
        f"({exact} byte-exact; JAX: {PHASE_A_JAX_CLOSED} closed, "
        f"{PHASE_A_JAX_EXACT} byte-exact); peak device memory "
        f"{peak / 2**30:.2f} GiB; kernel launches {json.dumps(launches)}")
    log_buckets(vars(rec))
    if len(rec.k5) != launches["K5"]:
        fail(f"{launches['K5']} K5 launches for {len(rec.k5)} uploads")
    check_hashes(d, "out", PHASE_A_SHA256, "3 Mb scenario")
    log("  FASTA, AGP and BED equal to the JAX package's (sha256)")
    # the default path: resident K1, packed full rounds (K2p) and polish
    # (K3p), store-resident windows (K2r), sparse blocks (K4, K4w), 2-bit
    # store uploads (K5)
    for mode in MAIN_PATH_KERNELS:
        if launches[mode] <= 0:
            fail(f"{mode} was not launched on the main path")
    if result.n_closed_gaps < PHASE_A_JAX_CLOSED:
        fail(f"closed {result.n_closed_gaps} gaps, JAX closes {PHASE_A_JAX_CLOSED}")
    if exact < PHASE_A_JAX_EXACT:
        fail(f"{exact} gaps closed byte-exact, JAX closes {PHASE_A_JAX_EXACT}")
    return launches, sc, rec, wall


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

    from torch.profiler import ProfilerActivity, profile

    from dentist_tpu_torch.device import device_busy
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
            check_hashes(d, os.path.basename(out)[: -len(".fasta")],
                         PHASE_A_SHA256, f"3 Mb run {i} (dense={dense})")
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
    busy_ms, by_name = device_busy(prof)
    if not by_name:
        fail("torch.profiler recorded no device activity")
    log(f"profile: {calls} more 3 Mb runs, wall s "
        f"{json.dumps([round(w, 3) for w in walls])}; the last under torch.profiler")
    log(f"  device busy {busy_ms:.1f} ms of {walls[-1]:.3f} s "
        f"({100 * busy_ms / 1e3 / walls[-1]:.2f} %)")
    for name, (ms, n) in by_name.items():
        log(f"  {ms:10.3f} ms {n:6d}x  {name[:90]}")
    log(f"  host 2-bit packing in the profiled run: {pack_ms:.1f} ms "
        f"over {pack_calls} calls")
    log(f"consensus sections [s, hits, bytes], default transport "
        f"({default_wall:.3f} s, profiled): {json.dumps(default_sections)}")
    log(f"consensus sections [s, hits, bytes], DENTIST_TPU_DENSE_CONS=1 "
        f"({dense_wall:.3f} s): {json.dumps(dense_sections)}")


def check_hashes(d: str, out: str, want: dict, what: str) -> None:
    """The files a run wrote for the output path ``d/{out}.fasta`` (its
    AGP and BED beside it) against ``want``, keyed by the ``out.*``
    names (others, such as ``scaffolding.json``, as they are)."""
    for name, digest in want.items():
        got = sha256(os.path.join(d, name.replace("out", out, 1)))
        if got != digest:
            fail(f"{what}: {name} sha256 {got} != JAX {digest}")


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
    check_hashes(d, "out", E2E_SHA256, "60 kb scenario on host windows")
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
    check_hashes(d, "out", E2E_SHA256, "60 kb scenario on two ranks")
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
    check_hashes(d, "out", E2E_SHA256, "60 kb scenario on the dense transport")
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
    check_hashes(d, "out", STAGED_SHA256, "staged workflow")
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
    return walls


def phase_repeats(tmp: str) -> None:
    """The masking stages of the staged workflow on an assembly with
    repeats, where ``tandem`` and ``align`` have alignments to extend."""
    from dentist_tpu_torch.io.fasta import codes_to_seq, write_fasta
    from dentist_tpu_torch.io.store import load_mask
    from dentist_tpu_torch.scenarios import (npz_sha256, repeat_assembly,
                                             staged_commands)

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


def phase_resume(tmp: str, full_wall: float) -> None:
    """Phase 5's 3 Mb call again in its own workdir, in this process:
    (a) every artifact present, the stages that would recompute replaced
    by functions that fail, and no kernel launched; (b) the insertions
    and the skip list removed, so consensus and validation run again
    from phase 5's masks, alignments and pile-ups."""
    import torch

    from dentist_tpu_torch import pipeline as pl

    d = os.path.join(tmp, "phase_a")
    asm, reads = (os.path.join(d, f) for f in ("assembly.fasta", "reads.fasta"))

    def fails(*a, **k):
        raise RuntimeError("a resumed run recomputed a stage")

    def resumed(tag: str, stages: tuple):
        saved = {name: getattr(pl, name) for name in stages}
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for name in stages:
                setattr(pl, name, fails)
            pl.run_pipeline(asm, reads, os.path.join(d, f"{tag}.fasta"),
                            pl.PipelineConfig(read_coverage=20.0,
                                              workdir=os.path.join(d, "work")))
            torch.cuda.synchronize()
        finally:
            for name, fn in saved.items():
                setattr(pl, name, fn)
        wall = time.perf_counter() - t0
        check_hashes(d, tag, PHASE_A_SHA256, f"resume {tag}")
        return wall, {k: v for k, v in launch_counts().items() if v}

    wall, launches = resumed("out_resume_full", (
        "masks_for", "collect_pile_ups", "process_pile_ups", "_validation_pass"))
    log(f"resume 3 Mb, every artifact in phase 5's workdir: {wall:.2f} s "
        f"(phase 5's full call {full_wall:.2f} s); FASTA, AGP and BED equal to "
        f"the JAX package's (sha256); kernel launches {json.dumps(launches)}")
    if launches:
        fail(f"resume from a complete workdir launched kernels: {launches}")
    for name in ("insertions.npz", "validation.json"):
        os.remove(os.path.join(d, "work", name))
    wall, launches = resumed("out_resume_collect", ("masks_for", "collect_pile_ups"))
    log(f"resume 3 Mb after collect (insertions and skip list removed): "
        f"{wall:.2f} s (phase 5's full call {full_wall:.2f} s); FASTA, AGP and "
        f"BED equal to the JAX package's (sha256); kernel launches "
        f"{json.dumps(launches)}")
    for mode in ("K1", "K2p", "K2r", "K3p", "K4", "K4w", "K5"):
        if not launches.get(mode):
            fail(f"resume after collect launched no {mode}: {launches}")


def phase_scaffolds(tmp: str) -> None:
    """Two scaffolds cut from a 2 Mb genome with interspersed repeats,
    through ``run_pipeline`` with validation, then its validation pass
    against unrelated reads."""
    import torch

    from dentist_tpu_torch import pipeline as pl
    from dentist_tpu_torch.io.store import load_mask
    from dentist_tpu_torch.models.sequences import SeqStore
    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             closed_gap_pairs,
                                             scaffolds_repeats_scenario,
                                             unrelated_reads, write_scenario)

    d = os.path.join(tmp, "scaffolds")
    sc = scaffolds_repeats_scenario()
    asm, reads = write_scenario(sc, d)
    for name, want in SCAFFOLDS_INPUT_SHA256.items():
        if sha256(os.path.join(d, name)) != want:
            fail(f"scaffolds: {name} sha256 {sha256(os.path.join(d, name))} != {want}")
    # the K1 launches of each ``map_reads`` call: the first is the read
    # mapping under the masks, the second the validation re-map
    map_reads, mapped = pl.map_reads, []

    def recorded(*a, **k):
        before = launch_counts()
        out = map_reads(*a, **k)
        mapped.append({m: launch_counts()[m] - before[m] for m in ("K1", "K1p")})
        return out

    reset_launch_counts()
    cfg = pl.PipelineConfig(read_coverage=20.0, workdir=os.path.join(d, "work"))
    t0 = time.perf_counter()
    pl.map_reads = recorded
    try:
        result = pl.run_pipeline(asm, reads, os.path.join(d, "out.fasta"), cfg)
        torch.cuda.synchronize()
    finally:
        pl.map_reads = map_reads
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    masks = {name: load_mask(os.path.join(d, "work", f"{name}.mask.npz"))
             for name in ("dust", "repeats")}
    exact = closed_exactly_in(sc, os.path.join(d, "out.fasta"))
    log(f"two scaffolds with repeats, 2 Mb / 8 gaps: {wall:.1f} s; gaps closed "
        f"{result.n_closed_gaps} ({exact} byte-exact; JAX: {SCAFFOLDS_JAX_CLOSED} "
        f"closed, {SCAFFOLDS_JAX_EXACT} byte-exact); mask intervals: dust "
        f"{len(masks['dust'])}, repeats {len(masks['repeats'])}; K1 and K1p by "
        f"map_reads call (mapping, validation): {mapped}; kernel launches "
        f"{json.dumps(launches)}")
    check_hashes(d, "out", SCAFFOLDS_SHA256, "two scaffolds with repeats")
    log("  FASTA, AGP and BED equal to the JAX package's (sha256)")
    if not len(masks["dust"] | masks["repeats"]):
        fail("two scaffolds: the dust and repeat masks are empty")
    if not mapped or not mapped[0]["K1"]:
        fail(f"two scaffolds: the read mapping launched no K1: {mapped}")
    if result.n_closed_gaps < SCAFFOLDS_JAX_CLOSED or exact < SCAFFOLDS_JAX_EXACT:
        fail(f"two scaffolds: {result.n_closed_gaps} closed, {exact} byte-exact; "
             f"JAX {SCAFFOLDS_JAX_CLOSED} and {SCAFFOLDS_JAX_EXACT}")
    noise = unrelated_reads()
    store = SeqStore(np.concatenate(noise), np.array([len(r) for r in noise]))
    closed = closed_gap_pairs(result.bed_rows)
    reset_launch_counts()
    t0 = time.perf_counter()
    skip = pl._validation_pass(result, noise, store, cfg)
    torch.cuda.synchronize()
    log(f"  validation against {len(noise)} unrelated reads: "
        f"{time.perf_counter() - t0:.2f} s, purges {sorted(skip)}; kernel "
        f"launches {json.dumps({k: v for k, v in launch_counts().items() if v})}")
    if skip != SCAFFOLDS_JAX_SKIP or not closed <= skip:
        fail(f"two scaffolds: unrelated reads purge {sorted(skip)}; JAX "
             f"{sorted(SCAFFOLDS_JAX_SKIP)}, closed {sorted(closed)}")


def phase_two_processes(tmp: str, staged_walls: dict) -> None:
    """Phase 10's two ``process-pile-ups --batch`` stages again, as two
    ``python -m dentist_tpu_torch`` processes on this card at once, then
    ``merge-insertions``: the merged insertions must equal phase 10's."""
    from dentist_tpu_torch import cli
    from dentist_tpu_torch.scenarios import npz_sha256, staged_commands

    d = os.path.join(tmp, "staged")
    stages = dict(staged_commands(d))
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, outs = [], []
    t0 = time.perf_counter()
    for i, stage in enumerate(("process-0", "process-1")):
        argv = list(stages[stage])
        outs.append(os.path.join(d, f"insertions.2proc{i}.npz"))
        argv[5] = outs[-1]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dentist_tpu_torch", *argv, "-q"], cwd=HERE,
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("two processes: a process-pile-ups batch ran past 600 s")
        if p.returncode:
            fail(f"two processes: process-pile-ups exited {p.returncode}:\n{err[-4000:]}")
    pair = time.perf_counter() - t0
    merged = os.path.join(d, "insertions.2proc.npz")
    if cli.main(["merge-insertions", merged, *outs, "-q"]):
        fail("two processes: merge-insertions failed")
    seq = staged_walls["process-0"] + staged_walls["process-1"]
    log(f"two processes on one card, process-pile-ups 0..8 and 8..99 at once: "
        f"{pair:.2f} s (phase 10's two stages one after another in one "
        f"process: {seq:.2f} s)")
    if npz_sha256(merged) != npz_sha256(os.path.join(d, "insertions.npz")):
        fail("two processes: merged insertions != phase 10's (arrays sha256)")
    log("  merged insertions equal to phase 10's (arrays sha256)")


def run_script(name: str, *args: str, where: str = "scripts") -> dict:
    """``<where>/<name>.py`` (``where`` "" for the root) with ``args`` as
    a process on this card: it must exit 0 within 600 s; returns the JSON
    object of its last line."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, os.path.join(HERE, where, f"{name}.py"),
                               *args], cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail(f"scripts: {name} ran past 600 s")
    if proc.returncode:
        fail(f"scripts: {name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"scripts: {name} printed no JSON line:\n{proc.stdout[-2000:]}")
    log(f"{name} {' '.join(args)}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return out


def phase_c_reference() -> dict:
    """``PHASE_C_REFERENCE``'s entries, by size."""
    try:
        with open(PHASE_C_REFERENCE) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        fail(f"phase C: cannot read the JAX package's digests: {exc}")


def phase_scripts() -> None:
    """The ported profiling and bench scripts as processes on the card
    (phases 16 and 18 hold phase C's 3 Mb run to the JAX package's by
    digest, so the profile runs at ``PROFILE_E2E_SIZE``)."""
    mb, gaps = PROFILE_E2E_SIZE
    e2e = run_script("profile_e2e_torch", "--mb", str(mb), "--gaps", str(gaps),
                     "--calls", "1")
    call = e2e["calls"][0]
    log(f"  phase C at {mb} Mb / {e2e['scenario']['n_gaps']} gaps: {call['wall_s']:.2f} s, "
        f"{e2e['numClosedGaps']} closed, {e2e['numCorrectGaps']} correct; busy "
        f"{call['busy']['ms']:.1f} ms; launches {json.dumps(call['launches'])}")
    proc = run_script("profile_process_torch")
    log(f"  process on phase A: {json.dumps([round(w, 2) for w in proc['process_seconds']])} s, "
        f"sampled {proc['sampled_process_seconds']:.2f} s; launches "
        f"{json.dumps(proc['launches'])}")
    for what, launches, modes in (("profile_e2e_torch", call["launches"], MAIN_PATH_KERNELS),
                                  ("profile_process_torch", proc["launches"],
                                   MAIN_PATH_KERNELS[1:])):
        if not all(launches.get(m) for m in modes):
            fail(f"scripts: {what} launched not every kernel of {modes}: {launches}")
    bench = run_script("bench_consensus_kernel_torch", "--reps", "3")
    for row in bench["shapes"]:
        log(f"  K2p T={row['T']} RL={row['RL']} N={row['N']}: "
            + (row["refused"] if "refused" in row else
               f"full {row['full_ms']:.3f} ms, scan {row['scan_ms']:.3f} ms"
               + (f", max_abs_err {row['max_abs_err']}" if "max_abs_err" in row else "")))
        if "refused" in row or row.get("max_abs_err", 0):
            fail(f"scripts: the K2p bench failed at T={row['T']} N={row['N']}")


def phase_c(ref: dict, tmp: str, phase5) -> list:
    """Phase C at each of ``PHASE_C_SIZES`` through ``run_pipeline`` on
    the card, in a process of its own (``scripts/phase_c_torch.py``),
    held to the JAX package's run of the same files: outputs, stage
    artifacts and every closed gap by digest, counts, and the main path's
    kernels launched; then the store-overflow run
    (:func:`phase_c_overflow`); then each kernel at the buckets the runs
    launched that phase 5 (``phase5``, its recorder) did not
    (:func:`phase_c_holds`).  Returns the launch tables of phase 5 and of
    the three runs."""
    import torch

    out = run_script("phase_c_torch", "--dir", tmp)
    runs = {run["key"]: run for run in out["runs"]}
    tables = []
    log(f"  {out['nvidia_smi']}; kernels loaded in {out['build_seconds']:.1f} s")
    for mb, gaps in PHASE_C_SIZES:
        what = f"phase C {mb} Mb / {gaps} gaps"
        want, run = ref[str(mb)], runs.get(str(mb))
        if run is None:
            fail(f"{what}: phase_c_torch ran no such size: {sorted(runs)}")
        got = run["digests"]
        log(f"{what}: {run['wall_s']:.2f} s wall (datagen {run['datagen_s']:.1f} s, "
            f"digests {run['digest_s']:.1f} s); stages {json.dumps(run['stage_s'])}")
        log(f"  closed {got['closed']}, {got['closed_exactly']} byte-exact, "
            f"inexact {got['inexact']} (JAX: {want['closed']}, "
            f"{want['closed_exactly']}, {want['inexact']}); K1p "
            f"{run['launches'].get('K1p', 0)}, store resets {run['store_resets']}; "
            f"peak device memory {run['peak_device_gib']:.3f} GiB, peak RSS "
            f"{run['peak_rss_gib']:.2f} GiB")
        log(f"  launches {json.dumps(run['launches'])}")
        tables.append(torch.load(os.path.join(tmp, f"phase_c_{mb}", "launches.pt"),
                                 map_location="cuda", weights_only=False))
        log_buckets(tables[-1])
        log(f"  differing from JAX: {run['differs'] or 'none'}")
        check_hashes(os.path.join(tmp, f"phase_c_{mb}"), "out", want["sha256"], what)
        if run["differs"]:
            fail(f"{what}: differs from the JAX package's run in {run['differs']}")
        log("  FASTA, AGP, BED, every stage artifact and every closed gap "
            "equal to the JAX package's (sha256)")
        if (got["closed"] < want["closed"]
                or got["closed_exactly"] < want["closed_exactly"]):
            fail(f"{what}: {got['closed']} closed, {got['closed_exactly']} "
                 f"byte-exact; JAX {want['closed']} and {want['closed_exactly']}")
        missing = [m for m in MAIN_PATH_KERNELS if not run["launches"].get(m)]
        if missing:
            fail(f"{what}: {missing} not launched: {run['launches']}")
    tables.append(phase_c_overflow(ref, tmp))
    phase_c_holds(tables, phase5)
    return [vars(phase5)] + tables


def phase_c_overflow(ref: dict, tmp: str) -> dict:
    """Phase 16's third run: phase C at ``OVERFLOW_SIZE`` through
    ``run_pipeline`` in this process, with a device store of
    ``OVERFLOW_STORE_MB`` MiB (see the module's docstring), held to the
    same reference entry as the resident run; returns its recorder's
    tables."""
    from dentist_tpu_torch.dryrun import LaunchRecorder
    from dentist_tpu_torch.ops import banded
    from dentist_tpu_torch.scenarios import (diff_digests, run_phase_c,
                                             write_phase_c)

    mb, gaps = OVERFLOW_SIZE
    what = f"phase C {mb} Mb / {gaps} gaps, {OVERFLOW_STORE_MB} MiB store"
    want = ref[str(mb)]
    d = os.path.join(tmp, f"phase_c_{mb}_overflow")
    sc, asm, reads, datagen = write_phase_c(d, mb, gaps, want["inputs"])
    rec = LaunchRecorder()
    run = run_phase_c(sc, asm, reads, d, True, recorder=rec,
                      store_capacity=OVERFLOW_STORE_MB << 20)
    banded.reset_device_store()  # the card's store for the phases after
    got, launches = run["digests"], run["launches"]
    log(f"{what}: {run['wall_s']:.2f} s wall (datagen {datagen:.1f} s, digests "
        f"{run['digest_s']:.1f} s); stages {json.dumps(run['stage_seconds'])}")
    log(f"  store {run['store_mib']:.0f} MiB, {run['store_resets']} resets; "
        f"K1 {launches.get('K1', 0)}, K1p {launches.get('K1p', 0)}, K5 "
        f"{launches.get('K5', 0)}; closed {got['closed']}, "
        f"{got['closed_exactly']} byte-exact; launches {json.dumps(launches)}")
    differs = diff_digests(want, got)
    log(f"  differing from JAX: {differs or 'none'}")
    if differs:
        fail(f"{what}: differs from the JAX package's run in {differs}")
    if not (launches.get("K1") and launches.get("K1p") and run["store_resets"] >= 1):
        fail(f"{what}: K1 {launches.get('K1', 0)}, K1p {launches.get('K1p', 0)} "
             f"and {run['store_resets']} resets; each must be at least 1")
    if (got["closed"] < want["closed"]
            or got["closed_exactly"] < want["closed_exactly"]):
        fail(f"{what}: {got['closed']} closed, {got['closed_exactly']} "
             f"byte-exact; JAX {want['closed']} and {want['closed_exactly']}")
    log("  FASTA, AGP, BED, every stage artifact and every closed gap equal "
        "to the JAX package's (sha256), with the reads on host windows")
    return rec.tables()


def phase_c_holds(tables: list, phase5) -> None:
    """Phase 3 for phase 16: at every bucket and K5 upload size that
    phase C's runs (their recorders' ``tables()``) launched and phase 5
    (its recorder) did not (:func:`hold_buckets`)."""
    hold_buckets(new_buckets(tables, [vars(phase5)]), "phase C's", "phase 5")


def new_buckets(tables: list, seen: list) -> dict:
    """The buckets and K5 upload sizes that the runs of ``tables``
    (recorders' ``tables()``) launched and none of ``seen`` (the same, or
    ``vars()`` of a recorder) did, their counts summed, in the same
    layout."""
    new = {"k1": {}, "k2": {}, "k3": {}, "k4": {}, "k5": []}
    had = lambda name, key: any(key in s[name] for s in seen)
    sizes = {n for s in seen for n, _ in s["k5"]}
    for t in tables:
        for name in ("k1", "k2"):
            for key, row in t[name].items():
                if not had(name, key):
                    have = new[name].get(key, [0] * len(row))
                    new[name][key] = [a + b for a, b in zip(have, row)]
        for key, r in t["k3"].items():
            if not had("k3", key):
                have = new["k3"].setdefault(key, {})
                for name, x in r.items():
                    have[name] = have[name] + x if name in have else x
        for key, r in t["k4"].items():
            if not had("k4", key):
                have = new["k4"].setdefault(key, dict(r, launches=0, live=0))
                have["launches"] += r["launches"]
                have["live"] += r["live"]
        new["k5"] += [(n, off) for n, off in t["k5"] if n not in sizes]
    return new


def hold_buckets(new: dict, runs: str, before: str) -> None:
    """Phase 3 again for ``new`` (:func:`new_buckets`): each kernel
    against its plain version (tolerance 0) at every bucket and K5 upload
    size in it, as phase 3 holds phase 5's, on the first launch's own
    inputs for K4 and K4w; K1 without K1p and K2p without K2, the modes
    the pipeline launches."""
    log(f"{runs} launches at buckets {before} did not launch:")
    log_buckets(new)
    phase_k1(new["k1"], None, legacy=(), packed=False)
    phase_k2(new["k2"], None, full=False)
    phase_k3(new["k3"], None)
    phase_k4(new["k4"], None, {})
    if new["k5"]:
        phase_k5(new["k5"], None)
    log(f"{runs} buckets: every kernel equal to its plain version")


def suite_reference() -> dict:
    """``scenarios.SUITE_REFERENCE``'s contents."""
    from dentist_tpu_torch.scenarios import SUITE_REFERENCE

    try:
        with open(SUITE_REFERENCE) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        fail(f"suite: cannot read the JAX package's digests: {exc}")


def suite_plan(ref: dict) -> list:
    """The scenarios phase 19 runs, ``scenarios.SUITE``'s keys in order;
    fails unless the reference (:func:`suite_reference`) holds exactly
    these, in that order."""
    from dentist_tpu_torch.scenarios import SUITE

    keys = list(SUITE)
    if list(ref.get("scenarios", {})) != keys:
        fail(f"suite: the reference holds {list(ref.get('scenarios', {}))}, "
             f"not the scenarios {keys}")
    return keys


def phase_suite(ref: dict, seen: list) -> None:
    """Phase 19: every suite scenario through the port on the card, held
    to the JAX package's digests, every main-path kernel launched; then
    each kernel against its plain version at every bucket and K5 upload
    size the scenarios launched that none of ``seen`` (phase 5's and
    phase 16's launch tables) did (:func:`hold_buckets`)."""
    import torch

    from dentist_tpu_torch import scenarios
    from dentist_tpu_torch.dryrun import LaunchRecorder
    from dentist_tpu_torch.ops import banded

    t_all = time.perf_counter()
    keys = suite_plan(ref)
    mods = scenarios.port_modules()
    banded.reset_device_store()
    reset_launch_counts()
    walls = {}
    with LaunchRecorder() as rec:
        for key in keys:
            t0 = time.perf_counter()
            got = scenarios.suite_digests(key, scenarios.run_suite(key, mods))
            torch.cuda.synchronize()
            walls[key] = round(time.perf_counter() - t0, 3)
            want = ref["scenarios"][key]["digests"]
            if got != want:
                fail(f"suite {key} ({scenarios.SUITE[key]}): digests {got} != "
                     f"the JAX package's {want}")
    launches = launch_counts()
    runs_s = time.perf_counter() - t_all
    log(f"suite: {len(keys)} scenarios of the JAX package's tests in "
        f"{runs_s:.2f} s, every digest equal to its run's; seconds "
        f"{json.dumps(walls)}")
    log(f"  launches {json.dumps({k: n for k, n in launches.items() if n})}")
    missing = [m for m in MAIN_PATH_KERNELS if not launches[m]]
    if missing:
        fail(f"suite: {missing} not launched: {launches}")
    hold_buckets(new_buckets([vars(rec)], seen), "the suite's",
                 "phases 5 and 16")
    log(f"suite: {time.perf_counter() - t_all:.1f} s in all, the holds "
        f"{time.perf_counter() - t_all - runs_s:.1f} s")


def phase_bench() -> None:
    """Phase 18: ``bench_torch.py --small`` as a process on the card (see
    the module's docstring)."""
    line = run_script("bench_torch", "--small", "--trials", str(BENCH_TRIALS),
                      where="")
    if line.get("gates_passed") != BENCH_GATES:
        fail(f"bench: gates passed {line.get('gates_passed')}, not {BENCH_GATES}")
    close, trials = line["pipeline_trial_seconds"], line["pipeline_trials"]
    if len(close) != BENCH_TRIALS or len(trials) != BENCH_TRIALS:
        fail(f"bench: {len(close)} phase C trials timed, {len(trials)} recorded; "
             f"{BENCH_TRIALS} wanted")
    for i, t in enumerate(trials):
        missing = [m for m in MAIN_PATH_KERNELS if not t["launches"].get(m)]
        if missing:
            fail(f"bench: phase C trial {i} launched not {missing}: {t['launches']}")
    log(f"  {line['nvidia_smi']}; kernels loaded in {line['build_seconds']:.1f} s, "
        f"warmup {line['warmup_seconds']:.2f} s")
    log(f"  phase A: {line['reads_aligned_per_second_per_chip']:.2f} reads/s, "
        f"trials {json.dumps([round(x, 2) for x in line['align_trial_seconds']])} s; "
        f"phase B: {line['pileups_per_second']:.2f} pile-ups/s, trials "
        f"{json.dumps([round(x, 2) for x in line['process_trial_seconds']])} s")
    log(f"  phase C {line['scenario_e2e']['mb']} Mb / {line['n_gaps_e2e']} gaps: "
        f"headline {line['value']:.3f}x the reference's 420 s; close_gaps median "
        f"{line['pipeline_seconds']:.2f} s, band "
        f"{json.dumps([round(x, 2) for x in close])} s (trial 0 first); run_pipeline "
        f"{json.dumps([round(x, 2) for x in line['run_pipeline_trial_seconds']])} s; "
        f"{line['n_closed_gaps_e2e']} closed; gates {', '.join(BENCH_GATES)} passed")


def run_logged(argv: list, what: str, **kw) -> str:
    """Run ``argv``; its standard output, or fail with its output's tail."""
    proc = subprocess.run(argv, capture_output=True, text=True, **kw)
    if proc.returncode:
        fail(f"{what} exited {proc.returncode}:\n"
             f"{(proc.stdout + proc.stderr)[-4000:]}")
    return proc.stdout


def field(out: str, name: str) -> str:
    """The value of the line ``name: value`` of ``out``."""
    for line in out.splitlines():
        if line.startswith(f"{name}: "):
            return line[len(name) + 2:]
    fail(f"no '{name}:' line in:\n{out[-4000:]}")


def phase_installed(smi: str) -> None:
    """Phase 17: the port installed from a wheel into a prefix outside
    the repo, its kernels built by the packaging's build command, then
    ``packaging/torch/smoke-test.sh`` run against it without a compiler
    in reach (see the module's docstring)."""
    import shutil

    t0 = time.perf_counter()
    py = sys.executable
    native = os.path.join(HERE, "native")
    run_logged(["make", "-C", native], "make -C native")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_install_") as tmp:
        src, wheels, prefix, cwd = (os.path.join(tmp, d)
                                    for d in ("src", "wheels", "prefix", "run"))
        os.makedirs(cwd)
        shutil.copytree(os.path.join(HERE, "dentist_tpu_torch"),
                        os.path.join(src, "dentist_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for name in ("pyproject.toml", "README.md"):
            shutil.copy(os.path.join(HERE, name), src)
        pip = [py, "-m", "pip", "--disable-pip-version-check"]
        pip_env = dict(os.environ, PIP_NO_INDEX="1")
        run_logged([*pip, "wheel", "--no-deps", "--no-build-isolation",
                    "--no-index", "-q", "-w", wheels, src], "pip wheel",
                   cwd=cwd, env=pip_env, timeout=300)
        (wheel,) = os.listdir(wheels)
        run_logged([*pip, "install", "--no-deps", "--no-index", "-q",
                    "--target", prefix, os.path.join(wheels, wheel)],
                   "pip install --target", cwd=cwd, env=pip_env, timeout=300)
        csrc = sorted(os.listdir(os.path.join(prefix, "dentist_tpu_torch", "csrc")))
        log(f"installed port: {wheel} into {prefix}; csrc/ {csrc}")

        build_env = dict(os.environ, PYTHONPATH=prefix)
        out = run_logged([py, "-m", "dentist_tpu_torch._build"],
                         "the kernel build command", cwd=cwd, env=build_env,
                         timeout=600)
        so, build_s = field(out, "library"), float(field(out, "build seconds").split()[0])
        if not so.startswith(prefix + os.sep) or not os.path.exists(so) or build_s <= 0:
            fail(f"installed port: the build command gave {so} in {build_s} s, "
                 f"not a fresh library under {prefix}")
        log(f"  python -m dentist_tpu_torch._build: {so} in {build_s:.1f} s, "
            f"{len(ptxas_lines(out))} kernels in ptxas's report")

        kernels = os.path.dirname(so)
        listing = {n: os.stat(os.path.join(kernels, n)).st_mtime_ns
                   for n in os.listdir(kernels)}
        path = [os.path.join(prefix, "bin"), os.path.dirname(py)] + [
            d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
        env = {k: v for k, v in build_env.items() if k != "CUDA_HOME"}
        env.update(PATH=os.pathsep.join(path),
                   DENTIST_TPU_NATIVE=os.path.join(native, "libdentistnative.so"))
        out = run_logged(["sh", "-e", os.path.join(HERE, "packaging", "torch",
                                                   "smoke-test.sh")],
                         "packaging/torch/smoke-test.sh", cwd=cwd, env=env,
                         timeout=600)
        after = {n: os.stat(os.path.join(kernels, n)).st_mtime_ns
                 for n in os.listdir(kernels)}
        package = field(out, "package")
        launches = json.loads(field(out, "launches"))
        wall = float(field(out, "pipeline seconds"))
        if not package.startswith(prefix + os.sep):
            fail(f"installed port: the smoke test imported {package}, not {prefix}'s")
        if float(field(out, "build seconds")) != 0.0 or after != listing:
            fail(f"installed port: the smoke test built the kernels: "
                 f"{field(out, 'build seconds')} s, _build/ {listing} -> {after}")
        if not launches["K1"] or not (launches["K2p"] or launches["K2r"]):
            fail(f"installed port: K1 and K2p or K2r not launched: {launches}")
    log(f"  smoke test: {package}, kernels loaded without a build (build "
        f"seconds 0.0, _build/ unchanged: {sorted(listing)}); 60 kb pipeline "
        f"{wall:.2f} s, FASTA, AGP and BED equal to the JAX package's (sha256)")
    log(f"  launched: {json.dumps({k: n for k, n in launches.items() if n})}")
    log(f"installed port: {time.perf_counter() - t0:.1f} s in all, kernel build "
        f"{build_s:.1f} s; {smi}")


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
        from dentist_tpu_torch.device import card_line, require_cuda, set_device
    except ImportError as exc:
        fail(f"dentist_tpu_torch is not importable next to this script: {exc}")

    # 1. device
    require_cuda()
    set_device("cuda")
    smi = card_line()
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
        launches, sc, rec, wall_a = phase_a(tmp)
        # 3, K1, K1p, K2, K2p, K2r, K3, K3p, K4, K4w and K5: at the buckets
        # and upload sizes phase 5 launched
        rows = (phase_k1(rec.k1, baselines.get("extend.cu"))
                + phase_k2(rec.k2, baselines.get("nw_round.cu"))
                + phase_k3(rec.k3, baselines.get("nw_dist.cu"))
                + phase_k4(rec.k4, baselines.get("round_pack.cu"), k4_fixed)
                + phase_k5(rec.k5, baselines.get("store_write.cu"))
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
        staged_walls = phase_staged(tmp, sc)
        # 11. the masking stages where there are repeats
        phase_repeats(tmp)
        # 12. resume phase 5's call from its workdir
        phase_resume(tmp, wall_a)
        # 13. two scaffolds, reads over repeats, a validation purge
        phase_scaffolds(tmp)
        # 14. phase 10's two consensus batches as two processes at once
        phase_two_processes(tmp, staged_walls)
    # 15. the profiling and bench scripts as processes on the card
    phase_scripts()
    # 16. phase C at 3 and 28 Mb against the JAX package's digests, and at
    # 3 Mb with the reads overflowing the store; 3 at the buckets they
    # launched that phase 5 did not
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c_") as tmp:
        seen = phase_c(phase_c_reference(), tmp, rec)
    # 17. the installed port: a wheel in a prefix outside the repo, the
    # kernels prebuilt by the packaging's build command, its smoke test
    phase_installed(smi)
    # 18. the port's bench, phase C at 3 Mb
    phase_bench()
    # 19. the JAX package's suite scenarios by digest; 3 at the buckets they
    # launched that phases 5 and 16 did not
    phase_suite(suite_reference(), seen)

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
