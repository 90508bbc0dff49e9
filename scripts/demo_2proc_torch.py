"""Two port processes sharing one GPU: the reference's ``--batch`` model.

    python scripts/demo_2proc_torch.py [--mb=2]

The port of ``scripts/demo_2proc.py``, with its 2 Mb scenario (``4 * mb``
copies of a 3 kb repeat, ``4 * mb`` gaps of 100-600 bp, 20x reads of
25 kb ± 12.5 kb at 13 % error; seeds 90-93):

1. this process maps the reads on the card, builds a coverage repeat
   mask and collects pile-ups, and saves them in the staged CLI's
   container formats,
2. one ``python -m dentist_tpu_torch process-pile-ups`` process consenses
   every pile-up (the single-process stage),
3. two such processes run concurrently, ``--batch 0..half`` and
   ``--batch half..n``, each holding its own CUDA context and device
   store on the same card,
4. ``merge-insertions`` combines their halves, and the merged insertions
   must equal the single process's, record by record.

Prints one JSON line: the single-process and two-process stage seconds,
their ratio, and the identity check; exits non-zero if they differ.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from dentist_tpu_torch.device import set_device  # noqa: E402
from dentist_tpu_torch.io.fasta import codes_to_seq, write_fasta  # noqa: E402
from dentist_tpu_torch.io.store import (load_insertions,  # noqa: E402
                                        save_alignments, save_mask,
                                        save_pile_ups)
from dentist_tpu_torch.models.mask import (coverage_mask,  # noqa: E402
                                           pack_chain_intervals)
from dentist_tpu_torch.models.pileups import (ChainCtx,  # noqa: E402
                                              CollectConfig, collect_pile_ups)
from dentist_tpu_torch.models.sequences import (SeqStore,  # noqa: E402
                                                load_assembly)
from dentist_tpu_torch.ops.mapper import MapperConfig, map_reads  # noqa: E402
from dentist_tpu_torch.sim.genome import (insert_repeats,  # noqa: E402
                                          random_genome)
from dentist_tpu_torch.sim.partial import (build_partial_assembly,  # noqa: E402
                                           random_gaps)
from dentist_tpu_torch.sim.reads import simulate_reads  # noqa: E402


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=2)
    args = ap.parse_args()

    set_device("cuda")
    with tempfile.TemporaryDirectory(prefix="dtpu-torch-2proc-") as wd:
        run(args.mb, wd)


def run(mb: int, wd: str):
    g = random_genome(mb * 1_000_000, seed=90)
    g = insert_repeats(g, n_copies=4 * mb, repeat_length=3000, seed=91)
    truth = [g]
    gaps = random_gaps(truth, n_gaps=4 * mb, min_size=100, max_size=600,
                       margin=30_000, seed=92)
    asm = build_partial_assembly(truth, gaps)
    write_fasta(os.path.join(wd, "asm.fasta"),
                [(f"scaf{i}", codes_to_seq(s)) for i, s in enumerate(asm)])
    reads, _ = simulate_reads(truth, coverage=20.0, mean_length=25_000,
                              sd_length=12_500, error=0.13, seed=93)
    write_fasta(os.path.join(wd, "reads.fasta"),
                [(f"read{i+1}", codes_to_seq(r)) for i, r in enumerate(reads)])

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def cli(*argv):
        r = subprocess.run([sys.executable, "-m", "dentist_tpu_torch", *argv],
                           capture_output=True, text=True, env=env, cwd=wd)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            raise SystemExit(1)
        return r.stdout

    # front half in this process, persisted as the cluster jobs would
    # read it from the filesystem: map -> repeat mask -> collect
    contigs, structure = load_assembly(os.path.join(wd, "asm.fasta"))
    store = SeqStore(np.concatenate(reads),
                     np.array([len(r) for r in reads]),
                     [f"read{i+1}" for i in range(len(reads))])
    las, chains = map_reads(contigs.codes, contigs.offsets, contigs.lengths,
                            reads, config=MapperConfig(),
                            query_store=(store.codes, store.offsets))
    rep = coverage_mask(pack_chain_intervals(las), contigs.lengths, 0, 60)
    pile_ups = collect_pile_ups(ChainCtx(las, chains, contigs.lengths,
                                         store.lengths),
                                structure.gaps, rep, CollectConfig(),
                                contigs=contigs, reads=store)
    save_alignments(os.path.join(wd, "reads.las.npz"), las, chains)
    save_mask(os.path.join(wd, "rep.mask.npz"), rep)
    save_pile_ups(os.path.join(wd, "pile-ups.npz"), pile_ups)
    n_pu = len(pile_ups)

    def run_process(tag, batch=None):
        argv = ["process-pile-ups", "asm.fasta", "reads.fasta",
                "reads.las.npz", "pile-ups.npz", f"ins-{tag}.npz",
                "--mask", "rep.mask.npz"]
        if batch:
            argv += ["--batch", batch]
        return subprocess.Popen(
            [sys.executable, "-m", "dentist_tpu_torch", *argv],
            env=env, cwd=wd, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)

    def wait(*procs):
        for p in procs:
            _, err = p.communicate()
            if p.returncode != 0:
                print(err[-3000:], file=sys.stderr)
                raise SystemExit(1)

    t0 = time.time()
    wait(run_process("single"))
    single_s = time.time() - t0

    half = n_pu // 2
    t0 = time.time()
    wait(run_process("a", batch=f"0..{half}"),
         run_process("b", batch=f"{half}..{n_pu}"))
    two_s = time.time() - t0
    cli("merge-insertions", "ins-merged.npz", "ins-a.npz", "ins-b.npz")

    a = load_insertions(os.path.join(wd, "ins-merged.npz"))
    b = load_insertions(os.path.join(wd, "ins-single.npz"))
    identical = len(a) == len(b) and all(
        x.start_node == y.start_node and x.end_node == y.end_node
        and np.array_equal(x.sequence, y.sequence)
        and x.read_ids == y.read_ids
        for x, y in zip(a, b))
    print(json.dumps({
        "n_pile_ups": n_pu,
        "process_stage_seconds_1proc": single_s,
        "process_stage_seconds_2proc": two_s,
        "two_process_speedup": single_s / max(two_s, 1e-9),
        "merged_equals_single": identical,
        "n_insertions": len(a),
    }))
    if not identical:
        raise SystemExit("2-process merged insertions != single-process")


if __name__ == "__main__":
    main()
