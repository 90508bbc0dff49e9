"""The JAX package's run of ``bench.py``'s phases A and B that
``bench_torch.py`` holds the port to.

    JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 \\
        python scripts/bench_reference.py [--json scripts/bench_reference.json]

Builds ``dentist_tpu_torch.scenarios.phase_a_scenario()`` (``bench.py``'s
3 Mb / 16-gap scenario, 2,394 reads) and calls the JAX package as
``bench.py:93-160`` does: ``map_reads`` over every read with the read
set passed as ``query_store``; ``ChainCtx``, the repeat mask
``coverage_mask(pack_chain_intervals(las), l, 0, 3 * 20)`` and
``collect_pile_ups``; then ``process_pile_ups``.  Writes the results'
digests (``scenarios.result_digests``: the arrays' sha256 of the
alignments, chains, pile-ups and insertions, as ``io.store`` saves
them), their counts, each call's seconds and the run's provenance
(command, machine, versions) to ``--json``.  About ten minutes on an
8-core x86-64 CPU.
"""

import argparse
import datetime
import json
import os
import platform
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_JSON = os.path.join(ROOT, "scripts", "bench_reference.json")

#: ``bench.py``'s read coverage, which sets the repeat mask's ceiling
COVERAGE = 20.0


def _cpu_name() -> str:
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return platform.processor() or platform.machine()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=DEFAULT_JSON)
    a = ap.parse_args()

    import jax
    import numpy as np

    from dentist_tpu.models.mask import coverage_mask, pack_chain_intervals
    from dentist_tpu.models.pileups import (ChainCtx, CollectConfig,
                                            collect_pile_ups)
    from dentist_tpu.models.process import ProcessConfig, process_pile_ups
    from dentist_tpu.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu.ops.mapper import MapperConfig, map_reads
    from dentist_tpu_torch.scenarios import phase_a_scenario, result_digests

    t_all = time.perf_counter()
    sc = phase_a_scenario()
    contigs, structure = split_scaffolds(sc.assembly)
    reads = sc.reads
    c, o, l = contigs.codes, contigs.offsets, contigs.lengths
    lengths = np.array([len(r) for r in reads])
    read_store = (np.concatenate(reads),
                  np.concatenate([[0], np.cumsum(lengths)])[:-1])
    seconds = {}

    t0 = time.perf_counter()
    las, chains = map_reads(c, o, l, reads, config=MapperConfig(),
                            query_store=read_store)
    seconds["map_reads"] = time.perf_counter() - t0
    print(f"map_reads: {len(las)} alignments in {len(chains)} chains, "
          f"{seconds['map_reads']:.1f} s", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    ctx = ChainCtx(las, chains, contigs.lengths, lengths)
    reads_store = SeqStore(np.concatenate(reads), lengths,
                           [f"read{i + 1}" for i in range(len(reads))])
    repeat_mask = coverage_mask(pack_chain_intervals(las), l, 0,
                                3 * int(COVERAGE))
    pile_ups = collect_pile_ups(ctx, structure.gaps, repeat_mask,
                                CollectConfig(), contigs=contigs,
                                reads=reads_store)
    seconds["collect_pile_ups"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    insertions = process_pile_ups(pile_ups, ctx, contigs, reads_store,
                                  repeat_mask, ProcessConfig())
    seconds["process_pile_ups"] = time.perf_counter() - t0
    print(f"process_pile_ups: {len(pile_ups)} pile-ups, {len(insertions)} "
          f"insertions, {seconds['process_pile_ups']:.1f} s", file=sys.stderr,
          flush=True)

    ref = {
        "scenario": {"name": "phase_a_scenario", "mb": 3, "gaps": 16,
                     "reads": len(reads), "coverage": COVERAGE},
        "digests": result_digests(las, chains, pile_ups, insertions),
        "n_alignments": len(las),
        "n_chains": len(chains),
        "n_pile_ups": len(pile_ups),
        "n_insertions": len(insertions),
        "seconds": seconds,
        "wall_s": time.perf_counter() - t_all,
        "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "provenance": {
            "command": "python scripts/bench_reference.py",
            "env": "JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1",
            "cpu": f"{_cpu_name()} ({os.cpu_count()} cores)",
            "jax": jax.__version__,
            "date": datetime.date.today().isoformat(),
        },
    }
    with open(a.json, "w") as fh:
        json.dump(ref, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(json.dumps({k: ref[k] for k in ("digests", "n_alignments", "n_chains",
                                          "n_pile_ups", "n_insertions", "wall_s")}))


if __name__ == "__main__":
    main()
