"""Profile the port's process (consensus) stage on phase A's scenario.

    python scripts/profile_process_torch.py [--device cuda|cpu]
        [--scenario phase-a|e2e]

The port of ``scripts/profile_process.py``.  It builds ``bench.py``'s
phase A (``scenarios.phase_a_scenario()``: 3 Mb, 16 gaps, 20x reads;
``--scenario e2e`` takes the 60 kb ``tests/test_e2e.py`` scenario for a
quick run), builds the kernels (timed apart), runs ``map_reads``
and ``collect_pile_ups`` on ``--device`` (the card unless ``cpu`` is
asked for), then ``process_pile_ups`` twice untimed by any profiler and
once under a :class:`~dentist_tpu_torch.utils.stacks.StackSampler`
(every thread, the pools' workers included; ``cProfile`` cannot see
them on Python 3.12, see ``utils/stacks.py``).  Diagnostics go to
stderr; the last line of stdout is one JSON object: the card's
``nvidia-smi`` name and power limit, the build, mapping and collect
seconds, each process trial's wall, the sampled trial's wall beside the
best unsampled one, its kernel launches and host table (the ten
functions of greatest cumulative and self time, with their threads),
peak host RSS and peak device memory.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402
import resource  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scenario", default="phase-a", choices=("phase-a", "e2e"))
    args = ap.parse_args()

    from dentist_tpu_torch import _build
    from dentist_tpu_torch.device import card_line, set_device
    from dentist_tpu_torch.dryrun import launch_counts, reset_launch_counts
    from dentist_tpu_torch.models.mask import coverage_mask, pack_chain_intervals
    from dentist_tpu_torch.models.pileups import (ChainCtx, CollectConfig,
                                                  collect_pile_ups)
    from dentist_tpu_torch.models.process import ProcessConfig, process_pile_ups
    from dentist_tpu_torch.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu_torch.ops.mapper import MapperConfig, map_reads
    from dentist_tpu_torch.scenarios import e2e_scenario, phase_a_scenario
    from dentist_tpu_torch.utils.stacks import StackSampler, format_report

    dev = set_device(args.device)
    cuda = dev.type == "cuda"
    smi = card_line() if cuda else None
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0

    sc = phase_a_scenario() if args.scenario == "phase-a" else e2e_scenario()
    reads = sc.reads
    contigs, structure = split_scaffolds(sc.assembly)
    c, o, l = contigs.codes, contigs.offsets, contigs.lengths

    def timed(fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (las, chains), map_s = timed(map_reads, c, o, l, reads, config=MapperConfig())
    print(f"{smi or 'cpu'}; build {build_s} s; map {map_s:.2f} s", file=sys.stderr)
    ctx = ChainCtx(las, chains, contigs.lengths, np.array([len(r) for r in reads]))
    store = SeqStore(np.concatenate(reads), np.array([len(r) for r in reads]),
                     [f"read{i + 1}" for i in range(len(reads))])
    repeat_mask = coverage_mask(pack_chain_intervals(las), l, 0, 60)
    pile_ups, collect_s = timed(collect_pile_ups, ctx, structure.gaps, repeat_mask,
                                CollectConfig(), contigs=contigs, reads=store)
    print(f"collect {collect_s:.2f} s, {len(pile_ups)} pile-ups", file=sys.stderr)

    def process():
        return timed(process_pile_ups, pile_ups, ctx, contigs, store,
                     repeat_mask, ProcessConfig())

    walls = []
    for trial in range(2):
        insertions, wall = process()
        walls.append(wall)
        print(f"process trial {trial}: {wall:.2f} s, {len(insertions)} insertions",
              file=sys.stderr)
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sampler = StackSampler(stages=(("process", ("models/process.py:process_pile_ups",)),))
    with sampler:
        insertions, sampled = process()
    host = sampler.report(10)
    print(f"sampled trial: {sampled:.2f} s ({sampler.samples} samples)",
          file=sys.stderr)
    print(format_report(host, sampler.interval), file=sys.stderr)
    print(json.dumps({
        "script": "profile_process_torch",
        "scenario": {"name": args.scenario, "n_reads": len(reads),
                     "n_pile_ups": len(pile_ups)},
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": smi,
        "build_seconds": build_s,
        "map_seconds": map_s,
        "collect_seconds": collect_s,
        "process_seconds": walls,
        "sampled_process_seconds": sampled,
        "sampled_over_best_unsampled": sampled / min(walls),
        "insertions": len(insertions),
        "launches": {k: v for k, v in launch_counts().items() if v},
        "sampler_interval_ms": sampler.interval * 1e3,
        "samples": sampler.samples,
        "host": host,
        "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "peak_device_gib": (torch.cuda.max_memory_allocated() / 2**30
                            if cuda else None),
    }))


if __name__ == "__main__":
    main()
