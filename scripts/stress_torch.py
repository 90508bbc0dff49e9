"""End-to-end stress run of the PyTorch port at 10, 50 or 100 Mb.

    python scripts/stress_torch.py [--mb=10] [--device cuda|cpu] [--timings]

The port of ``scripts/stress10.py``, with its scenario: an ``mb`` Mb
random genome with ``4 * mb`` copies of a 3 kb interspersed repeat,
``mb`` gaps of 100-1000 bp at a 50 kb margin, and 20x reads of 25 kb ±
12.5 kb at 13 % error (seeds 42-45).  It runs ``close_gaps`` once on
``--device`` (the card unless ``cpu`` is asked for), checks the result
against the truth with ``check_results``, and prints one JSON line: the
wall and stage seconds, peak host RSS, peak device memory, the gap
counts of ``check_results``, and the launches of K1 (extension from the
device store), K1p (extension from 2-bit host windows: the store
overflowed) and K5 (2-bit store uploads), with the store's resets.
"""

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timings", action="store_true",
                    help="log every stage's timing line")
    args = ap.parse_args()

    from dentist_tpu_torch.device import set_device
    from dentist_tpu_torch.dryrun import launch_counts, reset_launch_counts
    from dentist_tpu_torch.eval.check_results import check_results
    from dentist_tpu_torch.io.fasta import FastaRecord, seq_to_codes
    from dentist_tpu_torch.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu_torch.ops import banded
    from dentist_tpu_torch.pipeline import PipelineConfig, close_gaps
    from dentist_tpu_torch.sim.genome import insert_repeats, random_genome
    from dentist_tpu_torch.sim.partial import build_partial_assembly, random_gaps
    from dentist_tpu_torch.sim.reads import simulate_reads
    from dentist_tpu_torch.utils.log import (STAGE_SECONDS,
                                             reset_stage_seconds,
                                             set_log_level)

    dev = set_device(args.device)
    if args.timings:
        set_log_level("diagnostic")
    mb = args.mb
    t0 = time.time()
    g = random_genome(mb * 1_000_000, seed=42)
    g = insert_repeats(g, n_copies=4 * mb, repeat_length=3000, seed=43)
    truth = [g]
    gaps = random_gaps(truth, n_gaps=mb, min_size=100, max_size=1000,
                       margin=50_000, seed=44)
    asm = build_partial_assembly(truth, gaps)
    records = [FastaRecord(f"scaf{i}", s) for i, s in enumerate(asm)]
    contigs, structure = split_scaffolds(records)
    reads, _ = simulate_reads(truth, coverage=20.0, mean_length=25_000,
                              sd_length=12_500, error=0.13, seed=45)
    reads_store = SeqStore(np.concatenate(reads),
                           np.array([len(r) for r in reads]),
                           [f"read{i+1}" for i in range(len(reads))])
    datagen_s = time.time() - t0
    print(f"datagen {datagen_s:.0f}s: {len(reads)} reads "
          f"({sum(len(r) for r in reads)/1e6:.0f} Mb)", file=sys.stderr,
          flush=True)

    reset_stage_seconds()
    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    epoch0 = banded.device_store().epoch
    t0 = time.time()
    result = close_gaps(contigs, structure, reads_store, reads,
                        PipelineConfig(read_coverage=20.0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    pipeline_s = time.time() - t0
    launches = launch_counts()
    print(f"pipeline {pipeline_s:.0f}s", file=sys.stderr, flush=True)
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    peak_device_gb = (torch.cuda.max_memory_allocated() / 2**30
                      if dev.type == "cuda" else None)
    stage_seconds = {
        "masks": STAGE_SECONDS.get("dentist_tpu_torch.pipeline.masks_for", 0.0),
        "collect": STAGE_SECONDS.get("stage.collect", 0.0),
        "process": STAGE_SECONDS.get("stage.process", 0.0),
        "output": STAGE_SECONDS.get("stage.output", 0.0),
        "validation": STAGE_SECONDS.get(
            "dentist_tpu_torch.pipeline._validation_pass", 0.0),
    }

    res_codes = [seq_to_codes(seq) for _, seq in result.records]
    js = check_results(truth, structure, contigs, res_codes).to_json()
    print(json.dumps({
        "mb": mb,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "datagen_seconds": datagen_s,
        "pipeline_seconds": pipeline_s,
        "stage_seconds": stage_seconds,
        "peak_rss_gb": peak_rss_gb,
        "peak_device_gb": peak_device_gb,
        "n_reads": len(reads),
        "launches": {k: launches[k] for k in ("K1", "K1p", "K5")},
        "store_resets": banded.device_store().epoch - epoch0,
        "numClosedGaps": js["numClosedGaps"],
        "numCorrectGaps": js["numCorrectGaps"],
        "perIdentity": js["numCorrectGapsPerIdentityLevel"],
        "averageInsertionError": js["averageInsertionError"],
    }))


if __name__ == "__main__":
    main()
