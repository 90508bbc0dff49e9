"""Phase C through the port's ``close_gaps``, with its host time attributed.

    python scripts/profile_e2e_torch.py [--small] [--calls N]
        [--device cuda|cpu] [--mb MB --gaps N]

The port of ``scripts/profile_e2e.py``.  It builds ``bench.py``'s phase C
(``scenarios.phase_c_scenario``: a 28 Mb genome with 112 copies of a
3 kb repeat, 147 gaps of 100-1000 bp, 20x reads of 25 kb ± 12.5 kb at
13 % error, seeds 321-324; ``--small`` is its 3 Mb / 16-gap form, and
``--mb``/``--gaps`` set other sizes of the same model), builds the
kernels (timed apart), then runs ``close_gaps`` ``--calls`` times in
this process on ``--device`` (the card unless ``cpu`` is asked for).
Every call runs under a :class:`~dentist_tpu_torch.utils.stacks.StackSampler`,
which charges host time to functions, stages (mapping, self-alignment,
process, validation, ...) and threads, the pools' workers included;
the ``DENTIST_TPU_PROF=1`` sections (``utils/prof.py``) are on; the last
call on the card also runs under ``torch.profiler`` with CUDA activity
only, for the card's busy share.  Diagnostics go to stderr, the section
and host tables among them; the last line of stdout is one JSON object:
the card's ``nvidia-smi`` name and power limit, the build and datagen
seconds, and per call the wall, stage seconds, kernel launches, store
resets, peak device memory and the ten functions of greatest cumulative
and self time in each stage; the last call's sections and busy share;
peak host RSS; and for the first call (every call's records must be
equal) ``check_results``' gap counts and the gaps not closed byte-exact
(gap ± 500 bp, ``scenarios.inexact_gaps``).
"""

import os
import sys

os.environ.setdefault("DENTIST_TPU_PROF", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contextlib  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

#: ``STAGE_SECONDS`` keys by stage, as ``scripts/stress_torch.py`` reads them
STAGE_KEYS = {
    "masks": "dentist_tpu_torch.pipeline.masks_for",
    "masks.dust+tandem": "masks.dust+tandem",
    "masks.selfAlignment": "masks.selfAlignment",
    "masks.mapReads": "masks.mapReads",
    "masks.homogenize": "masks.homogenize",
    "collect": "stage.collect",
    "process": "stage.process",
    "output": "stage.output",
    "validation": "dentist_tpu_torch.pipeline._validation_pass",
}


def main():
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="the 3 Mb / 16-gap form of the scenario")
    ap.add_argument("--mb", type=float, help="genome Mb (default 28; 3 with --small)")
    ap.add_argument("--gaps", type=int, help="gaps (default 147; 16 with --small)")
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    from dentist_tpu_torch import _build
    from dentist_tpu_torch.device import card_line, device_busy, set_device
    from dentist_tpu_torch.dryrun import launch_counts, reset_launch_counts
    from dentist_tpu_torch.eval.check_results import check_results
    from dentist_tpu_torch.io.fasta import seq_to_codes
    from dentist_tpu_torch.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu_torch.ops import banded
    from dentist_tpu_torch.pipeline import PipelineConfig, close_gaps
    from dentist_tpu_torch.scenarios import inexact_gaps, phase_c_scenario
    from dentist_tpu_torch.utils import prof
    from dentist_tpu_torch.utils.log import STAGE_SECONDS, reset_stage_seconds
    from dentist_tpu_torch.utils.stacks import (PIPELINE_STAGES, StackSampler,
                                                format_report)

    dev = set_device(args.device)
    cuda = dev.type == "cuda"
    mb = args.mb or (3 if args.small else 28)
    n_gaps = args.gaps or (16 if args.small else 147)
    smi = card_line() if cuda else None
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = phase_c_scenario(mb=mb, n_gaps=n_gaps)
    contigs, structure = split_scaffolds(sc.assembly)
    reads = sc.reads
    store = SeqStore(np.concatenate(reads), np.array([len(r) for r in reads]),
                     [f"read{i + 1}" for i in range(len(reads))])
    datagen_s = time.perf_counter() - t0
    print(f"{smi or 'cpu'}; build {build_s} s; datagen {datagen_s:.1f} s: "
          f"{mb} Mb, {len(structure.gaps)} gaps, {len(reads)} reads "
          f"({store.codes.size / 1e6:.0f} M characters)", file=sys.stderr,
          flush=True)

    calls, digests, first = [], [], None
    for i in range(args.calls):
        traced = cuda and i == args.calls - 1
        reset_stage_seconds()
        reset_launch_counts()
        prof._acc.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        epoch0 = banded.device_store().epoch if cuda else 0
        sampler = StackSampler(stages=PIPELINE_STAGES)
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as trace:
            t0 = time.perf_counter()
            with sampler:
                result = close_gaps(contigs, structure, store, reads,
                                    PipelineConfig(read_coverage=20.0))
                if cuda:
                    torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        host = sampler.report(10)
        call = {
            "wall_s": wall,
            "stage_seconds": {k: STAGE_SECONDS.get(v, 0.0)
                              for k, v in STAGE_KEYS.items()},
            "launches": {k: v for k, v in launch_counts().items() if v},
            "store_resets": banded.device_store().epoch - epoch0 if cuda else 0,
            "peak_device_gib": (torch.cuda.max_memory_allocated() / 2**30
                                if cuda else None),
            "closed_gaps": result.n_closed_gaps,
            "samples": sampler.samples,
            "host": host,
        }
        print(f"call {i}: {wall:.2f} s, {result.n_closed_gaps} gaps closed; "
              f"stages {json.dumps({k: round(v, 2) for k, v in call['stage_seconds'].items()})}; "
              f"launches {json.dumps(call['launches'])}", file=sys.stderr)
        print(format_report(host, sampler.interval), file=sys.stderr)
        if traced:
            busy_ms, by_name = device_busy(trace)
            call["busy"] = {"ms": busy_ms, "share": busy_ms / 1e3 / wall,
                            "by_name": {k[:80]: v for k, v in list(by_name.items())[:12]}}
            print(f"device busy {busy_ms:.1f} ms of {wall:.2f} s "
                  f"({100 * busy_ms / 1e3 / wall:.2f} %)", file=sys.stderr)
        call["sections"] = {k: v for k, v in sorted(prof._acc.items())}
        prof.prof_report()
        calls.append(call)
        digests.append(hashlib.sha256(repr(result.records).encode()).hexdigest())
        if first is None:
            first = result
        sys.stderr.flush()

    res_codes = [seq_to_codes(seq) for _, seq in first.records]
    js = check_results(sc.truths, structure, contigs, res_codes).to_json()
    inexact = inexact_gaps(sc, res_codes)
    print(json.dumps({
        "script": "profile_e2e_torch",
        "scenario": {"mb": mb, "n_gaps": len(structure.gaps), "n_reads": len(reads),
                     "read_characters": int(store.codes.size)},
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": smi,
        "build_seconds": build_s,
        "datagen_seconds": datagen_s,
        "sampler_interval_ms": sampler.interval * 1e3,
        "calls": calls,
        "records_equal_across_calls": len(set(digests)) == 1,
        "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "numClosedGaps": js["numClosedGaps"],
        "numCorrectGaps": js["numCorrectGaps"],
        "perIdentity": js["numCorrectGapsPerIdentityLevel"],
        "closed_exactly": len(structure.gaps) - len(inexact),
        "inexact_gaps": inexact,
    }))


if __name__ == "__main__":
    main()
