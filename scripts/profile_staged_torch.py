"""The staged workflow's sub-commands with their host time attributed:
how much of each is FASTA parsing.

    python scripts/profile_staged_torch.py [--device cuda|cpu]
        [--scenario phase-a|e2e]

Writes ``bench.py``'s phase A (``scenarios.phase_a_scenario()``; ``e2e``
the 60 kb ``tests/test_e2e.py`` scenario, for a quick run) to a
temporary directory with its truth, then runs
``scenarios.staged_commands`` (``chip_smoke.py`` phase 10's
workflow: one sub-command per stage) through ``cli.main`` in this
process on ``--device`` (the card unless ``cpu`` is asked for), the
kernels built first (timed apart).  Each sub-command runs under a
:class:`~dentist_tpu_torch.utils.stacks.StackSampler`.  Diagnostics go
to stderr; the last line of stdout is one JSON object with the card's
``nvidia-smi`` name and power limit and, per stage, its wall, the
seconds under ``io/fasta.py:read_fasta`` (FASTA parsing, every thread),
under ``load_reads`` and ``load_assembly`` (parsing and building the
stores) and the five functions of greatest cumulative time.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contextlib  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

#: the loaders whose cumulative seconds each stage reports
LOADERS = ("io/fasta.py:read_fasta", "models/sequences.py:load_reads",
           "models/sequences.py:load_assembly")


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scenario", default="phase-a", choices=("phase-a", "e2e"))
    args = ap.parse_args()

    from dentist_tpu_torch import _build, cli
    from dentist_tpu_torch.device import card_line, set_device
    from dentist_tpu_torch.scenarios import (e2e_scenario, phase_a_scenario,
                                             staged_commands, write_scenario,
                                             write_truth)
    from dentist_tpu_torch.utils.stacks import StackSampler

    dev = set_device(args.device)
    cuda = dev.type == "cuda"
    smi = card_line() if cuda else None
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="profile_staged_") as d:
        sc = phase_a_scenario() if args.scenario == "phase-a" else e2e_scenario()
        write_scenario(sc, d)
        write_truth(sc, d)
        stages = {}
        for stage, argv in staged_commands(d):
            sampler = StackSampler()
            t0 = time.perf_counter()
            with sampler, contextlib.redirect_stdout(sys.stderr):
                rc = cli.main([*argv, "-q"], device=args.device)
                if cuda:
                    torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc:
                sys.exit(f"{stage}: {argv[0]} exited {rc}")
            loaders = {m.split(":")[1]: sum(sampler.seconds_in(m).values())
                       for m in LOADERS}
            stages[stage] = {
                "wall_s": wall, "loaders_s": loaders,
                "fasta_share": loaders["read_fasta"] / wall,
                "cumulative": sampler.report(5).get("other", {}).get("cumulative", []),
            }
            print(f"{stage}: {wall:.2f} s, FASTA parsing {loaders['read_fasta']:.2f} s "
                  f"({100 * loaders['read_fasta'] / wall:.0f} %); loaders "
                  f"{json.dumps({k: round(v, 2) for k, v in loaders.items()})}",
                  file=sys.stderr, flush=True)
    print(json.dumps({"script": "profile_staged_torch", "scenario": args.scenario,
                      "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "nvidia_smi": smi, "build_seconds": build_s,
                      "sampler_interval_ms": sampler.interval * 1e3, "stages": stages}))


if __name__ == "__main__":
    main()
