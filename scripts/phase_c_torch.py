"""Phase C through the port's ``run_pipeline``, held to the JAX package's
run by digest.

    python scripts/phase_c_torch.py [--mb 28] [--dir DIR] [--device cuda|cpu]

For each entry of ``scripts/phase_c_reference.json`` (the JAX package's
CPU runs, written by ``scripts/phase_c_reference.py``), or only the one
of ``--mb``: writes ``scenarios.phase_c_scenario(mb, gaps)`` under
``DIR`` (a temporary directory unless given), stops with an error if the
inputs do not hash as the entry's (the data generator drifted), runs
``run_pipeline`` with a workdir on ``--device`` (the card unless ``cpu``
is asked for) from a fresh device store, and takes the run's digests
(``scenarios.phase_c_digests``).  Prints one JSON line last: per size
the wall, datagen, digest and stage seconds, the launches per kernel and
per bucket with their live lanes (``dryrun.LaunchRecorder.summary``;
its ``tables()``, the K4 and K4w inputs with them, go to
``DIR/phase_c_MB/launches.pt``), store resets, peak device memory and
host RSS (GiB), the digests and what differs from the entry
(``scenarios.diff_digests``), beside the card's ``nvidia-smi`` name and
power limit and the kernels' build seconds.  ``chip_smoke.py`` phase 16 runs it in a process of its own,
so the first size is a process's first call.
"""

import json
import os
import resource
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from dentist_tpu_torch import _build  # noqa: E402
from dentist_tpu_torch.device import card_line, set_device  # noqa: E402
from dentist_tpu_torch.dryrun import (LaunchRecorder, launch_counts,  # noqa: E402
                                      reset_launch_counts)
from dentist_tpu_torch.ops import banded  # noqa: E402
from dentist_tpu_torch.pipeline import (STAGE_SECONDS, PipelineConfig,  # noqa: E402
                                        reset_stage_seconds, run_pipeline)
from dentist_tpu_torch.scenarios import (diff_digests, file_sha256,  # noqa: E402
                                         phase_c_digests, phase_c_scenario,
                                         write_scenario, write_truth)

REFERENCE = os.path.join(ROOT, "scripts", "phase_c_reference.json")


def run_phase_c(d: str, mb: float, gaps: int, want_inputs: dict, cuda: bool) -> dict:
    """One size through ``run_pipeline`` in directory ``d``; its record."""
    t0 = time.perf_counter()
    sc = phase_c_scenario(mb=mb, n_gaps=gaps)
    asm, reads = write_scenario(sc, d)
    write_truth(sc, d)
    datagen = time.perf_counter() - t0
    for path in (asm, reads):
        name, got = os.path.basename(path), file_sha256(path)
        if got != want_inputs[name]:
            sys.exit(f"phase C {mb:g} Mb: the data generator drifted: {name} "
                     f"sha256 {got} != the reference's {want_inputs[name]}")
    banded.reset_device_store()
    reset_stage_seconds()
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    epoch0 = banded.device_store().epoch
    with LaunchRecorder() as rec:
        t0 = time.perf_counter()
        run_pipeline(asm, reads, os.path.join(d, "out.fasta"),
                     PipelineConfig(read_coverage=20.0,
                                    workdir=os.path.join(d, "work")))
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    torch.save(rec.tables(), os.path.join(d, "launches.pt"))
    run = {"datagen_s": datagen, "wall_s": wall,
           "stage_s": {k.rsplit(".", 1)[-1]: round(v, 3)
                       for k, v in STAGE_SECONDS.items()},
           "launches": {k: v for k, v in launch_counts().items() if v},
           "store_resets": banded.device_store().epoch - epoch0,
           "peak_device_gib": (torch.cuda.max_memory_allocated() / 2**30
                               if cuda else None),
           "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "buckets": rec.summary()}
    t0 = time.perf_counter()
    run["digests"] = phase_c_digests(sc, d, os.path.join(d, "work"))
    run["digest_s"] = time.perf_counter() - t0
    return run


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", help="one size of the reference (default: every one)")
    ap.add_argument("--dir", help="keep each size's files in DIR/phase_c_MB")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    dev = set_device(args.device)
    cuda = dev.type == "cuda"
    smi = card_line() if cuda else None
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
    with open(REFERENCE) as fh:
        ref = json.load(fh)
    sizes = [args.mb] if args.mb else sorted(ref, key=float)
    runs = []
    with tempfile.TemporaryDirectory(prefix="phase_c_") as tmp:
        for key in sizes:
            want = ref[key]
            d = os.path.join(args.dir or tmp, f"phase_c_{key}")
            run = run_phase_c(d, want["scenario"]["mb"], want["scenario"]["gaps"],
                              want["inputs"], cuda)
            run.update(key=key, differs=diff_digests(want, run["digests"]))
            print(f"phase C {key} Mb: {run['wall_s']:.2f} s, differs from the "
                  f"JAX package's run in {run['differs'] or 'nothing'}",
                  file=sys.stderr, flush=True)
            runs.append(run)
    print(json.dumps({
        "script": "phase_c_torch",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": smi,
        "build_seconds": build_s,
        "runs": runs,
    }))


if __name__ == "__main__":
    main()
