"""Phase C through the port's ``run_pipeline``, held to the JAX package's
run by digest.

    python scripts/phase_c_torch.py [--mb 28] [--dir DIR] [--device cuda|cpu]
                                    [--store-mb N]

For each entry of ``scripts/phase_c_reference.json`` (the JAX package's
CPU runs, written by ``scripts/phase_c_reference.py``), or only the one
of ``--mb``, through the package's phase C runner, which
``bench_torch.py`` shares: ``scenarios.write_phase_c`` writes
``scenarios.phase_c_scenario(mb, gaps)`` under ``DIR`` (a temporary
directory unless given) and stops with an error if the inputs do not
hash as the entry's (the data generator drifted);
``scenarios.run_phase_c`` runs ``run_pipeline`` with a workdir on
``--device`` (the card unless ``cpu`` is asked for) from a fresh device
store (of ``--store-mb`` MiB where given: a store that holds the
assembly and not the reads sends their alignment to host windows, K1p,
and resets the store, as a 100 Mb assembly's reads do with the default
one), every launch recorded, and takes the run's digests
(``scenarios.phase_c_digests``).  Prints one JSON line last: per size
the wall, datagen, digest and stage seconds, the launches per kernel and
per bucket with their live lanes (``dryrun.LaunchRecorder.summary``;
its ``tables()``, the K4 and K4w inputs with them, go to
``DIR/phase_c_MB/launches.pt``), the store's size and resets, peak
device memory and
host RSS (GiB), the digests and what differs from the entry
(``scenarios.diff_digests``), beside the card's ``nvidia-smi`` name and
power limit and the kernels' build seconds.  ``chip_smoke.py`` phase 16
runs it in a process of its own, so the first size is a process's first
call.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from dentist_tpu_torch import _build  # noqa: E402
from dentist_tpu_torch.device import card_line, set_device  # noqa: E402
from dentist_tpu_torch.dryrun import LaunchRecorder  # noqa: E402
from dentist_tpu_torch.scenarios import (diff_digests, run_phase_c,  # noqa: E402
                                         write_phase_c)

REFERENCE = os.path.join(ROOT, "scripts", "phase_c_reference.json")


def phase_c_size(d: str, mb: float, gaps: int, want_inputs: dict, cuda: bool,
                 store_mb: int | None = None) -> dict:
    """One size through ``run_pipeline`` in directory ``d``, every launch
    recorded, with a device store of ``store_mb`` MiB (default: the
    card's); its record."""
    sc, asm, reads, datagen = write_phase_c(d, mb, gaps, want_inputs)
    rec = LaunchRecorder()
    run = run_phase_c(sc, asm, reads, d, cuda, recorder=rec,
                      store_capacity=store_mb and store_mb << 20)
    torch.save(rec.tables(), os.path.join(d, "launches.pt"))
    return {"datagen_s": datagen, "wall_s": run["wall_s"],
            "stage_s": {k.rsplit(".", 1)[-1]: round(v, 3)
                        for k, v in run["stage_seconds"].items()},
            **{k: run[k] for k in ("launches", "store_mib", "store_resets",
                                   "peak_device_gib",
                                   "peak_rss_gib", "buckets", "digests",
                                   "digest_s")}}


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", help="one size of the reference (default: every one)")
    ap.add_argument("--dir", help="keep each size's files in DIR/phase_c_MB")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--store-mb", type=int,
                    help="a device store of N MiB for each run (default: the "
                         "card's, 2 GiB less 16 MiB)")
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
            run = phase_c_size(d, want["scenario"]["mb"], want["scenario"]["gaps"],
                               want["inputs"], cuda, args.store_mb)
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
