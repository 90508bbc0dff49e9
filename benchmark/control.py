"""Readings of a cell on many seeds in one process: the program as it
is, its control, or a planted fault (``benchmark/faults.py``), for
setting the limits of the check.

    python benchmark/control.py --workload NAME --seeds 1,2,3 --seconds S \\
        [--fault polish_off|lanes_left_out|diffs_raised|none] [--warm once]

For each seed this runs the whole cell (set-up, window, check) with the
fault planted (the default is the control, ``polish_off``; ``none``
plants nothing) and prints one JSON line per seed with every compared
number, whether the run came out correct, and each pipeline's wall, CPU
seconds and stage seconds.  ``--warm once`` runs the
warm-up pipeline for the first seed only: the readings do not depend on
it.  The benchmark's own runs never run this.  Needs the card, as a run
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import faults  # noqa: E402
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default="polish_off",
                    choices=[*faults.FAULTS, "none"])
    ap.add_argument("--warm", default="each", choices=("each", "once"))
    args = ap.parse_args(argv)
    patch = faults.FAULTS.get(args.fault)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, args.seconds, False, patch=patch,
                           warmup=args.warm == "each" or i == 0)
        line = out["line"]
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": line["correct"],
                          "numbers": {k: v["value"] for k, v in line["checks"].items()},
                          "info": line["info"],
                          "units": [{k: u[k] for k in ("wall_s", "cpu_s", "stages")}
                                    for u in out["record"]["units"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
