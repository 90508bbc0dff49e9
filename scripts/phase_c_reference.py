"""The JAX package's run of phase C that ``chip_smoke.py`` phases 15 and
16 hold the port to.

    JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 \\
        python scripts/phase_c_reference.py DIR [--mb 28 --gaps 147]

Writes ``dentist_tpu_torch.scenarios.phase_c_scenario(mb, gaps)`` to
``DIR`` (``assembly.fasta``, ``reads.fasta``, ``truth.fasta``), runs the
JAX package's command line on them with every stage artifact kept in
``DIR/work``,

    python -m dentist_tpu.cli pipeline assembly.fasta reads.fasta \\
        out.fasta --read-coverage 20 --workdir DIR/work -q
    python -m dentist_tpu.cli check-results truth.fasta assembly.fasta \\
        out.fasta -j

and stores the run's digests (``scenarios.phase_c_digests``: inputs,
outputs, stage artifacts, one per closed gap, the counts) with its stage
seconds, wall and provenance under the key ``str(mb)`` of ``--json``
(default ``scripts/phase_c_reference.json``), keeping the other
sizes' entries.  ``--reuse`` takes the pipeline's outputs and timing
from an earlier run in ``DIR`` instead of running it again.  The JAX
CPU backend takes about ten minutes at 3 Mb and hours at 28 Mb.
"""

import argparse
import contextlib
import datetime
import io
import json
import os
import platform
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_JSON = os.path.join(ROOT, "scripts", "phase_c_reference.json")


def _cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _run(d, asm, reads, out, truth):
    """The JAX pipeline and ``check-results``; returns the timing record
    it also writes to ``d/run.json``."""
    from dentist_tpu import cli
    from dentist_tpu.utils.log import STAGE_SECONDS, reset_stage_seconds

    reset_stage_seconds()
    t0 = time.perf_counter()
    if cli.main(["pipeline", asm, reads, out, "--read-coverage", "20",
                 "--workdir", os.path.join(d, "work"), "-q"]):
        sys.exit("the JAX pipeline failed")
    wall = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(["check-results", truth, asm, out, "-j"]):
            sys.exit("check-results failed")
    js = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec = {"wall_s": wall,
           "stage_s": {k: STAGE_SECONDS[k] for k in sorted(STAGE_SECONDS)},
           "numClosedGaps": js["numClosedGaps"],
           "numCorrectGaps": js["numCorrectGaps"],
           "peak_rss_gib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 2**20}
    with open(os.path.join(d, "run.json"), "w") as fh:
        json.dump(rec, fh)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir")
    ap.add_argument("--mb", type=float, default=28)
    ap.add_argument("--gaps", type=int, default=147)
    ap.add_argument("--json", default=DEFAULT_JSON)
    ap.add_argument("--reuse", action="store_true")
    a = ap.parse_args()

    import jax

    from dentist_tpu_torch.scenarios import (phase_c_digests,
                                             phase_c_scenario, write_scenario,
                                             write_truth)

    d = a.dir
    t0 = time.perf_counter()
    sc = phase_c_scenario(mb=a.mb, n_gaps=a.gaps)
    asm, reads = write_scenario(sc, d)
    truth = write_truth(sc, d)
    print(f"scenario written in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    out = os.path.join(d, "out.fasta")
    if a.reuse:
        with open(os.path.join(d, "run.json")) as fh:
            rec = json.load(fh)
    else:
        rec = _run(d, asm, reads, out, truth)
    entry = phase_c_digests(sc, d, os.path.join(d, "work"))
    entry.update(rec)
    entry["scenario"] = {"mb": a.mb, "gaps": a.gaps}
    entry["provenance"] = {
        "command": ("python -m dentist_tpu.cli pipeline assembly.fasta "
                    "reads.fasta out.fasta --read-coverage 20 --workdir "
                    "work -q; python -m dentist_tpu.cli check-results "
                    "truth.fasta assembly.fasta out.fasta -j"),
        "env": "JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1",
        "cpu": f"{_cpu_name()} ({os.cpu_count()} cores)",
        "jax": jax.__version__,
        "date": datetime.date.today().isoformat(),
    }
    ref = {}
    if os.path.exists(a.json):
        with open(a.json) as fh:
            ref = json.load(fh)
    ref[f"{a.mb:g}"] = entry
    with open(a.json, "w") as fh:
        json.dump(dict(sorted(ref.items(), key=lambda kv: float(kv[0]))), fh,
                  indent=1, sort_keys=True)
        fh.write("\n")
    print(json.dumps({k: entry[k] for k in ("closed", "closed_exactly",
                                            "inexact", "numClosedGaps",
                                            "numCorrectGaps", "wall_s")}))


if __name__ == "__main__":
    main()
