"""The JAX package's run of the suite scenarios that ``chip_smoke.py``
phase 19 and ``tests/test_torch_suite_*.py`` hold the port to.

    JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 \\
        python scripts/jax_suite_reference.py [--json scripts/jax_suite_reference.json]

Runs each scenario of ``dentist_tpu_torch.scenarios.SUITE`` (the
gap-closing cases of the JAX package's ``tests/test_anchor_unique.py``,
``test_bubbles.py``, ``test_overlap_crop.py``, ``test_multiscaffold.py``
and ``test_validation_pass.py``, and the read sets of
``tests/test_consensus.py``, built with those tests' seeds and sizes)
through the JAX package's ``pipeline``, ``mapper``, ``pileups``,
``process`` and ``consensus`` modules with ``scenarios.run_suite``, as
those tests call them, and writes each one's digests
(``scenarios.suite_digests``), the JAX test it stands for and its
seconds under ``"scenarios"``, with the run's provenance (command,
machine, versions), to ``--json``.  About two minutes on an 8-core
x86-64 CPU.
"""

import argparse
import datetime
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_JSON = os.path.join(ROOT, "scripts", "jax_suite_reference.json")


def _cpu_name() -> str:
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return platform.processor() or platform.machine()


def jax_modules():
    """The JAX package's modules ``scenarios.run_suite`` calls."""
    from types import SimpleNamespace

    from dentist_tpu import pipeline
    from dentist_tpu.models import pileups, process
    from dentist_tpu.ops import consensus, mapper

    return SimpleNamespace(pipeline=pipeline, mapper=mapper, pileups=pileups,
                           process=process, consensus=consensus)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=DEFAULT_JSON)
    a = ap.parse_args()

    import jax

    from dentist_tpu_torch.scenarios import SUITE, run_suite, suite_digests

    mods = jax_modules()
    t_all = time.perf_counter()
    scenarios = {}
    for key, test in SUITE.items():
        t0 = time.perf_counter()
        digests = suite_digests(key, run_suite(key, mods))
        seconds = time.perf_counter() - t0
        scenarios[key] = {"test": test, "digests": digests, "seconds": seconds}
        print(f"{key}: {seconds:.1f} s {json.dumps(digests)}", file=sys.stderr,
              flush=True)
    ref = {
        "scenarios": scenarios,
        "wall_s": time.perf_counter() - t_all,
        "provenance": {
            "command": "python scripts/jax_suite_reference.py",
            "env": "JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1",
            "cpu": f"{_cpu_name()} ({os.cpu_count()} cores)",
            "jax": jax.__version__,
            "date": datetime.date.today().isoformat(),
        },
    }
    with open(a.json, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    print(json.dumps({"scenarios": len(scenarios), "wall_s": ref["wall_s"]}))


if __name__ == "__main__":
    main()
