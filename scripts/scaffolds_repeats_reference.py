"""The JAX package's run that ``chip_smoke.py`` phase 13 is held against.

    JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 \\
        python scripts/scaffolds_repeats_reference.py DIR

Writes ``dentist_tpu_torch.scenarios.scaffolds_repeats_scenario()`` to
``DIR`` (``assembly.fasta``, ``reads.fasta``), runs the JAX package's
``run_pipeline`` on those two files (read coverage 20, validation on,
workdir ``DIR/work``), then its ``_validation_pass`` on the result
against ``scenarios.unrelated_reads()``, and prints one JSON line: the
sha256 of the FASTA, AGP and BED, the gaps closed and closed byte-exact,
the dust and repeat mask interval counts, and the skip set.  The JAX CPU
backend takes a few minutes at this size.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def main():
    from dentist_tpu.io.store import load_mask
    from dentist_tpu.models.sequences import SeqStore
    from dentist_tpu.pipeline import (PipelineConfig, _validation_pass,
                                      run_pipeline)
    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             scaffolds_repeats_scenario,
                                             unrelated_reads, write_scenario)

    d = sys.argv[1]
    sc = scaffolds_repeats_scenario()
    asm, reads = write_scenario(sc, d)
    out = os.path.join(d, "out.fasta")
    cfg = PipelineConfig(read_coverage=20.0, workdir=os.path.join(d, "work"))
    result = run_pipeline(asm, reads, out, cfg)
    noise = unrelated_reads()
    store = SeqStore(np.concatenate(noise), np.array([len(r) for r in noise]))
    skip = _validation_pass(result, noise, store, cfg)
    masks = {name: len(load_mask(os.path.join(d, "work", f"{name}.mask.npz")))
             for name in ("dust", "repeats", "repeats-H")}
    print(json.dumps({
        "sha256": {name: _sha256(os.path.join(d, name)) for name in
                   ("out.fasta", "out.agp", "out.closed-gaps.bed")},
        "closed": result.n_closed_gaps,
        "exact": closed_exactly_in(sc, out),
        "mask_intervals": masks,
        "skip": sorted(list(p) for p in skip),
    }))


if __name__ == "__main__":
    main()
