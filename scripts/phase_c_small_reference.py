"""The JAX package's run that ``chip_smoke.py`` phase 15 is held against.

    JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 \\
        python scripts/phase_c_small_reference.py DIR

Writes ``dentist_tpu_torch.scenarios.phase_c_scenario(mb=3, n_gaps=16)``
(the ``--small`` form of ``scripts/profile_e2e_torch.py``) to ``DIR``
(``assembly.fasta``, ``reads.fasta``, ``truth.fasta``), runs the JAX
package's command line on them,

    python -m dentist_tpu.cli pipeline assembly.fasta reads.fasta \\
        out.fasta --read-coverage 20 -q
    python -m dentist_tpu.cli check-results truth.fasta assembly.fasta \\
        out.fasta -j

and prints one JSON line: the sha256 of the FASTA, AGP and BED, the
gaps closed and closed byte-exact (gap ± 500 bp against the truth), and
``check-results``' ``numClosedGaps`` and ``numCorrectGaps``.  The JAX
CPU backend takes several minutes at this size.
"""

import contextlib
import hashlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def main():
    from dentist_tpu import cli
    from dentist_tpu_torch.scenarios import (closed_exactly_in,
                                             phase_c_scenario, write_scenario,
                                             write_truth)

    d = sys.argv[1]
    sc = phase_c_scenario(mb=3, n_gaps=16)
    asm, reads = write_scenario(sc, d)
    truth = write_truth(sc, d)
    out = os.path.join(d, "out.fasta")
    if cli.main(["pipeline", asm, reads, out, "--read-coverage", "20", "-q"]):
        sys.exit("the JAX pipeline failed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(["check-results", truth, asm, out, "-j"]):
            sys.exit("check-results failed")
    js = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps({
        "sha256": {name: _sha256(os.path.join(d, name)) for name in
                   ("out.fasta", "out.agp", "out.closed-gaps.bed")},
        "closed_exactly": closed_exactly_in(sc, out),
        "numClosedGaps": js["numClosedGaps"],
        "numCorrectGaps": js["numCorrectGaps"],
    }))


if __name__ == "__main__":
    main()
