#!/bin/sh
# Container smoke test of dentist-tpu-torch, the PyTorch/CUDA port: run
# inside the image on a Hopper card (`docker run --gpus all --entrypoint
# dentist-tpu-torch-smoke-test <image>`, `apptainer test --nv <image>.sif`).
# Asserts that the CLI dispatches, the native library loads, the kernel
# library is the one built with the image (the first launch builds
# nothing), and that the 60 kb scenario's pipeline, run on the card,
# writes the FASTA, AGP and BED of the JAX package's own run, byte for
# byte.  Prints the installed package, each kernel's launches in that run,
# the pipeline's seconds and the kernels' build seconds.  Run with `sh -e`:
# any failure exits non-zero.
set -e

dentist-tpu-torch --commands > /dev/null
echo "ok: CLI command registry"

python3 - <<'EOF'
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import dentist_tpu_torch
from dentist_tpu_torch import _build, cli
from dentist_tpu_torch.dryrun import launch_counts
from dentist_tpu_torch.native import native_available
from dentist_tpu_torch.scenarios import e2e_scenario, write_scenario

# sha256 of the outputs of the JAX package's own run on the same two files,
#   JAX_PLATFORMS=cpu DENTIST_TPU_FORCE_SINGLE=1 python -m dentist_tpu.cli \
#       pipeline assembly.fasta reads.fasta out.fasta --read-coverage 20 -q
# (chip_smoke.py's E2E_SHA256; a test keeps the two equal)
E2E_SHA256 = {
    "out.fasta": "9b020ffd563fc37cfef45ff22de97dddf938e209d61a98d43965ff6f22117d85",
    "out.agp": "da8ffdb0dac133429bdd91899234a72494a2138c50af012acfc72a38096f9bee",
    "out.closed-gaps.bed": "61fa6fce8358b86aead07d38941b89939d2ded88bccfdda74ae1d0f4b0a30251",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        sys.exit(f"smoke test: FAIL: {what}")


check(native_available(), "native library failed to load")
print("ok: native library")

package = Path(dentist_tpu_torch.__file__).resolve().parent
print(f"package: {package}")
so = _build.library_path()
check(so.parent == package / "_build" and so.exists(),
      f"no prebuilt kernel library at {so}")
_build.library()
check(_build.build_seconds == 0.0,
      f"the kernels were built at run time ({_build.build_seconds:.1f} s)")
print(f"ok: kernel library {so}, prebuilt")

with tempfile.TemporaryDirectory() as d:
    asm, reads = write_scenario(e2e_scenario(), d)
    t0 = time.perf_counter()
    rc = cli.main(["pipeline", asm, reads, os.path.join(d, "out.fasta"),
                   "--read-coverage", "20", "-q"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"pipeline exited {rc}")
    for name, want in E2E_SHA256.items():
        with open(os.path.join(d, name), "rb") as fh:
            got = hashlib.sha256(fh.read()).hexdigest()
        check(got == want, f"{name} sha256 {got} != JAX {want}")
print(f"launches: {json.dumps(launch_counts())}")
print(f"pipeline seconds: {wall:.3f}")
print(f"build seconds: {_build.build_seconds}")
check(_build.build_seconds == 0.0, "the kernels were built during the run")
print("ok: 60 kb pipeline on the card, FASTA, AGP and BED equal to the "
      "JAX package's")
EOF
echo "smoke test passed"
