"""The port needs no JAX, and without a GPU it refuses to run.

Both checks run in subprocesses: one imports the port with every
``jax`` import blocked; the other runs ``chip_smoke.py`` on a machine
without a GPU, which must fail without printing a result — there is no
silent CPU fallback on the main path.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = """
import builtins, sys
_real = builtins.__import__
def _no_jax(name, *a, **k):
    if name == "jax" or name.startswith("jax."):
        raise ImportError("jax is blocked")
    return _real(name, *a, **k)
builtins.__import__ = _no_jax
for m in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    del sys.modules[m]
"""


def _run(code: str, *args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args] if args else
                          [sys.executable, "-c", code],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_without_jax():
    proc = _run(_BLOCK_JAX + """
import dentist_tpu_torch, dentist_tpu_torch.pipeline, dentist_tpu_torch.__main__
import dentist_tpu_torch.scenarios, dentist_tpu_torch.parallel.dp
import dentist_tpu_torch.dryrun, dentist_tpu_torch.ops.pack2
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("imported")
""")
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_no_file_of_the_port_imports_jax():
    pkg = os.path.join(ROOT, "dentist_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in text and "from jax" not in text, f
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "jax" not in smoke.replace("JAX", "")
    assert "import dentist_tpu\n" not in smoke and "from dentist_tpu." not in smoke


def test_chip_smoke_fails_without_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    proc = _run("", "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_cli_refuses_cuda_without_gpu_and_unported_commands(tmp_path):
    import torch

    proc = _run("", "-m", "dentist_tpu_torch", "dust", "a.fasta", "b.npz")
    assert proc.returncode != 0
    assert "not yet ported to dentist_tpu_torch" in proc.stderr
    if torch.cuda.is_available():
        return
    proc = _run("", "-m", "dentist_tpu_torch", "pipeline", "a.fasta",
                "r.fasta", str(tmp_path / "o.fasta"))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
