"""The port needs neither JAX nor the JAX package, and without a GPU it
refuses to run.

The checks run in subprocesses: they import every module of the port,
and build the 60 kb scenario and the suite scenarios, with every ``jax``
and ``dentist_tpu`` import blocked (``dentist_tpu_torch`` stays importable); a static check
reads every file of the port for such imports; and ``chip_smoke.py``
runs on a machine without a GPU, where it must fail without printing a
result — there is no silent CPU fallback on the main path.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level packages the port must not import
_BLOCKED = ("jax", "dentist_tpu")

_BLOCK_JAX = """
import builtins, sys
_real = builtins.__import__
_blocked = ("jax", "dentist_tpu")
def _is_blocked(name):
    return any(name == b or name.startswith(b + ".") for b in _blocked)
def _no_jax(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and _is_blocked(name):
        raise ImportError(name + " is blocked")
    return _real(name, globals, locals, fromlist, level)
builtins.__import__ = _no_jax
for m in [m for m in sys.modules if _is_blocked(m)]:
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
import dentist_tpu_torch.cli, dentist_tpu_torch.eval.check_results
import dentist_tpu_torch.eval.check_scaffolding, dentist_tpu_torch.eval.closable
import dentist_tpu_torch.ops.qv, dentist_tpu_torch.io.dazzler
assert not any(_is_blocked(m) for m in sys.modules)
print("imported")
""")
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_every_port_module_imports_without_jax_or_the_jax_package():
    proc = _run(_BLOCK_JAX + """
import importlib, pkgutil
import dentist_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dentist_tpu_torch.__path__,
                                               "dentist_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(_is_blocked(m) for m in sys.modules)
print("imported", len(names))
""")
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40, proc.stdout


def test_e2e_scenario_builds_without_jax_or_the_jax_package():
    proc = _run(_BLOCK_JAX + """
from dentist_tpu_torch import scenarios
sc = scenarios.e2e_scenario()
assert len(sc.reads) > 100 and len(sc.assembly) == 1
assert not any(_is_blocked(m) for m in sys.modules)
print("built", len(sc.reads))
""")
    assert proc.returncode == 0, proc.stderr
    assert "built" in proc.stdout


def test_suite_scenarios_build_without_jax_or_the_jax_package():
    """Every suite scenario (``scenarios.SUITE``: the JAX package's test
    cases that ``chip_smoke.py`` phase 19 runs on the card) builds from
    the port's copies alone."""
    proc = _run(_BLOCK_JAX + """
from dentist_tpu_torch import scenarios
n = 0
for key in scenarios.SUITE:
    if key.startswith("consensus_"):
        pairs = scenarios.consensus_case(key)
        assert pairs and all(len(reads) for _, reads in pairs)
    else:
        case = scenarios.gap_case(key)
        assert len(case.structure.gaps) and len(case.read_list) > 20
        assert len(case.reads) == len(case.read_list)
    n += 1
mods = scenarios.port_modules()
assert mods.pipeline.__name__ == "dentist_tpu_torch.pipeline"
assert not any(_is_blocked(m) for m in sys.modules)
print("built", n)
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "19"


def _imported_packages(text: str) -> set:
    """Top-level packages the absolute imports of ``text`` name."""
    names = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_port_imports_jax():
    pkg = os.path.join(ROOT, "dentist_tpu_torch")
    n = 0
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not _imported_packages(text) & set(_BLOCKED), f
                assert not re.search(r"\b(import|from)\s+(jax|dentist_tpu)\b(?!_)",
                                     text), f
                n += 1
    assert n >= 40
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "jax" not in smoke.replace("JAX", "")
    assert not _imported_packages(smoke) & set(_BLOCKED)
    assert "import dentist_tpu\n" not in smoke and "from dentist_tpu." not in smoke


def test_chip_smoke_fails_without_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    proc = _run("", "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_bench_imports_no_jax_and_fails_without_gpu(tmp_path):
    """``bench_torch.py`` names no JAX import, and on a machine without a
    GPU it refuses, printing no result and writing nothing."""
    import torch

    path = os.path.join(ROOT, "bench_torch.py")
    text = open(path).read()
    assert not _imported_packages(text) & set(_BLOCKED)
    assert "import dentist_tpu\n" not in text and "from dentist_tpu." not in text
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: bench_torch.py would run for real")
    proc = _run("", path, cwd=tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout and not os.listdir(tmp_path)


def test_cli_refuses_cuda_without_gpu_and_unported_commands(tmp_path):
    """Every sub-command is ported: the command line lists all 37 and
    refuses only names it does not know; without a GPU its device
    commands refuse to run."""
    import torch

    proc = _run("", "-m", "dentist_tpu_torch", "--commands")
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.split()) == 37
    proc = _run("", "-m", "dentist_tpu_torch", "nonsense", "a.fasta")
    assert proc.returncode != 0
    assert "unknown command" in proc.stderr
    if torch.cuda.is_available():
        return
    for argv in (["pipeline", "a.fasta", "r.fasta", str(tmp_path / "o.fasta")],
                 ["tandem", "a.fasta", str(tmp_path / "t.mask.npz")]):
        proc = _run("", "-m", "dentist_tpu_torch", *argv)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
    assert not os.listdir(tmp_path)


def test_cli_runs_host_commands_without_jax_or_the_jax_package(tmp_path):
    proc = _run(_BLOCK_JAX + f"""
import json
from dentist_tpu_torch import cli
from dentist_tpu_torch.io.store import save_mask
from dentist_tpu_torch.utils.regions import Region
path = {str(tmp_path / "m.mask.npz")!r}
save_mask(path, Region.from_triples([(1, 0, 20), (1, 100, 130), (2, 5, 9)]))
assert cli.main(["show-mask", path, "-j"]) == 0
assert cli.main(["generate-config", "--preset", "greedy"]) == 0
assert not any(_is_blocked(m) for m in sys.modules)
""")
    assert proc.returncode == 0, proc.stderr
    shown = json.loads(proc.stdout.splitlines()[0])
    assert shown["numIntervals"] == 3 and shown["maskedBp"] == 54
