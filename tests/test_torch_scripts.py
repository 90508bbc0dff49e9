"""The port's entry points besides ``python -m dentist_tpu_torch``: the
``dentist-tpu-torch`` console script and the port scripts
(``scripts/*_torch.py``: the stress and two-process runs, the profiles,
the K2p bench and phase C by digest; and ``bench_torch.py`` at the
root), which import nothing of JAX or the JAX package and refuse to run
on a machine without a GPU unless the CPU is asked for (their imports
all come before the device is chosen, so the refusal also runs every
import with JAX blocked).  The JAX package's reference generators
(``scripts/*_reference.py``) import it by design; nothing of the port
imports them."""

import importlib
import json
import os
import subprocess
import sys
import tomllib

import pytest
from test_torch_no_jax import _BLOCK_JAX, _BLOCKED, ROOT, _imported_packages

#: each port script with the arguments its refusal is tried with
_SCRIPTS = {
    "stress_torch": ["--mb=1"],
    "demo_2proc_torch": ["--mb=1"],
    "profile_e2e_torch": ["--small"],
    "profile_process_torch": [],
    "profile_e2e_process_torch": ["--mb=1", "--gaps=5"],
    "bench_consensus_kernel_torch": [],
    "profile_staged_torch": [],
    "phase_c_torch": ["--mb", "3"],
    "bench_torch": ["--small"],
}

#: the scripts that run the JAX package to write a reference the port is
#: held to
_REFERENCES = ("phase_c_reference", "scaffolds_repeats_reference",
               "bench_reference", "jax_suite_reference")


def _path(name: str) -> str:
    """A port script's path: ``bench_torch.py`` sits at the root, beside
    ``bench.py``; the others in ``scripts/``."""
    return os.path.join(ROOT, *(() if name == "bench_torch" else ("scripts",)),
                        f"{name}.py")


def test_console_script_is_the_port_cli():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    module, _, attr = scripts["dentist-tpu-torch"].partition(":")
    assert module == "dentist_tpu_torch.cli"
    from dentist_tpu_torch import cli

    assert getattr(importlib.import_module(module), attr) is cli.main
    assert scripts["dentist-tpu"] == "dentist_tpu.cli:main"


@pytest.mark.parametrize("name", _SCRIPTS)
def test_port_script_imports_without_jax(name):
    path = _path(name)
    text = open(path).read()
    assert not _imported_packages(text) & set(_BLOCKED)
    assert "dentist_tpu." not in text.replace("dentist_tpu_torch.", "")
    code = _BLOCK_JAX + f"""
import runpy
runpy.run_path({path!r}, run_name="imported")
import dentist_tpu_torch.pipeline, dentist_tpu_torch.eval.check_results
assert not any(_is_blocked(m) for m in sys.modules)
print("imported")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


@pytest.mark.parametrize("name", _SCRIPTS)
def test_port_script_refuses_without_gpu(name, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run for real")
    path = _path(name)
    code = _BLOCK_JAX + f"""
import runpy
sys.argv = [{path!r}, *{_SCRIPTS[name]!r}]
try:
    runpy.run_path({path!r}, run_name="__main__")
finally:
    assert not any(_is_blocked(m) for m in sys.modules)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "is blocked" not in proc.stderr
    assert not proc.stdout and not os.listdir(tmp_path)


@pytest.mark.parametrize("name", _REFERENCES)
def test_nothing_of_the_port_imports_a_reference_generator(name):
    """A reference generator imports the JAX package, which the port and
    its scripts never do: none of them imports one."""
    text = open(os.path.join(ROOT, "scripts", f"{name}.py")).read()
    assert "dentist_tpu" in _imported_packages(text)
    files = [os.path.join(dirpath, f)
             for dirpath, _, fs in os.walk(os.path.join(ROOT, "dentist_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files += [_path(n) for n in _SCRIPTS] + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        assert name not in _imported_packages(open(path).read()), path


def _suite_reference() -> dict:
    from dentist_tpu_torch.scenarios import SUITE_REFERENCE

    with open(SUITE_REFERENCE) as fh:
        return json.load(fh)


def test_suite_reference_holds_phase_19s_scenarios():
    """``scripts/jax_suite_reference.json`` holds one entry per scenario
    ``chip_smoke.py`` phase 19 runs (``suite_plan``), in its order, each
    with the JAX test it stands for and its digests."""
    import chip_smoke
    from dentist_tpu_torch.scenarios import SUITE

    ref = _suite_reference()
    assert list(ref["scenarios"]) == chip_smoke.suite_plan(ref) == list(SUITE)
    for key, e in ref["scenarios"].items():
        assert e["test"] == SUITE[key]
        hashes = [v for v in e["digests"].values() if isinstance(v, str)]
        assert hashes and all(len(h) == 64 and int(h, 16) >= 0 for h in hashes)
    assert set(ref["provenance"]) == {"command", "env", "cpu", "jax", "date"}


@pytest.mark.parametrize("fault", ["missing", "extra", "order"])
def test_phase_19_refuses_another_scenario_list(fault, monkeypatch):
    import chip_smoke

    ref = _suite_reference()
    keys = list(ref["scenarios"])
    if fault == "missing":
        keys = keys[1:]
    elif fault == "extra":
        keys.append("another")
    else:
        keys[0], keys[1] = keys[1], keys[0]
    monkeypatch.setattr(chip_smoke, "fail", lambda msg: (_ for _ in ()).throw(
        SystemExit(msg)))
    with pytest.raises(SystemExit, match="the reference holds"):
        chip_smoke.suite_plan({"scenarios": {k: {} for k in keys}})
