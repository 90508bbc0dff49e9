"""The port installs as a package: its wheel carries the kernel sources,
an installed port looks for the library its checkout would build, the
kernel build command (``python -m dentist_tpu_torch._build``) and
``library()`` fail with a :class:`KernelError` that names that command
where they cannot build, and ``packaging/torch/`` (Dockerfile,
Singularity definition, conda recipe, smoke test) builds the kernels with
that command and installs no JAX.

No compiler runs here: the wheel is built offline from a copy of the
port, and the build command runs where there is no ``nvcc``.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
import zipfile

import jinja2
import pytest
import yaml

from dentist_tpu_torch import _build
from dentist_tpu_torch.errors import KernelError
from test_torch_no_jax import _BLOCK_JAX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGING = os.path.join(ROOT, "packaging", "torch")
SOURCES = ["extend.cu", "nw_dist.cu", "nw_round.cu", "round_pack.cu",
           "store_write.cu", "pack2.cuh"]
#: the files of ``packaging/torch/`` and what each must name: the build
#: files the build command and the kernels' target, the smoke test the
#: console script and the installed package
FILES = {
    "Dockerfile": ('ENTRYPOINT ["dentist-tpu-torch"]', "-m dentist_tpu_torch._build",
                   "sm_90a", "dentist_tpu_torch"),
    "singularity/dentist-tpu-torch.def": ('exec dentist-tpu-torch "$@"',
                                          "-m dentist_tpu_torch._build", "sm_90a",
                                          "dentist_tpu_torch"),
    "conda/meta.yaml": ("dentist-tpu-torch = dentist_tpu_torch.cli:main",
                        "-m dentist_tpu_torch._build", "sm_90a"),
    "smoke-test.sh": ("dentist-tpu-torch --commands", "import dentist_tpu_torch",
                      "_build.library_path()"),
}


def _port_sources() -> list:
    """The port's ``.py`` files that git tracks (every one in the tree
    where there is no git), relative to the repo."""
    proc = subprocess.run(["git", "ls-files", "dentist_tpu_torch"], cwd=ROOT,
                          capture_output=True, text=True)
    if proc.returncode == 0 and proc.stdout.strip():
        return [f for f in proc.stdout.split() if f.endswith(".py")]
    return [os.path.relpath(os.path.join(d, f), ROOT)
            for d, _, files in os.walk(os.path.join(ROOT, "dentist_tpu_torch"))
            for f in files if f.endswith(".py") and "__pycache__" not in d]


@pytest.fixture(scope="module")
def wheel(tmp_path_factory) -> str:
    """A wheel of the files the image copies (``pyproject.toml``,
    ``README.md``, the port), with a stale library planted in the copy's
    ``_build/``; built offline, as the image's ``pip install`` builds it."""
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    shutil.copytree(os.path.join(ROOT, "dentist_tpu_torch"), src / "dentist_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(ROOT, name), src)
    stale = src / "dentist_tpu_torch" / "_build"
    stale.mkdir()
    (stale / "libdentist_kernels_0123456789abcdef.so").write_bytes(b"stale")
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "--disable-pip-version-check", "wheel",
         "--no-deps", "--no-build-isolation", "--no-index", "-q", "-w",
         str(tmp / "out"), str(src)],
        cwd=tmp, env=dict(os.environ, PIP_NO_INDEX="1"), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (name,) = os.listdir(tmp / "out")
    return str(tmp / "out" / name)


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory) -> str:
    """The wheel extracted into a prefix of its own."""
    prefix = tmp_path_factory.mktemp("prefix")
    with zipfile.ZipFile(wheel) as z:
        z.extractall(prefix)
    return str(prefix)


def _outside(tmp_path, code: str, *args: str, env=None):
    """``code`` (or ``python args``) run from an empty directory outside
    the repo."""
    cwd = tmp_path / "cwd"
    cwd.mkdir(exist_ok=True)
    return subprocess.run([sys.executable, *args] if args else
                          [sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_wheel_carries_the_port_and_its_kernel_sources(wheel):
    names = set(zipfile.ZipFile(wheel).namelist())
    missing = [f for f in _port_sources() if f not in names]
    assert not missing
    for src in SOURCES:
        assert f"dentist_tpu_torch/csrc/{src}" in names
    assert not [n for n in names if "/_build/" in n or n.endswith(".so")]


def test_installed_port_looks_for_the_checkouts_library(installed, tmp_path):
    """Imported from the prefix, with JAX and the JAX package blocked, the
    port names the library its checkout names (the same sources and
    flags), under the prefix's package."""
    proc = _outside(tmp_path, _BLOCK_JAX + """
import dentist_tpu_torch
from dentist_tpu_torch import _build
print(dentist_tpu_torch.__file__)
print(_build.library_path())
assert not any(_is_blocked(m) for m in sys.modules)
""", env=dict(os.environ, PYTHONPATH=installed))
    assert proc.returncode == 0, proc.stderr
    init, so = proc.stdout.split()
    package = os.path.join(installed, "dentist_tpu_torch")
    assert init == os.path.join(package, "__init__.py")
    assert so == os.path.join(package, "_build", _build.library_path().name)


def test_library_raises_where_the_build_dir_cannot_be_made(monkeypatch, tmp_path):
    """A read-only install: the library is absent and ``_build/`` cannot
    be made (a regular file stands where its parent should be: root
    ignores permission bits)."""
    blocker = tmp_path / "site-packages"
    blocker.write_bytes(b"not a directory")
    monkeypatch.setattr(_build, "_OUT", blocker / "dentist_tpu_torch" / "_build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/nonexistent/nvcc")
    with pytest.raises(KernelError) as exc:
        _build.library()
    msg = str(exc.value)
    assert _build.BUILD_COMMAND in msg
    assert str(_build.library_path()) in msg
    assert _build.library_path().stem.rsplit("_", 1)[1] in msg
    assert "cannot be made or written" in msg
    assert isinstance(exc.value.__cause__, OSError)
    assert _build._lib is None


def test_library_raises_without_sources(monkeypatch, tmp_path):
    (tmp_path / "csrc").mkdir()
    monkeypatch.setattr(_build, "_SRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "_OUT", tmp_path / "_build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(KernelError) as exc:
        _build.library()
    msg = str(exc.value)
    assert _build.BUILD_COMMAND in msg and "holds no .cu source" in msg
    assert str(_build.library_path()) in msg
    assert not (tmp_path / "_build").exists()


@pytest.mark.parametrize("torch_blocked", [False, True],
                         ids=["command", "torch-blocked"])
def test_build_command_without_nvcc(installed, tmp_path, torch_blocked):
    """The build command, with no ``nvcc`` on ``PATH`` and ``CUDA_HOME``
    unset, exits 1 with the :class:`KernelError`'s text and writes
    nothing; it imports nothing of PyTorch (an image's builder stage has
    none)."""
    if os.path.exists("/usr/local/cuda"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda: the "
                    "build command would find its nvcc")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    env["PYTHONPATH"] = installed
    if torch_blocked:
        block = _BLOCK_JAX.replace('_blocked = ("jax", "dentist_tpu")',
                                   '_blocked = ("jax", "dentist_tpu", "torch")')
        assert block != _BLOCK_JAX
        proc = _outside(tmp_path, block + """
import runpy
runpy.run_module("dentist_tpu_torch._build", run_name="__main__")
""", env=env)
    else:
        proc = _outside(tmp_path, "", "-m", "dentist_tpu_torch._build", env=env)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "Traceback" not in proc.stderr
    assert "nvcc not found" in proc.stderr
    assert _build.BUILD_COMMAND in proc.stderr
    assert _build.library_path().name in proc.stderr
    assert not os.path.exists(os.path.join(installed, "dentist_tpu_torch", "_build"))


@pytest.mark.parametrize("name", sorted(FILES))
def test_packaging_file_names_the_port_and_installs_no_jax(name):
    text = open(os.path.join(PACKAGING, name)).read()
    for want in FILES[name]:
        assert want in text, want
    code = [line for line in text.splitlines()
            if not line.lstrip().startswith("#")]
    assert not [line for line in code if re.search(r"\bjax\b", line)]


def test_images_ship_no_compiler_and_pin_one_toolkit():
    """The runtime stages install neither nvcc nor g++; the builder
    stages and the recipe pin the same CUDA toolkit."""
    docker = open(os.path.join(PACKAGING, "Dockerfile")).read()
    sif = open(os.path.join(PACKAGING, "singularity", "dentist-tpu-torch.def")).read()
    for runtime in (docker.rsplit("\nFROM ", 1)[1], sif.split("Stage: final", 1)[1]):
        assert "g++" not in runtime and "nvidia/cuda" not in runtime
    cuda = re.search(r"ARG CUDA_VERSION=(\d+\.\d+\.\d+)", docker).group(1)
    assert f"nvidia/cuda:{cuda}-devel" in sif
    assert "nvidia/cuda:${CUDA_VERSION}-devel" in docker
    meta = open(os.path.join(PACKAGING, "conda", "meta.yaml")).read()
    assert f"cuda-nvcc {cuda.rsplit('.', 1)[0]}.*" in meta


def test_conda_recipe_renders_and_parses():
    text = open(os.path.join(PACKAGING, "conda", "meta.yaml")).read()
    meta = yaml.safe_load(jinja2.Template(text).render(
        PYTHON="python", compiler=lambda lang: f"{lang}-compiler"))
    assert meta["package"]["name"] == "dentist-tpu-torch"
    assert "noarch" not in meta["build"]
    script = meta["build"]["script"]
    assert script[0].startswith("python -m pip install . --no-deps")
    assert any("-m dentist_tpu_torch._build" in line for line in script)
    assert "cuda-nvcc" in " ".join(meta["requirements"]["build"])
    run = [r.split()[0] for r in meta["requirements"]["run"]]
    assert run == ["python", "numpy", "pytorch"]
    assert meta["build"]["entry_points"] == [
        "dentist-tpu-torch = dentist_tpu_torch.cli:main"]
    tests = meta["test"]["commands"]
    for cmd in ("--version", "--commands", "generate-config --schema"):
        assert any(t.startswith(f"dentist-tpu-torch {cmd}") for t in tests)


def test_smoke_test_is_valid_sh():
    path = os.path.join(PACKAGING, "smoke-test.sh")
    proc = subprocess.run(["sh", "-n", path], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert os.access(path, os.X_OK)


def _e2e_sha256(text: str) -> dict:
    start = text.index("E2E_SHA256 = {")
    return ast.literal_eval(text[text.index("{", start):text.index("}", start) + 1])


def test_smoke_test_holds_chip_smokes_hashes():
    smoke = _e2e_sha256(open(os.path.join(PACKAGING, "smoke-test.sh")).read())
    chip = _e2e_sha256(open(os.path.join(ROOT, "chip_smoke.py")).read())
    assert smoke == chip
    assert sorted(smoke) == ["out.agp", "out.closed-gaps.bed", "out.fasta"]
