"""The port's command line against the JAX package's, on the CPU.

The same sub-commands run through ``dentist_tpu.cli.main`` and through
``dentist_tpu_torch.cli.main(..., device="cpu")``, each in a directory of
its own (module-scoped fixtures; paths are relative to it, so no output
names its directory): a 50 kb genome with two gaps and 20x reads built by
``build-partial-assembly`` and ``simulate-reads``, the staged workflow of
``scenarios.staged_commands`` (masks, self-alignment, mapping, pile-ups,
two consensus batches, merged insertions, output, ``check-results``),
then every other sub-command on its artifacts.  Every file either run
writes is compared: npz containers (masks with extras, alignments and
chains, pile-ups, insertions, QV tracks) array by array, since their zip
headers carry timestamps; everything else byte for byte.  What the
commands print is compared as text.  The port's device commands refuse
to run without a device on a machine without a GPU, and its host
commands need none.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dentist_tpu import cli as jax_cli
from dentist_tpu.io.fasta import codes_to_seq, write_fasta
from dentist_tpu.sim.genome import random_genome
from dentist_tpu_torch import cli as port_cli
from dentist_tpu_torch import device as port_device
from dentist_tpu_torch.scenarios import staged_commands
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: BED rows with DENTIST data comments (``bed2mask.d:229``) on the
#: assembly's scaffold: contig pairs and read ids ride along as mask extras
_COMMENTS_BED = ("chr1\t1000\t2000\tcontigs-1-2|reads-3-5-7\n"
                 "chr1\t5000\t5600\treads-4\n"
                 "chr1\t12000\t12100\tcontigs-1-2\n")
#: a pipeline event log for ``lost-gaps``: skip events of each phase, one
#: of an unknown reason, and a line that is not JSON
_EVENTS_LOG = "\n".join([
    json.dumps({"event": "pileUpSkipped", "reason": "minSpanningReads",
                "contigIds": [1, 2]}),
    json.dumps({"event": "insertionSkipped", "reason": "insertionError",
                "contig_ids": [2, 3]}),
    json.dumps({"event": "insertionSkipped", "reason": "maxInsertionError",
                "gap": "3-4"}),
    json.dumps({"event": "pileUpSkipped", "reason": "somethingElse"}),
    json.dumps({"event": "output", "numClosedGaps": 2}),
    "not json",
]) + "\n"


def _session(main) -> dict:
    """Run every compared sub-command through ``main`` in the current
    directory; returns what each printed."""
    printed = {}

    def run(name, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0, name
        printed[name] = buf.getvalue()

    write_fasta("truth.fasta", [("chr1", codes_to_seq(random_genome(50000, seed=70)))])
    run("build-partial-assembly", [
        "build-partial-assembly", "truth.fasta", "assembly.fasta", "--num-gaps",
        "2", "--min-gap-size", "60", "--max-gap-size", "200", "--seed", "71"])
    run("simulate-reads", [
        "simulate-reads", "truth.fasta", "reads.fasta", "--coverage", "20",
        "--mean-length", "9000", "--sd-length", "3000", "--seed", "72"])
    for name, argv in staged_commands(".", split=1):
        run(name, argv)
    asm, reads = "./assembly.fasta", "./reads.fasta"
    run("show-pile-ups", ["show-pile-ups", "pile-ups.npz", "-j"])
    run("show-insertions", ["show-insertions", "insertions.npz"])
    run("translate-coords", ["translate-coords", "scaffolding.json",
                             "chr1/100", "chr1/30000"])
    run("intrinsic-qv", ["intrinsic-qv", "reads.las.npz", reads, "--out",
                         "qv.npz", "-j"])
    run("check-scaffolding", ["check-scaffolding", "truth.fasta", asm,
                              "out.fasta"])
    run("find-closable-gaps", ["find-closable-gaps", asm, reads])
    with open("events.log", "w") as fh:
        fh.write(_EVENTS_LOG)
    run("lost-gaps", ["lost-gaps", "events.log"])
    run("export-las", ["export-las", "reads.las.npz", "reads.las"])
    run("import-las", ["import-las", "reads.las", "imported.las.npz"])
    with open("comments.bed", "w") as fh:
        fh.write(_COMMENTS_BED)
    run("bed2mask", ["bed2mask", asm, "comments.bed", "regions.mask.npz",
                     "--data-comments"])
    run("export-mask", ["export-mask", asm, "regions.mask.npz", "regions.anno",
                        "regions.data"])
    run("import-mask", ["import-mask", "regions.anno", "regions.data",
                        "imported.mask.npz"])
    run("show-mask", ["show-mask", "regions.mask.npz", "-j"])
    run("show-mask-text", ["show-mask", "regions.mask.npz"])
    run("mask2bed", ["mask2bed", asm, "regions.mask.npz", "regions.bed"])
    run("fasta2db", ["fasta2db", reads, "reads.db"])
    run("fasta2dam", ["fasta2dam", asm, "assembly.dam"])
    run("dbshow", ["dbshow", "assembly.dam"])
    run("validate-regions", ["validate-regions", asm, reads, "reads.las.npz",
                             "regions.mask.npz", "--read-coverage", "20",
                             "--weak-coverage-mask", "weak.mask.npz"])
    run("propagate-mask", ["propagate-mask", "regions.mask.npz",
                           "reads.las.npz", reads, "reads-side.mask.npz"])
    run("propagate-mask-back", [
        "propagate-mask", "reads-side.mask.npz", "reads.las.npz", reads,
        "back.mask.npz", "--direction", "reads2assembly", "--assembly", asm])
    run("filter-mask", ["filter-mask", "regions.mask.npz", "filtered.mask.npz",
                        "--min-interval-size", "300", "--min-gap-size", "10"])
    run("chain-local-alignments", ["chain-local-alignments", "self.las.npz",
                                   "chained.las.npz"])
    run("generate-config", ["generate-config", "--read-coverage", "20"])
    run("generate-config-greedy", ["generate-config", "--preset", "greedy"])
    run("generate-config-schema", ["generate-config", "--schema"])
    with open("greedy.json", "w") as fh:
        fh.write(printed["generate-config-greedy"])
    run("validate-config", ["validate-config", "greedy.json"])
    run("--commands", ["--commands"])
    run("--config-schema", ["--config-schema"])
    # --revert and a config's `revert:` reset a config file's option
    with open("filter.json", "w") as fh:
        json.dump({"filter-mask": {"min-interval-size": 300,
                                   "mask": "regions.mask.npz"}}, fh)
    with open("filter-revert.json", "w") as fh:
        json.dump({"filter-mask": {"min-interval-size": 300,
                                   "mask": "regions.mask.npz",
                                   "revert": ["min-interval-size"]}}, fh)
    run("config", ["filter-mask", "-", "config.mask.npz", "--config",
                   "filter.json"])
    run("revert", ["filter-mask", "-", "reverted.mask.npz", "--config",
                   "filter.json", "--revert", "min-interval-size"])
    run("config-revert", ["filter-mask", "-", "config-reverted.mask.npz",
                          "--config", "filter-revert.json"])
    return printed


def _in_dir(d, main):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        return _session(main)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_jax")
    return d, _in_dir(d, jax_cli.main)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_port")
    return d, _in_dir(d, lambda argv: port_cli.main(argv, device="cpu"))


#: every file the sessions write (hidden: the Dazzler databases' index
#: and base files)
FILES = [
    "truth.fasta", "assembly.fasta", "reads.fasta",
    "dust.mask.npz", "tan.mask.npz", "self.las.npz", "self.mask.npz",
    "merged.mask.npz", "reads.las.npz", "reads.mask.npz", "repeats.mask.npz",
    "pile-ups.npz", "insertions.0.npz", "insertions.1.npz", "insertions.npz",
    "out.fasta", "out.agp", "out.closed-gaps.bed", "scaffolding.json",
    "qv.npz", "reads.las", "imported.las.npz", "regions.mask.npz",
    "regions.anno", "regions.data", "imported.mask.npz", "regions.bed",
    "reads.db", ".reads.idx", ".reads.bps", "assembly.dam", ".assembly.idx",
    ".assembly.bps", ".assembly.hdr",
    "weak.mask.npz", "reads-side.mask.npz", "back.mask.npz",
    "filtered.mask.npz", "chained.las.npz", "config.mask.npz",
    "reverted.mask.npz", "config-reverted.mask.npz",
]
#: every session step that prints
PRINTED = [
    "check-results", "show-mask", "show-mask-text", "show-pile-ups",
    "show-insertions", "translate-coords", "intrinsic-qv",
    "check-scaffolding", "find-closable-gaps", "lost-gaps", "dbshow",
    "validate-regions", "generate-config", "generate-config-greedy",
    "generate-config-schema", "validate-config", "--commands",
    "--config-schema",
]


def test_same_files(jax_run, port_run):
    assert sorted(os.listdir(port_run[0])) == sorted(os.listdir(jax_run[0]))
    assert set(FILES) <= set(os.listdir(jax_run[0]))


@pytest.mark.parametrize("name", FILES)
def test_file_equals_jax(jax_run, port_run, name):
    want, got = jax_run[0] / name, port_run[0] / name
    if name.endswith(".npz"):
        zw, zg = np.load(want, allow_pickle=False), np.load(got, allow_pickle=False)
        assert sorted(zg.files) == sorted(zw.files)
        for key in zw.files:
            assert zg[key].dtype == zw[key].dtype, key
            np.testing.assert_array_equal(zg[key], zw[key], err_msg=key)
    else:
        assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("name", PRINTED)
def test_printed_equals_jax(jax_run, port_run, name):
    assert port_run[1][name] == jax_run[1][name]
    assert port_run[1][name].strip()


def test_staged_run_closes_the_gaps(port_run):
    d, printed = port_run
    stats = json.loads(printed["check-results"])
    assert stats["numGaps"] == 2 and stats["numClosedGaps"] == 2, stats
    assert json.loads(printed["show-pile-ups"])["numPileUps"] >= 2
    # the reverted runs keep the short intervals the config filters out
    from dentist_tpu_torch.io.store import load_mask

    n = {k: len(load_mask(str(d / f"{k}.mask.npz")))
         for k in ("config", "reverted", "config-reverted", "regions")}
    assert n["reverted"] == n["config-reverted"] == n["regions"] == 3
    assert n["config"] == 2


def test_revert_of_an_unknown_option_fails(port_run):
    d = port_run[0]
    with pytest.raises(SystemExit):
        port_cli.main(["filter-mask", "-", str(d / "x.mask.npz"), "--config",
                       str(d / "filter.json"), "--revert", "bogus-option"])


_DEVICE_ARGV = {
    "tandem": ["a.fasta", "tan.mask.npz"],
    "align": ["a.fasta", "self.las.npz"],
    "map": ["a.fasta", "r.fasta", "reads.las.npz"],
    "collect-pile-ups": ["a.fasta", "r.fasta", "reads.las.npz", "p.npz"],
    "process-pile-ups": ["a.fasta", "r.fasta", "reads.las.npz", "p.npz",
                         "i.npz"],
    "pipeline": ["a.fasta", "r.fasta", "out.fasta"],
}


def test_device_commands_are_the_jax_cli_device_commands():
    assert set(_DEVICE_ARGV) == port_cli.DEVICE_COMMANDS
    assert port_cli.DEVICE_COMMANDS <= set(jax_cli.COMMANDS)


@pytest.mark.parametrize("command", sorted(_DEVICE_ARGV))
def test_device_command_without_device_needs_a_gpu(command, tmp_path,
                                                   monkeypatch):
    """With no ``device=`` a device command takes the card, and refuses
    to run where there is none: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the command would run on it")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_device, "_DEVICE", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main([command, *_DEVICE_ARGV[command]])
    assert port_device._DEVICE is None
    assert not os.listdir(tmp_path)


def test_host_commands_need_no_device(port_run, tmp_path, monkeypatch):
    """The staged workflow's host stages rerun with no device chosen and
    ``torch.cuda`` unreachable, and write what they wrote before."""
    d = port_run[0]
    for name in ("assembly.fasta", "reads.fasta", "truth.fasta",
                 "self.las.npz", "reads.las.npz", "insertions.0.npz",
                 "insertions.1.npz", "dust.mask.npz", "tan.mask.npz"):
        shutil.copy(d / name, tmp_path / name)

    def no_cuda(*args, **kwargs):
        raise AssertionError("a host command touched torch.cuda")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_device, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "set_device", no_cuda)
    host = [(n, a) for n, a in staged_commands(".", split=1)
            if port_cli.resolve_command(a[0]) not in port_cli.DEVICE_COMMANDS]
    assert len(host) == 8
    for name, argv in host:
        with contextlib.redirect_stdout(io.StringIO()):
            assert port_cli.main(argv) == 0, name
    for name in ("dust.mask.npz", "self.mask.npz", "reads.mask.npz",
                 "insertions.npz"):
        zw, zg = np.load(d / name), np.load(tmp_path / name)
        for key in zw.files:
            np.testing.assert_array_equal(zg[key], zw[key])
    for name in ("out.fasta", "out.agp", "out.closed-gaps.bed"):
        assert (tmp_path / name).read_bytes() == (d / name).read_bytes()
    assert port_device._DEVICE is None
