"""The port's masking stages against the JAX package's on an assembly
with repeats, on the CPU.

``scenarios.repeat_assembly`` plants interspersed repeats and tandem
arrays in a 30 kb genome, so ``tandem`` and ``align`` (self-alignment)
find alignments to extend, which a random genome does not give them.
The first four stages of ``scenarios.staged_commands`` (dust, tandem,
``align --mask dust tan``, the self-alignment coverage mask) run through
``dentist_tpu.cli.main`` and ``dentist_tpu_torch.cli.main(...,
device="cpu")``, each in a directory of its own (module-scoped
fixtures); every file they write is compared, npz containers array by
array.
"""

import contextlib
import io

import numpy as np
import pytest

from dentist_tpu import cli as jax_cli
from dentist_tpu_torch import cli as port_cli
from dentist_tpu_torch.io.fasta import codes_to_seq, write_fasta
from dentist_tpu_torch.io.store import load_alignments, load_mask
from dentist_tpu_torch.scenarios import repeat_assembly, staged_commands
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the masking stages of the staged workflow
STAGES = staged_commands(".")[:4]
FILES = ["assembly.fasta", "dust.mask.npz", "tan.mask.npz", "self.las.npz",
         "self.mask.npz"]


def _run(d, main):
    write_fasta(str(d / "assembly.fasta"),
                [(r.header, codes_to_seq(r.codes))
                 for r in repeat_assembly(30_000, 2)])
    for name, argv in staged_commands(str(d))[:4]:
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv) == 0, name
    return d


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("repeats_jax"), jax_cli.main)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("repeats_port"),
                lambda argv: port_cli.main(argv, device="cpu"))


def test_stages_are_the_masking_stages():
    assert [name for name, _ in STAGES] == ["dust", "tandem", "align",
                                             "mask-self"]


@pytest.mark.parametrize("name", FILES)
def test_file_equals_jax(jax_run, port_run, name):
    want, got = jax_run / name, port_run / name
    if name.endswith(".npz"):
        zw, zg = np.load(want, allow_pickle=False), np.load(got, allow_pickle=False)
        assert sorted(zg.files) == sorted(zw.files)
        for key in zw.files:
            assert zg[key].dtype == zw[key].dtype, key
            np.testing.assert_array_equal(zg[key], zw[key], err_msg=key)
    else:
        assert got.read_bytes() == want.read_bytes()


def test_repeats_are_found(port_run):
    """The planted repeats give the device stages work: the three tandem
    arrays masked, the two copies of the long repeat self-aligned."""
    assert len(load_mask(str(port_run / "tan.mask.npz"))) == 3
    assert len(load_alignments(str(port_run / "self.las.npz"))[0].a_id) >= 2
