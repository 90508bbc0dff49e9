"""Two scaffolds, reads over repeat-masked contigs, and a validation purge,
in the port against JAX.

One 24 kb random genome with 4 copies of a 2 kb interspersed repeat,
cut at 14 kb into two true scaffolds with one gap each (150 and 90 bp,
as in ``tests/test_multiscaffold.py``), and 8x reads of 5 kb ± 1.5 kb
at 13 % error: ``tests/test_multiscaffold.py``'s layout cut to a size
whose two ``close_gaps`` runs fit this file's time budget.  The seeds
are ones where the JAX package closes both gaps and the repeat mask has
intervals, so mapping, collect and process run under a non-empty mask.
Both packages' ``close_gaps`` run once, with validation and a workdir
(module fixture); the port on the CPU (``set_device("cpu")``, plain
kernel versions).  Tolerance 0: the FASTA records, AGP and BED rows,
``check_results``, ``translate_coord`` across both scaffolds, every
workdir artifact array by array, and ``_validation_pass`` against
unrelated reads, which must purge every closed gap.
"""

import os

import numpy as np
import pytest

from dentist_tpu_torch.device import set_device
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: genome, repeat and read seeds
SEEDS = (530, 533, 532)


@pytest.fixture(autouse=True)
def _single_device_cpu(monkeypatch):
    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")


def _inputs(pkg):
    """(truths, close_gaps' four arguments) from ``pkg``'s own classes."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    genome = mod("sim.genome")
    g = genome.insert_repeats(genome.random_genome(24_000, seed=SEEDS[0]),
                              n_copies=4, repeat_length=2000, seed=SEEDS[1])
    truths = [g[:14_000], g[14_000:]]
    gaps = mod("utils.regions").Region.from_triples(
        [(0, 7000, 7150), (1, 5000, 5090)])
    asm = mod("sim.partial").build_partial_assembly(truths, gaps)
    seqs = mod("models.sequences")
    contigs, structure = seqs.split_scaffolds(
        [mod("io.fasta").FastaRecord(f"chr{i + 1}", s) for i, s in enumerate(asm)])
    read_list, _ = mod("sim.reads").simulate_reads(
        truths, coverage=8, mean_length=5000, sd_length=1500, error=0.13,
        seed=SEEDS[2])
    reads = seqs.SeqStore(np.concatenate(read_list),
                          np.array([len(r) for r in read_list]))
    return truths, (contigs, structure, reads, read_list)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's (truths, arguments, config, result, workdir)."""
    import importlib

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DENTIST_TPU_FORCE_SINGLE", "1")
        set_device("cpu")
        for pkg in ("dentist_tpu", "dentist_tpu_torch"):
            pl = importlib.import_module(f"{pkg}.pipeline")
            truths, args = _inputs(pkg)
            wd = str(tmp_path_factory.mktemp(pkg) / "wd")
            cfg = pl.PipelineConfig(read_coverage=8, workdir=wd)
            out[pkg] = (truths, args, cfg, pl.close_gaps(*args, cfg), wd)
    return out["dentist_tpu"], out["dentist_tpu_torch"]


def test_outputs_equal(runs):
    (*_, want, _), (*_, got, _) = runs
    assert want.n_closed_gaps == 2
    assert got.n_closed_gaps == want.n_closed_gaps
    assert [h.split("\t")[0] for h, _ in got.records] == ["chr1", "chr2"]
    assert got.records == want.records
    assert got.agp_rows == want.agp_rows
    assert got.bed_rows == want.bed_rows


def test_check_results_equal(runs):
    from dentist_tpu.eval.check_results import check_results as jax_check
    from dentist_tpu_torch.eval.check_results import check_results as port_check
    from dentist_tpu_torch.io.fasta import seq_to_codes

    stats = []
    for check, (truths, (contigs, structure, _, _), _, result, _) in zip(
            (jax_check, port_check), runs):
        out = [seq_to_codes(s.lower()) for _, s in result.records]
        stats.append(check(truths, structure, contigs, out).to_json())
    assert stats[1] == stats[0]
    assert stats[0]["numClosedGaps"] == 2


def test_translate_coord_equal(runs):
    """Contig interiors, both sides of each closed gap (its BED row's
    ends) and each scaffold's last base."""
    (*_, want, _), (*_, got, _) = runs
    points = []
    for header, seq in want.records:
        name = header.split("\t")[0]
        points += [(name, 0), (name, 5000), (name, len(seq) - 1)]
    for row in want.bed_rows:
        name, b, e, _ = row.split("\t")
        b, e = int(b), int(e)
        points += [(name, b - 1), (name, b), (name, e - 1), (name, e)]
    assert len(points) >= 8
    kinds = set()
    for name, pos in points:
        assert got.translate_coord(name, pos) == want.translate_coord(name, pos)
        kinds.add(want.translate_coord(name, pos)[0])
    assert kinds == {"contig", "insertion"}


def test_masks_hold_reads_and_equal_jax(runs):
    """The repeat mask has intervals and read alignments overlap them;
    every workdir artifact equals JAX's."""
    from dentist_tpu_torch.io.store import load_alignments, load_mask

    (*_, jax_wd), (*_, wd) = runs
    mask = (load_mask(os.path.join(wd, "dust.mask.npz"))
            | load_mask(os.path.join(wd, "repeats.mask.npz")))
    assert len(mask)
    las, _ = load_alignments(os.path.join(wd, "reads.las.npz"))
    overlaps = sum(((las.a_id == c) & (las.a_begin < e) & (las.a_end > b)).sum()
                   for c, b, e in mask.iv)
    assert overlaps > 0
    for name in sorted(os.listdir(jax_wd)):
        if name.endswith(".npz"):
            with np.load(os.path.join(wd, name)) as g, \
                    np.load(os.path.join(jax_wd, name)) as w:
                assert sorted(g.files) == sorted(w.files), name
                for key in w.files:
                    np.testing.assert_array_equal(g[key], w[key],
                                                  err_msg=f"{name} {key}")
        else:
            with open(os.path.join(wd, name)) as a, \
                    open(os.path.join(jax_wd, name)) as b:
                assert a.read() == b.read(), name


def test_validation_purges_against_unrelated_reads(runs):
    """``tests/test_validation_pass.py:34`` on two scaffolds: validated
    against 20 random 9 kb genomes, every closed gap is purged, and the
    two packages' skip sets are equal."""
    import importlib

    from dentist_tpu_torch.scenarios import closed_gap_pairs, unrelated_reads

    noise = unrelated_reads()
    skips = []
    for pkg, (_, _, cfg, result, _) in zip(("dentist_tpu", "dentist_tpu_torch"),
                                           runs):
        pl = importlib.import_module(f"{pkg}.pipeline")
        store = importlib.import_module(f"{pkg}.models.sequences").SeqStore(
            np.concatenate(noise), np.array([len(r) for r in noise]))
        skips.append(pl._validation_pass(result, noise, store, cfg))
    closed = closed_gap_pairs(runs[0][3].bed_rows)
    assert len(closed) == 2
    assert skips[1] == skips[0] == closed
