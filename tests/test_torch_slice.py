"""The port's slice against the JAX package, on the CPU.

``dentist_tpu_torch`` runs with ``set_device("cpu")``, so its kernel
wrappers take their plain PyTorch versions; the JAX package runs on its
CPU backend, single-device (``DENTIST_TPU_FORCE_SINGLE=1``).  Same
inputs, and the outputs must be equal: alignment records field by field,
tandem masks, consensus sequences and per-window diffs, and the
gap-closed FASTA, AGP and BED rows.
"""

import hashlib
import json

import numpy as np
import pytest

from dentist_tpu_torch.device import set_device


@pytest.fixture(autouse=True)
def _single_device_cpu(monkeypatch):
    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")


_LAS_FIELDS = ("a_id", "b_id", "complement", "a_begin", "a_end", "b_begin",
               "b_end", "diffs", "trace_offsets", "trace_diffs", "trace_b_adv",
               "chain_id")


def test_map_reads_equals_jax():
    import __graft_entry__ as g
    from dentist_tpu.ops import mapper as jax_mapper
    from dentist_tpu_torch.ops import mapper as port_mapper

    contigs, reads = g._simulated_scenario()
    args = (contigs.codes, contigs.offsets, contigs.lengths, reads)
    las_j, chains_j = jax_mapper.map_reads(*args,
                                           config=jax_mapper.MapperConfig())
    las_p, chains_p = port_mapper.map_reads(*args,
                                            config=port_mapper.MapperConfig())
    assert len(las_j) > 0
    for f in _LAS_FIELDS:
        np.testing.assert_array_equal(getattr(las_p, f), getattr(las_j, f),
                                      err_msg=f)
    assert [(c.a_id, c.b_id, c.score) for c in chains_p] == \
        [(c.a_id, c.b_id, c.score) for c in chains_j]


def _tandem_scenarios():
    from dentist_tpu.sim.genome import insert_tandem, random_genome

    g1 = insert_tandem(random_genome(5000, seed=31), 2000, unit_length=40,
                       n_units=15)
    g2 = random_genome(8000, seed=77)
    g3 = random_genome(6000, seed=78)
    g3 = np.concatenate([g3[:2000], g3[2000:2700], g3[2000:2700], g3[2700:]])
    return [(g1, 5000), (g2, 8000), (g3, len(g3))]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_tandem_mask_equals_jax(case):
    from dentist_tpu.models.mask import tandem_mask as jax_tandem
    from dentist_tpu_torch.models.mask import tandem_mask as port_tandem

    g, L = _tandem_scenarios()[case]
    args = (g, np.array([0]), np.array([L]))
    np.testing.assert_array_equal(port_tandem(*args).iv, jax_tandem(*args).iv)


def test_consensus_batch_equals_jax():
    from dentist_tpu.ops.consensus import consensus_batch as jax_cons
    from dentist_tpu.sim.reads import _mutate
    from dentist_tpu_torch.ops.consensus import consensus_batch as port_cons

    rng = np.random.default_rng(11)
    sets = []
    for t_len, n_reads in ((700, 9), (420, 7), (980, 11)):
        truth = np.asarray(rng.integers(0, 4, t_len), dtype=np.uint8)
        sets.append([_mutate(truth, rng, 0.12) for _ in range(n_reads)])
    for k, (a, b) in enumerate(zip(port_cons(sets), jax_cons(sets))):
        np.testing.assert_array_equal(a.sequence, b.sequence, err_msg=str(k))
        np.testing.assert_array_equal(a.win_diffs, b.win_diffs, err_msg=str(k))
        np.testing.assert_array_equal(a.read_diffs, b.read_diffs)
        np.testing.assert_array_equal(a.read_spans, b.read_spans)
        np.testing.assert_array_equal(a.coverage, b.coverage)


def close_gaps_scenario():
    """A cut-down ``tests/test_e2e.py`` scenario (30 kb genome, 1 gap,
    20x 10 kb reads at 13 % error) as ``close_gaps``'s first four
    arguments."""
    from dentist_tpu.io.fasta import FastaRecord
    from dentist_tpu.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu.sim.genome import random_genome
    from dentist_tpu.sim.partial import build_partial_assembly, random_gaps
    from dentist_tpu.sim.reads import simulate_reads

    truth = [random_genome(30_000, seed=50)]
    gaps = random_gaps(truth, n_gaps=1, min_size=80, max_size=300, margin=8000,
                       seed=51)
    asm = build_partial_assembly(truth, gaps)
    contigs, structure = split_scaffolds(
        [FastaRecord(f"scaf{i}", s) for i, s in enumerate(asm)])
    read_list, _ = simulate_reads(truth, coverage=20, mean_length=10000,
                                  sd_length=4000, error=0.13, seed=52)
    reads = SeqStore(np.concatenate(read_list),
                     np.array([len(r) for r in read_list]),
                     [f"read{i + 1}" for i in range(len(read_list))])
    return contigs, structure, reads, read_list


def close_gaps_digest(result) -> str:
    """sha256 of ``json.dumps([records, agp_rows, bed_rows])``."""
    got = json.dumps([result.records, result.agp_rows, result.bed_rows])
    return hashlib.sha256(got.encode()).hexdigest()


#: ``close_gaps_digest`` of the JAX package's single-device ``close_gaps``
#: on ``close_gaps_scenario()`` (JAX on its CPU backend), which closes the
#: one gap; ``test_close_gaps_equals_jax`` holds it against a live JAX run
#: and ``test_torch_parallel.py`` holds the port's ranks against it
JAX_CLOSE_GAPS_SHA256 = (
    "3cb6f8b5680cec4b5a2126b33ac02b0606e172f4dc4c1f5b391dddea86558390")


def test_close_gaps_equals_jax():
    """The whole pipeline on ``close_gaps_scenario()``."""
    from dentist_tpu import pipeline as jax_pipeline
    from dentist_tpu_torch import pipeline as port_pipeline

    args = close_gaps_scenario()
    res_j = jax_pipeline.close_gaps(*args,
                                    jax_pipeline.PipelineConfig(read_coverage=20.0))
    res_p = port_pipeline.close_gaps(*args,
                                     port_pipeline.PipelineConfig(read_coverage=20.0))
    assert res_j.n_closed_gaps == 1
    assert res_p.n_closed_gaps == res_j.n_closed_gaps
    assert res_p.records == res_j.records
    assert res_p.agp_rows == res_j.agp_rows
    assert res_p.bed_rows == res_j.bed_rows
    assert close_gaps_digest(res_j) == JAX_CLOSE_GAPS_SHA256
