"""The benchmark's frozen generator against the port's scenario
generator, and its seeds."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import gen

PHASE_C = dict(assembly_mb=0.2, repeats_per_mb=4, repeat_length=3000,
               repeat_divergence=0.02, gaps_per_mb=15, gap_min=100, gap_max=1000,
               gap_margin=25_000, read_coverage=20, read_mean=25_000,
               read_sd=12_500, read_min=500, read_error=0.13)


def test_copy_writes_phase_c_scenarios_bytes(tmp_path):
    """With phase C's seeds (genome 321, repeats 322, gaps 323, reads
    324) the copy writes the bytes ``scenarios.write_scenario`` writes."""
    from dentist_tpu_torch import scenarios

    sc = scenarios.phase_c_scenario(0.2, 3)
    scenarios.write_scenario(sc, str(tmp_path / "port"))
    info = gen.write_unit(str(tmp_path / "copy"), PHASE_C, [321, 322, 323, 324])
    assert info["n_gaps"] == 3 and info["n_reads"] == len(sc.reads)
    for name in ("assembly.fasta", "reads.fasta"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "copy" / name).read_bytes()
    t = np.load(tmp_path / "copy" / "truth.npz")
    assert np.array_equal(t["truth"], sc.truths[0])
    assert np.array_equal(t["gaps"], sc.gaps.iv[:, 1:])


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 17, 2**40, -3])
def test_unit_seeds_are_a_function_of_seed_and_unit(seed):
    a = gen.unit_seeds(seed, 0)
    assert a == gen.unit_seeds(seed, 0)
    assert a != gen.unit_seeds(seed, 1) and a != gen.unit_seeds(seed, "warmup")
    assert a != gen.unit_seeds(seed + 1, 0) and len(a) == 4


@pytest.mark.parametrize("traffic", sorted(
    f[:-5] for f in os.listdir(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "traffic")) if f.endswith(".json")))
def test_every_seed_places_every_gap(traffic):
    """The traffic's gap count at 3 Mb is placed on every seed tried, so
    no seed changes the amount of work."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "traffic", f"{traffic}.json")) as fh:
        g = json.load(fh)["gaps"]
    n = int(round(g["gaps_per_mb"] * 3))
    for seed in range(40):
        s = gen.unit_seeds(seed, seed % 7)[2]
        gaps = gen.random_gaps(3_000_000, n, g["gap_min"], g["gap_max"], g["gap_margin"], s)
        assert len(gaps) == n
        assert np.all(gaps[1:, 0] - gaps[:-1, 1] >= g["gap_margin"])


def test_fasta_bytes_wraps_as_the_port_does():
    from dentist_tpu_torch.io.fasta import codes_to_seq, write_fasta
    import io

    rng = np.random.default_rng(3)
    for n in (0, 1, 49, 50, 51, 100, 1234):
        codes = rng.integers(0, 5, n).astype(np.uint8)
        fh = io.StringIO()
        write_fasta(fh, [("r", codes_to_seq(codes))])
        assert gen.fasta_bytes("r", codes) == fh.getvalue().encode()
