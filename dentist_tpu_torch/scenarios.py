"""Seeded simulated gap-closing scenarios, written to FASTA.

Two scenarios drive the port end to end:

- :func:`e2e_scenario` — the ``tests/test_e2e.py`` scenario: a 60 kb
  genome with 3 gaps of 80–300 bp and 20× reads of 10 kb ± 4 kb at 13 %
  error (seeds 50/51/52).
- :func:`phase_a_scenario` — the ``bench.py`` phase-A scenario: a 3 Mb
  genome with 16 gaps of 50–500 bp and 20× reads of 25 kb ± 12.5 kb at
  13 % error (seeds 123/124/125).

Both are pure functions of their seeds, so the FASTA files
:func:`write_scenario` and :func:`write_truth` produce are byte-identical
across machines.  :func:`staged_commands` is the staged workflow (one
CLI sub-command per stage, as DENTIST's Snakemake DAG runs them) over
such files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .io.fasta import (FastaRecord, codes_to_seq, read_fasta,
                       write_fasta)
from .sim.genome import insert_repeats, insert_tandem, random_genome
from .sim.partial import build_partial_assembly, random_gaps
from .sim.reads import simulate_reads
from .utils.regions import Region

__all__ = ["Scenario", "e2e_scenario", "phase_a_scenario", "write_scenario",
           "repeat_assembly", "write_truth", "staged_commands",
           "closed_exactly",
           "closed_exactly_in"]


@dataclass
class Scenario:
    truth: np.ndarray  # the one true scaffold (codes)
    gaps: Region  # gap intervals punched into the truth
    assembly: list[FastaRecord]  # the gapped assembly
    reads: list[np.ndarray]


def _build(genome: int, n_gaps: int, min_gap: int, max_gap: int, margin: int,
           mean_length: int, sd_length: int, seeds: tuple[int, int, int],
           ) -> Scenario:
    truth = random_genome(genome, seed=seeds[0])
    gaps = random_gaps([truth], n_gaps=n_gaps, min_size=min_gap,
                       max_size=max_gap, margin=margin, seed=seeds[2])
    asm = build_partial_assembly([truth], gaps)
    records = [FastaRecord(f"scaf{i}", s) for i, s in enumerate(asm)]
    reads, _ = simulate_reads([truth], coverage=20, mean_length=mean_length,
                              sd_length=sd_length, error=0.13, seed=seeds[1])
    return Scenario(truth, gaps, records, reads)


def e2e_scenario() -> Scenario:
    return _build(60_000, 3, 80, 300, 8000, 10_000, 4000, (50, 52, 51))


def phase_a_scenario() -> Scenario:
    return _build(3_000_000, 16, 50, 500, 20_000, 25_000, 12_500,
                  (123, 124, 125))


def write_scenario(sc: Scenario, directory: str) -> tuple[str, str]:
    """Write ``assembly.fasta`` and ``reads.fasta``; returns both paths."""
    os.makedirs(directory, exist_ok=True)
    asm = os.path.join(directory, "assembly.fasta")
    reads = os.path.join(directory, "reads.fasta")
    write_fasta(asm, [(r.header, codes_to_seq(r.codes)) for r in sc.assembly])
    write_fasta(reads, [(f"read{i + 1}", codes_to_seq(r))
                        for i, r in enumerate(sc.reads)])
    return asm, reads


def repeat_assembly(length: int, copies: int, seed: int = 60
                    ) -> list[FastaRecord]:
    """A gapped assembly of a genome that carries what the masking stages
    exist for: ``copies`` copies of a 6 kb interspersed repeat at 1 %
    divergence, ``2 * copies`` of a 300 bp one at 5 %, and tandem arrays
    of 7, 40 and 171 bp units (2.1, 2.4 and 3.4 kb) at a quarter, half
    and three quarters of the genome; cut into contigs by ``copies // 4
    + 1`` gaps, so self-alignments pair repeat copies within and across
    contigs.  A pure function of its arguments."""
    g = random_genome(length, seed=seed)
    g = insert_repeats(g, copies, 6000, seed=seed + 1, divergence=0.01)
    g = insert_repeats(g, 2 * copies, 300, seed=seed + 2, divergence=0.05)
    for i, (unit, n) in enumerate(((7, 300), (40, 60), (171, 20))):
        g = insert_tandem(g, (i + 1) * length // 4, unit, n, seed=seed + 3 + i)
    gaps = random_gaps([g], n_gaps=copies // 4 + 1, min_size=50,
                       max_size=500, margin=length // 20, seed=seed + 6)
    return [FastaRecord(f"scaf{i}", s)
            for i, s in enumerate(build_partial_assembly([g], gaps))]


def write_truth(sc: Scenario, directory: str) -> str:
    """Write the true genome as ``truth.fasta``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "truth.fasta")
    write_fasta(path, [("truth", codes_to_seq(sc.truth))])
    return path


def staged_commands(directory: str, split: int = 8
                    ) -> list[tuple[str, list[str]]]:
    """The staged workflow over ``assembly.fasta``, ``reads.fasta`` and
    ``truth.fasta`` in ``directory``: (stage name, CLI argv) pairs, run in
    order.  Masks (dust, tandem, self-alignment coverage, coverage of
    the scenarios' 20x reads), alignments, pile-ups, consensus in two
    batches (pile-ups ``0..split`` and ``split..99``, as a cluster runs
    them), merged insertions, the output with AGP, BED and scaffolding
    maps, and ``check-results`` against the truth (printed as one JSON
    line).  Every file the stages write lands in ``directory``."""
    def f(name):
        return os.path.join(directory, name)

    asm, reads = f("assembly.fasta"), f("reads.fasta")
    return [
        ("dust", ["dust", asm, f("dust.mask.npz")]),
        ("tandem", ["tandem", asm, f("tan.mask.npz")]),
        ("align", ["align", asm, f("self.las.npz"), "--mask",
                   f("dust.mask.npz"), f("tan.mask.npz")]),
        ("mask-self", ["mask", asm, f("self.las.npz"), f("self.mask.npz"),
                       "--max-coverage-self", "4"]),
        ("merge-masks", ["merge-masks", f("merged.mask.npz"),
                         f("dust.mask.npz"), f("tan.mask.npz"),
                         f("self.mask.npz")]),
        ("map", ["map", asm, reads, f("reads.las.npz"), "--mask",
                 f("merged.mask.npz")]),
        ("mask-reads", ["mask", asm, f("reads.las.npz"), f("reads.mask.npz"),
                        "--reads-db", reads, "--read-coverage", "20.0"]),
        ("merge-masks-reads", ["merge-masks", f("repeats.mask.npz"),
                               f("merged.mask.npz"), f("reads.mask.npz")]),
        ("collect", ["collect", asm, reads, f("reads.las.npz"),
                     f("pile-ups.npz"), "--mask", f("repeats.mask.npz")]),
        ("process-0", ["process", asm, reads, f("reads.las.npz"),
                       f("pile-ups.npz"), f("insertions.0.npz"), "--mask",
                       f("repeats.mask.npz"), "--batch", f"0..{split}"]),
        ("process-1", ["process", asm, reads, f("reads.las.npz"),
                       f("pile-ups.npz"), f("insertions.1.npz"), "--mask",
                       f("repeats.mask.npz"), "--batch", f"{split}..99"]),
        ("merge-insertions", ["merge-insertions", f("insertions.npz"),
                              f("insertions.0.npz"), f("insertions.1.npz")]),
        ("output", ["output", asm, f("insertions.npz"), f("out.fasta"),
                    "--agp", f("out.agp"), "--closed-gaps-bed",
                    f("out.closed-gaps.bed"), "--scaffolding",
                    f("scaffolding.json")]),
        ("check-results", ["check-results", f("truth.fasta"), asm,
                           f("out.fasta"), "-j"]),
    ]


def closed_exactly(sc: Scenario, out_seqs: list[np.ndarray],
                   flank: int = 500) -> int:
    """Number of gaps whose true sequence, ``flank`` bp either side
    included, appears verbatim in one of the output scaffolds."""
    n = 0
    for _, b, e in sc.gaps.iv:
        window = sc.truth[b - flank : e + flank]
        n += any(_contains(o, window) for o in out_seqs)
    return n


def closed_exactly_in(sc: Scenario, fasta_path: str, flank: int = 500) -> int:
    """:func:`closed_exactly` over the scaffolds of an output FASTA."""
    return closed_exactly(sc, [r.codes for r in read_fasta(fasta_path)], flank)


def _contains(haystack: np.ndarray, needle: np.ndarray) -> bool:
    if len(needle) > len(haystack):
        return False
    win = np.lib.stride_tricks.sliding_window_view(haystack, len(needle))
    step = 1 << 16
    for s in range(0, len(win), step):
        if (win[s : s + step] == needle).all(axis=1).any():
            return True
    return False
