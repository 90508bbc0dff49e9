"""Seeded simulated gap-closing scenarios, written to FASTA.

Two scenarios drive the port end to end:

- :func:`e2e_scenario` — the ``tests/test_e2e.py`` scenario: a 60 kb
  genome with 3 gaps of 80–300 bp and 20× reads of 10 kb ± 4 kb at 13 %
  error (seeds 50/51/52).
- :func:`phase_a_scenario` — the ``bench.py`` phase-A scenario: a 3 Mb
  genome with 16 gaps of 50–500 bp and 20× reads of 25 kb ± 12.5 kb at
  13 % error (seeds 123/124/125).

Both are pure functions of their seeds, so the FASTA files
:func:`write_scenario` produces are byte-identical across machines.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .io.fasta import (FastaRecord, codes_to_seq, read_fasta,
                       write_fasta)
from .sim.genome import random_genome
from .sim.partial import build_partial_assembly, random_gaps
from .sim.reads import simulate_reads
from .utils.regions import Region

__all__ = ["Scenario", "e2e_scenario", "phase_a_scenario", "write_scenario",
           "closed_exactly", "closed_exactly_in"]


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
