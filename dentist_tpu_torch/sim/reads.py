"""Long-read simulator with PacBio-CLR-like error model.

Mirrors the semantics of the Dazzler ``simulator`` tool as used by the
reference tests (``tests/test-commands.sh:7-13``: ``-m25000 -s12500 -e.13
-c20``): read lengths ~ N(mean, sd) clipped to [min_len, source length],
uniform start positions, random strand, and per-base errors at rate ``e``
split between insertions/deletions/substitutions with a CLR-like mix.
Ground-truth placements are recorded per read (the reference keeps them in
the simulated read headers for ``find-closable-gaps``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.fasta import reverse_complement

__all__ = ["ReadGroundTruth", "simulate_reads"]


@dataclass
class ReadGroundTruth:
    """True placement of a simulated read on the source genome."""

    read_id: int  # 1-based
    scaffold_id: int  # 0-based source record index
    begin: int  # coordinates on the forward strand of the source
    end: int
    complement: bool

    def header(self) -> str:
        strand = "-" if self.complement else "+"
        return (
            f"sim_read_{self.read_id} scaffold={self.scaffold_id}"
            f" begin={self.begin} end={self.end} strand={strand}"
        )


def _mutate(codes: np.ndarray, rng: np.random.Generator, error: float,
            mix=(0.55, 0.25, 0.20)) -> np.ndarray:
    """Apply CLR-like errors: (ins, del, sub) fractions of total error."""
    n = len(codes)
    if n == 0 or error <= 0:
        return codes
    p_ins, p_del, p_sub = (error * m for m in mix)
    r = rng.random(n)
    is_del = r < p_del
    is_sub = (r >= p_del) & (r < p_del + p_sub)
    is_ins = (r >= p_del + p_sub) & (r < p_del + p_sub + p_ins)

    subs = codes.copy()
    n_sub = int(is_sub.sum())
    subs[is_sub] = (codes[is_sub] + rng.integers(1, 4, n_sub)) % 4

    # Build output with repeats: kept bases output once (possibly
    # substituted), deleted bases zero times, insertion sites output the
    # base plus one random inserted base before it.
    reps = np.ones(n, dtype=np.int64)
    reps[is_del] = 0
    reps[is_ins] = 2
    out = np.repeat(subs, reps)
    # For an insertion site the two copies are [inserted, original]; the
    # first copy starts at the cumulative output offset of that site.
    starts = np.cumsum(np.concatenate([[0], reps[:-1]]))
    ins_pos = starts[is_ins]
    out[ins_pos] = rng.integers(0, 4, len(ins_pos)).astype(np.uint8)
    return out


def simulate_reads(
    source_records: list[np.ndarray],
    coverage: float = 20.0,
    mean_length: int = 25000,
    sd_length: int = 12500,
    min_length: int = 500,
    error: float = 0.13,
    seed: int = 19339,
) -> tuple[list[np.ndarray], list[ReadGroundTruth]]:
    """Simulate reads off forward/reverse strands of the source sequences.

    `source_records` are coded sequences (one per scaffold of the *true*
    genome — reads cross assembly gaps because they come from the truth).
    Returns (read code arrays, ground-truth placements).
    """
    rng = np.random.default_rng(seed)
    lengths = np.array([len(s) for s in source_records], dtype=np.float64)
    if lengths.sum() == 0:
        return [], []
    probs = lengths / lengths.sum()
    target = coverage * lengths.sum()
    reads: list[np.ndarray] = []
    truths: list[ReadGroundTruth] = []
    total = 0
    while total < target:
        sid = int(rng.choice(len(source_records), p=probs))
        src = source_records[sid]
        L = int(np.clip(rng.normal(mean_length, sd_length), min_length, len(src)))
        begin = int(rng.integers(0, len(src) - L + 1))
        end = begin + L
        frag = src[begin:end]
        comp = bool(rng.random() < 0.5)
        if comp:
            frag = reverse_complement(frag)
        read = _mutate(frag, rng, error)
        reads.append(read)
        truths.append(ReadGroundTruth(len(reads), sid, begin, end, comp))
        total += L
    return reads, truths
