"""Synthetic genome generation.

Generates random DNA with optional interspersed repeat families and tandem
arrays so masking stages have realistic work (reference tests use a real
~200 kb genome slice; we fabricate equivalents deterministically).
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_genome", "insert_repeats", "insert_tandem"]


def random_genome(length: int, seed: int = 0, gc: float = 0.5) -> np.ndarray:
    """Uniform-ish random DNA codes (0..3) of `length` bases."""
    rng = np.random.default_rng(seed)
    p_at = (1.0 - gc) / 2
    p_gc = gc / 2
    return rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at]).astype(np.uint8)


def insert_repeats(
    genome: np.ndarray,
    n_copies: int,
    repeat_length: int,
    seed: int = 1,
    divergence: float = 0.02,
) -> np.ndarray:
    """Overwrite `n_copies` random loci with diverged copies of one repeat.

    Produces interspersed repeats that a coverage-based repeat masker must
    find (reference: `mask-repetitive-regions` semantics).
    """
    rng = np.random.default_rng(seed)
    g = genome.copy()
    unit = rng.integers(0, 4, repeat_length).astype(np.uint8)
    for _ in range(n_copies):
        pos = int(rng.integers(0, len(g) - repeat_length))
        copy = unit.copy()
        n_mut = rng.binomial(repeat_length, divergence)
        sites = rng.choice(repeat_length, size=n_mut, replace=False)
        copy[sites] = (copy[sites] + rng.integers(1, 4, n_mut)) % 4
        g[pos : pos + repeat_length] = copy
    return g


def insert_tandem(
    genome: np.ndarray, position: int, unit_length: int, n_units: int, seed: int = 2
) -> np.ndarray:
    """Overwrite a locus with a tandem array (unit repeated n_units times)."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, unit_length).astype(np.uint8)
    arr = np.tile(unit, n_units)
    g = genome.copy()
    g[position : position + len(arr)] = arr[: max(0, len(g) - position)]
    return g
