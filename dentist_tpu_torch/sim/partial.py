"""Gapped test-assembly builder.

Replaces chosen intervals of a true genome with ``n`` runs, producing the
fragmented "test assembly" whose gaps the pipeline must close — the
semantics of ``mk-test-assembly.awk`` / the testing-only
``build-partial-assembly`` command
(``source/dentist/commands/buildPartialAssembly.d``).
"""

from __future__ import annotations

import numpy as np

from ..io.fasta import CODE_N
from ..utils.regions import Region

__all__ = ["build_partial_assembly", "random_gaps"]


def build_partial_assembly(true_records: list[np.ndarray], gaps: Region) -> list[np.ndarray]:
    """Return copies of the true sequences with `gaps` intervals set to N.

    `gaps` tags are record indices (0-based).
    """
    out = []
    for sid, rec in enumerate(true_records):
        g = rec.copy()
        for b, e in gaps.for_tag(sid):
            g[b:e] = CODE_N
        out.append(g)
    return out


def random_gaps(
    true_records: list[np.ndarray],
    n_gaps: int,
    min_size: int = 50,
    max_size: int = 500,
    margin: int = 5000,
    seed: int = 7,
) -> Region:
    """Pick `n_gaps` non-overlapping random gap intervals, away from ends.

    `margin` keeps gaps far enough from sequence ends (and from each other)
    that flanking contigs give reads a ≥`margin` anchor, mirroring the
    test-data design of the reference example (gaps are tens to hundreds of
    bp inside multi-Mbp scaffolds).
    """
    rng = np.random.default_rng(seed)
    triples = []
    placed: list[tuple[int, int, int]] = []
    attempts = 0
    while len(triples) < n_gaps and attempts < n_gaps * 100:
        attempts += 1
        sid = int(rng.integers(0, len(true_records)))
        L = len(true_records[sid])
        if L < 2 * margin + max_size:
            continue
        size = int(rng.integers(min_size, max_size + 1))
        begin = int(rng.integers(margin, L - margin - size))
        end = begin + size
        if any(s == sid and not (end + margin <= b or e + margin <= begin) for s, b, e in placed):
            continue
        placed.append((sid, begin, end))
        triples.append((sid, begin, end))
    return Region.from_triples(triples)
