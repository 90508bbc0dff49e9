"""Masking stages of the port.

``tandem_mask`` builds an :class:`~dentist_tpu_torch.ops.aligner.Aligner`
and therefore runs on the port's extension kernel; it is a copy of
``dentist_tpu.models.mask.tandem_mask`` with that import re-pointed.
Every other masking function is host code and is re-exported from
``dentist_tpu.models.mask``.
"""

from __future__ import annotations

import numpy as np

from dentist_tpu.models.mask import (  # noqa: F401  (re-exports)
    chain_intervals,
    coverage_mask,
    dust_mask,
    pack_chain_intervals,
    propagate_mask,
    propagate_mask_b_to_a,
    repeat_coverage_bounds_improper,
    repeat_coverage_bounds_reads,
    validation_min_coverage,
)
from dentist_tpu.ops.seeding import kmer_codes
from dentist_tpu.utils.regions import Region

__all__ = [
    "dust_mask",
    "tandem_mask",
    "coverage_mask",
    "chain_intervals",
    "pack_chain_intervals",
    "repeat_coverage_bounds_reads",
    "repeat_coverage_bounds_improper",
    "validation_min_coverage",
    "propagate_mask",
    "propagate_mask_b_to_a",
]


def tandem_mask(
    codes: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    k: int = 12,
    max_unit: int = 4000,
    min_alignment: int = 500,
    max_error: float = 0.30,
    min_size: int = 500,
    config=None,
) -> Region:
    """Tandem-repeat mask by banded self-alignment (datander + TANmask).

    Each sequence is aligned against itself on the near-diagonal bands
    only: seeds are consecutive same-k-mer occurrence pairs at distance
    ``(0, max_unit]`` (the tandem unit), extended with the production
    banded trace-point kernel at the reference's datander invocation (``-k12 -l<minAnchorLength=500>
    -e<1-maxAlignmentError=.70>``, ``commandline.d:2865-2876,2036``).  TANmask semantics turn the
    resulting self-alignments into mask intervals: whenever the A and B
    intervals of a self-alignment overlap or touch (``b_end ≥
    a_begin``), the array span ``[b_begin, a_end)`` is masked; merged
    intervals below ``min_size`` (TANmask ``-l500`` default) are
    dropped.  Tags are 1-based sequence ids.
    """
    from ..ops.aligner import Aligner, AlignerConfig

    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)

    class _MetaIndex:
        """Store metadata shim: the self-alignment seeds are injected, so
        no k-mer table is built (mirrors :class:`KmerIndex`'s surface)."""

        def __init__(self):
            self.offsets, self.lengths = offsets, lengths

        def seq_id_of(self, global_pos):
            return np.searchsorted(self.offsets, global_pos,
                                   side="right").astype(np.int64)

    cfg = config or AlignerConfig(k=k, min_length=min_alignment,
                                  max_error=max_error)
    # query_store = the store itself: tandem rides the resident
    # dispatch path, as the JAX package's does, so the lanes read the
    # sequence from the device store instead of host-built windows
    aligner = Aligner(_MetaIndex(), codes, cfg,
                      query_store=(codes, offsets))
    for i, (o, L) in enumerate(zip(offsets, lengths)):
        seq = codes[o : o + L]
        km = kmer_codes(seq, k)
        if len(km) == 0:
            continue
        order = np.argsort(km, kind="stable")
        km_s = km[order]
        pos_s = order.astype(np.int64)
        same = km_s[1:] == km_s[:-1]
        d = pos_s[1:] - pos_s[:-1]
        m = same & (d >= 1) & (d <= max_unit)
        if not m.any():
            continue
        # A is the later copy: diag = a − b = unit ∈ (0, max_unit]
        a_pos = o + pos_s[1:][m]
        b_pos = pos_s[:-1][m]
        aligner.align_query(seq, i + 1, strands=(False,),
                            seeds={False: (a_pos, b_pos)}, self_tandem=True)
    las = aligner.finish()
    if len(las) == 0:
        return Region()
    tandem = las.b_end >= las.a_begin  # A/B intervals overlap or touch
    if not tandem.any():
        return Region()
    triples = np.stack([
        las.a_id[tandem],
        np.minimum(las.b_begin[tandem], las.a_begin[tandem]),
        np.maximum(las.a_end[tandem], las.b_end[tandem]),
    ], axis=1).astype(np.int64)
    return Region(triples).filter_min_size(min_size)
