"""Insertion model: gap-filling / extension sequences with splice metadata.

Reference counterpart: ``source/dentist/common/insertions.d``
(``InsertionInfo{sequence, contigLength, overlaps, readIds}``) and the
insertion records of ``processPileUps`` (``makeInsertion``,
``processPileUps/package.d:789-805``).

An :class:`Insertion` joins two scaffold-graph nodes (gap) or one real
node and its transcendent neighbor (extension).  ``sequence`` is stored
in *walk orientation*: the bases that appear in the output scaffold when
the linear walk leaves ``start_node``'s contig and enters ``end_node``'s
contig.  Splicing is at the contig's gap-facing edge — the full contig is
kept and the insertion supplies everything beyond it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .scaffold import ContigPart, Node

__all__ = ["Insertion"]


@dataclass
class Insertion:
    start_node: Node
    end_node: Node
    #: insertion bases, oriented start_node → end_node
    sequence: np.ndarray
    #: ids of reads supporting the insertion (consensus inputs)
    read_ids: list[int]
    #: consensus↔flank alignment error (max over flanks)
    error: float = 0.0
    #: number of reads in the pile-up
    n_reads: int = 0
    #: bases to trim from each flank contig's gap-facing edge when the
    #: consensus implies the contigs overlap (the reference's cropping
    #: positions, ``insertions.d:107-284`` + ``output.d fixCropping``);
    #: keyed to start_node / end_node respectively
    crop_start_node: int = 0
    crop_end_node: int = 0

    def __post_init__(self):
        if self.end_node < self.start_node:
            self.start_node, self.end_node = self.end_node, self.start_node
            self.sequence = _revcomp(self.sequence)
            self.crop_start_node, self.crop_end_node = (
                self.crop_end_node, self.crop_start_node)

    @property
    def is_gap(self) -> bool:
        return (
            self.start_node[0] != self.end_node[0]
            and self.start_node[1].is_real
            and self.end_node[1].is_real
        )

    @property
    def is_extension(self) -> bool:
        return self.start_node[0] == self.end_node[0]

    def oriented(self, from_node: Node) -> np.ndarray:
        """Sequence as seen when walking out of `from_node`."""
        if from_node == self.start_node:
            return self.sequence
        return _revcomp(self.sequence)


def _revcomp(codes: np.ndarray) -> np.ndarray:
    comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
    return comp[np.asarray(codes, dtype=np.uint8)][::-1]
