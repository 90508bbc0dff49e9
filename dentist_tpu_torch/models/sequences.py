"""Sequence stores and assembly scaffold structure.

The assembly and the read set are each held as a :class:`SeqStore` — one
concatenated uint8 code array plus offsets — the in-memory analogue of a
Dazzler DB/DAM (2-bit ``.bps`` + ``.idx``).  Splitting scaffolds at non-ACGT
runs into contigs + gaps mirrors ``fasta2DAM`` and
``getScaffoldStructure``/``ContigSegment``/``GapSegment``
(``source/dentist/dazzler.d:4609-4652``).

Contig ids are 1-based throughout, matching the Dazzler/reference
convention (contig ``A.contigId``/``readId`` start at 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import FastaRecord, read_fasta, CODE_N

__all__ = ["SeqStore", "ContigSegment", "GapSegment", "ScaffoldStructure", "load_assembly", "load_reads"]


@dataclass
class ContigSegment:
    """A contiguous ACGT run within a scaffold.

    Mirrors ``ContigSegment`` (``dazzler.d:4625``): global 1-based contig id,
    scaffold id, position within the scaffold, and coordinates in original
    scaffold space.
    """

    global_contig_id: int  # 1-based
    scaffold_id: int  # 0-based index into scaffold headers
    contig_id: int  # 0-based index within the scaffold
    begin: int  # scaffold coordinate
    end: int

    @property
    def length(self) -> int:
        return self.end - self.begin


@dataclass
class GapSegment:
    """A run of non-ACGT (gap) between two contigs of the same scaffold.

    Mirrors ``GapSegment`` (``dazzler.d:4652``).
    """

    begin_global_contig_id: int
    end_global_contig_id: int
    scaffold_id: int
    begin: int  # scaffold coordinate of gap start
    end: int

    @property
    def length(self) -> int:
        return self.end - self.begin


@dataclass
class ScaffoldStructure:
    headers: list[str]  # per scaffold
    contigs: list[ContigSegment]
    gaps: list[GapSegment]

    def segments_of(self, scaffold_id: int):
        """Interleaved contigs and gaps of one scaffold, in order."""
        segs = [c for c in self.contigs if c.scaffold_id == scaffold_id] + [
            g for g in self.gaps if g.scaffold_id == scaffold_id
        ]
        segs.sort(key=lambda s: s.begin)
        return segs


class SeqStore:
    """Concatenated coded sequences + offsets (struct-of-arrays).

    ``codes`` is one uint8 array of 2-bit base codes (0..3); sequence *i*
    (0-based; public ids are 1-based) lives at
    ``codes[offsets[i]:offsets[i] + lengths[i]]``.
    """

    def __init__(self, codes: np.ndarray, lengths: np.ndarray, names: list[str] | None = None):
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)])[:-1]
        self.names = names or [str(i + 1) for i in range(len(self.lengths))]

    def __len__(self) -> int:
        return len(self.lengths)

    @property
    def total_length(self) -> int:
        return int(self.lengths.sum())

    def get(self, seq_id: int) -> np.ndarray:
        """Sequence by 1-based id."""
        i = seq_id - 1
        o = self.offsets[i]
        return self.codes[o : o + self.lengths[i]]

    def slice(self, seq_id: int, begin: int, end: int) -> np.ndarray:
        i = seq_id - 1
        o = self.offsets[i]
        assert 0 <= begin <= end <= self.lengths[i], (seq_id, begin, end, self.lengths[i])
        return self.codes[o + begin : o + end]

    @classmethod
    def from_records(cls, records: list[FastaRecord], replace_n: int | None = 0) -> "SeqStore":
        """Build a store from FASTA records (reads path: N→code `replace_n`)."""
        codes_list = []
        lengths = []
        names = []
        for r in records:
            c = r.codes
            if replace_n is not None:
                c = np.where(c == CODE_N, np.uint8(replace_n), c)
            codes_list.append(c)
            lengths.append(len(c))
            names.append(r.name)
        codes = np.concatenate(codes_list) if codes_list else np.empty(0, dtype=np.uint8)
        return cls(codes, np.array(lengths, dtype=np.int64), names)


def split_scaffolds(records: list[FastaRecord]) -> tuple[SeqStore, ScaffoldStructure]:
    """Split scaffold records at non-ACGT runs into a contig store + structure.

    Every maximal run of non-ACGT characters separates contigs, as
    ``fasta2DAM`` does; contigs keep their scaffold coordinates so output
    can reconstruct the original scaffolding exactly.
    """
    headers = [r.header for r in records]
    contigs: list[ContigSegment] = []
    gaps: list[GapSegment] = []
    codes_list: list[np.ndarray] = []
    lengths: list[int] = []
    gid = 0
    for sid, rec in enumerate(records):
        c = rec.codes
        is_base = c != CODE_N
        if len(c) == 0:
            continue
        # boundaries of ACGT runs
        diff = np.diff(is_base.astype(np.int8))
        starts = np.flatnonzero(diff == 1) + 1
        ends = np.flatnonzero(diff == -1) + 1
        if is_base[0]:
            starts = np.concatenate([[0], starts])
        if is_base[-1]:
            ends = np.concatenate([ends, [len(c)]])
        prev_gid = None
        prev_end = None
        for k, (b, e) in enumerate(zip(starts, ends)):
            gid += 1
            contigs.append(ContigSegment(gid, sid, k, int(b), int(e)))
            codes_list.append(c[b:e])
            lengths.append(int(e - b))
            if prev_gid is not None:
                gaps.append(GapSegment(prev_gid, gid, sid, int(prev_end), int(b)))
            prev_gid, prev_end = gid, e
    codes = np.concatenate(codes_list) if codes_list else np.empty(0, dtype=np.uint8)
    store = SeqStore(codes, np.array(lengths, dtype=np.int64), [str(c.global_contig_id) for c in contigs])
    return store, ScaffoldStructure(headers, contigs, gaps)


def load_assembly(path) -> tuple[SeqStore, ScaffoldStructure]:
    """Load an assembly from FASTA or a Dazzler ``.dam``/``.db`` database
    (so assemblies prepared for the reference toolchain work directly)."""
    if str(path).endswith((".dam", ".db")):
        from ..io.dazzdb import read_dazz

        db = read_dazz(str(path))
        records = [FastaRecord(name, codes)
                   for name, codes in db.scaffold_records()]
        return split_scaffolds(records)
    return split_scaffolds(read_fasta(path))


def load_reads(path) -> SeqStore:
    """Load reads from FASTA or a Dazzler ``.db`` database."""
    if str(path).endswith((".db", ".dam")):
        from ..io.dazzdb import read_dazz

        db = read_dazz(str(path))
        return SeqStore.from_records(
            [FastaRecord(n, c) for n, c in db.scaffold_records()])
    return SeqStore.from_records(read_fasta(path))
