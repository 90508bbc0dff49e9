"""FASTA parsing / emission and base-code conversion.

Bases are coded A=0, C=1, G=2, T=3 (the 2-bit code used throughout the
framework, matching the Dazzler convention so 2-bit packed arrays diff
cleanly against ``.bps`` files).  Parsing is vectorized NumPy: the whole
file is read as one byte array, newlines and headers located with
``flatnonzero``, and base translation is a 256-entry lookup table — no
per-character Python.

Reference counterpart: ``source/dentist/util/fasta.d`` (zero-copy parser,
``reverseComplement``) and the FASTA emission rules of
``source/dentist/commands/output.d`` (line-wrapped writer).
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "FastaRecord",
    "read_fasta",
    "write_fasta",
    "seq_to_codes",
    "codes_to_seq",
    "reverse_complement",
    "CODE_A",
    "CODE_C",
    "CODE_G",
    "CODE_T",
    "CODE_N",
]

CODE_A, CODE_C, CODE_G, CODE_T = 0, 1, 2, 3
#: Sentinel code for any non-ACGT character (gap/N). Stored out-of-band
#: in scaffold structure; never enters alignment kernels.
CODE_N = 4

_LUT = np.full(256, CODE_N, dtype=np.uint8)
for _c, _v in zip(b"AaCcGgTt", [0, 0, 1, 1, 2, 2, 3, 3]):
    _LUT[_c] = _v

_BASES = np.frombuffer(b"acgtn", dtype=np.uint8)
_BASES_UPPER = np.frombuffer(b"ACGTN", dtype=np.uint8)

_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


@dataclass
class FastaRecord:
    """One FASTA record: full header line (without '>') and coded sequence."""

    header: str
    codes: np.ndarray  # uint8 codes 0..4

    @property
    def name(self) -> str:
        return self.header.split()[0] if self.header else ""

    def __len__(self) -> int:
        return len(self.codes)


def _open_maybe_gz(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path_or_bytes) -> list[FastaRecord]:
    """Parse a (possibly gzipped) FASTA file into coded records."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = np.frombuffer(bytes(path_or_bytes), dtype=np.uint8)
    else:
        with _open_maybe_gz(str(path_or_bytes)) as fh:
            data = np.frombuffer(fh.read(), dtype=np.uint8)
    if data.size == 0:
        return []
    # Locate line starts.
    nl = np.flatnonzero(data == ord("\n"))
    line_starts = np.concatenate([[0], nl + 1])
    line_ends = np.concatenate([nl, [len(data)]])
    valid = line_starts < len(data)
    line_starts, line_ends = line_starts[valid], line_ends[valid]
    is_header = data[line_starts] == ord(">")

    records: list[FastaRecord] = []
    header_idx = np.flatnonzero(is_header)
    if len(header_idx) == 0:
        raise ValueError("not a FASTA file: no '>' header found")
    # Strip possible trailing '\r'
    for k, h in enumerate(header_idx):
        hs, he = line_starts[h], line_ends[h]
        if he > hs and data[he - 1] == ord("\r"):
            he -= 1
        header = data[hs + 1 : he].tobytes().decode("ascii", "replace")
        lo = h + 1
        hi = header_idx[k + 1] if k + 1 < len(header_idx) else len(line_starts)
        parts = []
        for li in range(lo, hi):
            s, e = line_starts[li], line_ends[li]
            if e > s and data[e - 1] == ord("\r"):
                e -= 1
            if e > s:
                parts.append(data[s:e])
        seq = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
        records.append(FastaRecord(header, _LUT[seq]))
    return records


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray, upper: bool | np.ndarray = False) -> str:
    """Codes → sequence string.

    `upper` may be a bool or a per-base boolean mask (used by the output
    stage to highlight inserted sequence in uppercase, mirroring
    ``output.d:859`` "uppercase highlight").
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if isinstance(upper, np.ndarray):
        out = np.where(upper, _BASES_UPPER[codes], _BASES[codes])
    elif upper:
        out = _BASES_UPPER[codes]
    else:
        out = _BASES[codes]
    return out.tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    # 3 − code complements ACGT in a vector subtract (~5× the table
    # gather's throughput — this runs over every read in the mapper);
    # rare non-ACGT codes (N = 4) wrap past 3 and are restored
    codes = np.asarray(codes, dtype=np.uint8)
    rev = codes[::-1]
    out = np.empty_like(codes)
    np.subtract(3, rev, out=out)
    if len(out) and codes.max() > 3:
        bad = rev > 3
        out[bad] = rev[bad]
    return out


def write_fasta(fh_or_path, records, line_width: int = 50):
    """Write records as FASTA with fixed line wrapping.

    `records` yields (header, sequence_string) pairs; sequence strings may
    already carry case information (see :func:`codes_to_seq`).
    The default line width of 50 matches the reference's ``--fasta-line-width``
    default (``source/dentist/commandline.d`` option ``fastaLineWidth``).
    """
    own = False
    if isinstance(fh_or_path, (str, bytes)):
        fh = open(fh_or_path, "w")
        own = True
    else:
        fh = fh_or_path
    try:
        for header, seq in records:
            fh.write(f">{header}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i : i + line_width])
                fh.write("\n")
    finally:
        if own:
            fh.close()
