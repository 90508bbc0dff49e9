"""Dazzler database (.db/.dam) binary edges.

The reference drives every stage through Dazzler databases created by
``fasta2DB``/``fasta2DAM`` and consumed via the DAZZ_DB C structs
(``/root/reference/source/dentist/dazzler.d:137-140`` lists the hidden
files; the struct layout is DAZZ_DB/DAZZ_READ from DAZZ_DB's ``DB.h``).
This module reads and writes those files natively so assemblies/read
sets prepared for the reference toolchain can be ingested directly (and
our stores exported for A/B diffing against it):

- ``name.db`` / ``name.dam``: small text stub listing source FASTA files
  and (after DBsplit) block partitions,
- ``.name.idx``: binary — a 112-byte DAZZ_DB header followed by one
  40-byte DAZZ_READ record per sequence,
- ``.name.bps``: 2-bit packed bases, first base in the HIGH bits of each
  byte (DAZZ_DB ``Compress_Read``),
- ``.name.hdr`` (.dam only): the original FASTA header lines; each
  contig's DAZZ_READ.coff points at its scaffold's header.

DAZZ_READ fields (DB.h): ``origin`` (well / contig # in scaffold),
``rlen``, ``fpulse`` (first pulse / contig offset in scaffold), ``boff``
(byte offset into .bps), ``coff`` (.hdr offset for .dam), ``flags``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

__all__ = ["DazzDB", "read_dazz", "write_db", "write_dam", "hidden_files"]

#: struct DAZZ_DB on-disk prefix (x86-64 alignment): see DB.h
_DB_HEADER = np.dtype([
    ("ureads", "<i4"), ("treads", "<i4"), ("cutoff", "<i4"), ("allarr", "<i4"),
    ("freq", "<f4", 4),
    ("maxlen", "<i4"), ("_pad0", "<i4"),
    ("totlen", "<i8"),
    ("nreads", "<i4"), ("trimmed", "<i4"), ("part", "<i4"),
    ("ufirst", "<i4"), ("tfirst", "<i4"), ("_pad1", "<i4"),
    ("path", "<u8"), ("loaded", "<i4"), ("_pad2", "<i4"),
    ("bases", "<u8"), ("reads", "<u8"), ("tracks", "<u8"),
])  # 112 bytes

_DAZZ_READ = np.dtype([
    ("origin", "<i4"), ("rlen", "<i4"), ("fpulse", "<i4"), ("_pad0", "<i4"),
    ("boff", "<i8"), ("coff", "<i8"),
    ("flags", "<i4"), ("_pad1", "<i4"),
])  # 40 bytes

assert _DB_HEADER.itemsize == 112 and _DAZZ_READ.itemsize == 40


def hidden_files(db_path: str) -> list[str]:
    """The hidden data files of a .db/.dam (dazzler.d:137-140)."""
    d, base = os.path.split(db_path)
    stem, ext = os.path.splitext(base)
    suffixes = [".bps", ".idx"] if ext == ".db" else [".bps", ".hdr", ".idx"]
    return [os.path.join(d, f".{stem}{s}") for s in suffixes]


def _pack_2bit(codes: np.ndarray) -> bytes:
    """Compress_Read layout: first base in the high 2 bits of each byte."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes.astype(np.uint8) & 3,
                        np.zeros(pad, np.uint8)]).reshape(-1, 4)
    return ((c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]) \
        .astype(np.uint8).tobytes()


def _unpack_2bit(buf: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(buf, dtype=np.uint8)
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = (b >> 6) & 3
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:n]


@dataclass
class DazzDB:
    """An in-memory Dazzler database."""

    is_dam: bool
    #: per record: (name, origin, fpulse, codes); for a .dam, records are
    #: contigs and `name` is their scaffold's FASTA header
    names: list[str]
    origins: np.ndarray
    fpulses: np.ndarray
    codes_list: list[np.ndarray]

    @property
    def lengths(self) -> np.ndarray:
        return np.array([len(c) for c in self.codes_list], dtype=np.int64)

    def scaffold_records(self) -> list[tuple[str, np.ndarray]]:
        """Reassemble (.dam) contigs into gapped scaffolds; code 4 = N.

        For a .db this is just the read list.
        """
        if not self.is_dam:
            return list(zip(self.names, self.codes_list))
        out = []
        n = len(self.names)
        starts = [t for t in range(n) if self.origins[t] == 0] + [n]
        for i, j in zip(starts[:-1], starts[1:]):
            end = int(self.fpulses[j - 1]) + len(self.codes_list[j - 1])
            seq = np.full(end, 4, dtype=np.uint8)
            for t in range(i, j):
                fp = int(self.fpulses[t])
                seq[fp : fp + len(self.codes_list[t])] = self.codes_list[t]
            out.append((self.names[i], seq))
        return out


def read_dazz(db_path: str) -> DazzDB:
    """Read a .db/.dam with its hidden .idx/.bps(/.hdr) files."""
    is_dam = db_path.endswith(".dam")
    hidden = hidden_files(db_path)
    bps_path, idx_path = hidden[0], hidden[-1]
    with open(idx_path, "rb") as f:
        hdr = np.frombuffer(f.read(_DB_HEADER.itemsize), dtype=_DB_HEADER)[0]
        ureads = int(hdr["ureads"])
        reads = np.frombuffer(f.read(ureads * _DAZZ_READ.itemsize),
                              dtype=_DAZZ_READ)
    bps = np.fromfile(bps_path, dtype=np.uint8)

    codes_list = []
    for rec in reads:
        boff, rlen = int(rec["boff"]), int(rec["rlen"])
        nbytes = (rlen + 3) // 4
        codes_list.append(_unpack_2bit(bps[boff : boff + nbytes], rlen))

    if is_dam:
        hdr_path = hidden[1]
        with open(hdr_path, "rb") as f:
            hdr_bytes = f.read()
        names = []
        for rec in reads:
            coff = int(rec["coff"])
            end = hdr_bytes.index(b"\n", coff)
            line = hdr_bytes[coff:end].decode()
            names.append(line[1:] if line.startswith(">") else line)
    else:
        # read names follow DBshow's "prolog/origin/fpulse_end" convention
        prolog = "reads"
        with open(db_path) as f:
            lines = f.read().splitlines()
        for ln in lines:
            parts = ln.split()
            if len(parts) == 3 and parts[0].isdigit():
                prolog = parts[2]
                break
        names = [
            f"{prolog}/{int(r['origin'])}/{int(r['fpulse'])}_"
            f"{int(r['fpulse']) + int(r['rlen'])}"
            for r in reads
        ]
    return DazzDB(is_dam=is_dam, names=names,
                  origins=reads["origin"].astype(np.int64),
                  fpulses=reads["fpulse"].astype(np.int64),
                  codes_list=codes_list)


def _write_common(db_path, entries, is_dam, source_name, prolog):
    """entries: list of (header, origin, fpulse, coff, codes)."""
    hidden = hidden_files(db_path)
    bps_path, idx_path = hidden[0], hidden[-1]
    n = len(entries)
    reads = np.zeros(n, dtype=_DAZZ_READ)
    counts = np.zeros(4, dtype=np.int64)
    boff = 0
    with open(bps_path, "wb") as f:
        for i, (_, origin, fpulse, coff, codes) in enumerate(entries):
            reads[i]["origin"] = origin
            reads[i]["rlen"] = len(codes)
            reads[i]["fpulse"] = fpulse
            reads[i]["boff"] = boff
            reads[i]["coff"] = coff
            packed = _pack_2bit(codes)
            f.write(packed)
            boff += len(packed)
            counts += np.bincount(codes & 3, minlength=4)
    total = int(sum(len(e[4]) for e in entries))
    hdr = np.zeros(1, dtype=_DB_HEADER)
    hdr[0]["ureads"] = n
    hdr[0]["treads"] = n
    hdr[0]["cutoff"] = -1
    hdr[0]["freq"] = (counts / max(total, 1)).astype(np.float32)
    hdr[0]["maxlen"] = max((len(e[4]) for e in entries), default=0)
    hdr[0]["totlen"] = total
    hdr[0]["nreads"] = n
    with open(idx_path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(reads.tobytes())
    with open(db_path, "w") as f:
        f.write("files = %9d\n" % 1)
        f.write("  %9d %s %s\n" % (n, source_name, prolog))


def write_db(db_path: str, reads: list[np.ndarray], prolog: str = "reads",
             source_name: str = "reads"):
    """Write a read database (.db + hidden .idx/.bps)."""
    assert db_path.endswith(".db")
    entries = [("", i, 0, 0, np.asarray(c, np.uint8)) for i, c in enumerate(reads)]
    _write_common(db_path, entries, False, source_name, prolog)


def write_dam(dam_path: str, scaffolds: list[tuple[str, np.ndarray]],
              source_name: str = "assembly"):
    """Write an assembly map (.dam + hidden .idx/.bps/.hdr).

    ``scaffolds``: (name, codes) with code 4 (or anything > 3) marking N
    gap characters; contigs are split at N runs like ``fasta2DAM``.
    """
    assert dam_path.endswith(".dam")
    hdr_path = hidden_files(dam_path)[1]
    entries = []
    coff = 0
    with open(hdr_path, "wb") as hf:
        for name, codes in scaffolds:
            line = (">" + name + "\n").encode()
            hf.write(line)
            codes = np.asarray(codes, dtype=np.uint8)
            isbase = codes < 4
            # contig runs of non-N bases
            d = np.diff(isbase.astype(np.int8))
            starts = list(np.flatnonzero(d == 1) + 1)
            ends = list(np.flatnonzero(d == -1) + 1)
            if len(codes) and isbase[0]:
                starts.insert(0, 0)
            if len(codes) and isbase[-1]:
                ends.append(len(codes))
            for ci, (b, e) in enumerate(zip(starts, ends)):
                entries.append((name, ci, b, coff, codes[b:e]))
            coff += len(line)
    _write_common(dam_path, entries, True, source_name, "assembly")
