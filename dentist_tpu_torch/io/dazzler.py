"""Dazzler binary format edges: ``.las`` alignments and mask tracks.

Import/export for golden comparison against the reference toolchain
(SURVEY §7: "keep Dazzler-format import/export only at the edges").
Formats mirror the reference's direct binary parsers:

- ``.las`` (``dazzler.d:1447`` ``LocalAlignmentReader`` /
  ``DazzlerOverlap`` ``:1988-2031``, itself mirroring ``dalign.h``):
  header ``int64 numLocalAlignments, int32 tracePointDistance``; per
  record the 40 on-disk bytes of ``Overlap`` after the trace pointer —
  ``int32 tlen, diffs, abpos, bbpos, aepos, bepos; uint32 flags;
  int32 aread, bread`` plus 4 padding bytes — followed by ``tlen`` trace
  elements: ``uint8`` pairs for spacing ≤ 125, ``uint16`` pairs above
  (``TRACE_XOVR = 125``); pairs are (numDiffs, numBasePairs).
  Read ids are 0-based on disk, 1-based in memory.
- mask tracks (``readMask``/``writeMask``, ``dazzler.d:4943-5120``):
  ``.anno`` = ``int32 numReads, int32 size(=0)`` + ``(numReads+1)``
  ``int64`` byte offsets into ``.data``; ``.data`` = ``int32``
  begin/end pairs.
"""

from __future__ import annotations

import struct

import numpy as np

from ..models.alignments import LocalAlignmentSet, TRACE_SPACING
from ..utils.regions import Region

__all__ = ["read_las", "write_las", "read_mask", "write_mask",
           "read_dazz_extra", "write_dazz_extra", "LAS_FLAGS"]

LAS_FLAGS = {
    "complement": 0x1,
    "chain_start": 0x4,
    "chain_continuation": 0x8,
    "best_chain": 0x10,
    "disabled": 0x20,
}

_HEAD = struct.Struct("<iiiiiiIii4x")  # 40 bytes after the trace pointer


def write_las(path, las: LocalAlignmentSet, trace_spacing: int = TRACE_SPACING):
    large = trace_spacing > 125
    trace_dtype = np.dtype("<u2") if large else np.dtype("<u1")
    # Emit chains contiguously: canonical sort order can interleave LAs of
    # different chains of the same (a, b) pair, and the reference reader
    # (dazzler.d:1744-1747) treats chainStart without bestChain as an
    # *alternate* chain.  All chains stored here are selected winners, so the
    # first member of each chain carries chainStart|bestChain and subsequent
    # members chainContinuation, regardless of original row adjacency.
    order: list[int] = []
    emitted_chains: set[int] = set()
    chain_members: dict[int, list[int]] = {}
    for i in range(len(las)):
        cid = int(las.chain_id[i])
        if cid >= 0:
            chain_members.setdefault(cid, []).append(i)
    for i in range(len(las)):
        cid = int(las.chain_id[i])
        if cid < 0:
            order.append(i)
        elif cid not in emitted_chains:
            emitted_chains.add(cid)
            order.extend(chain_members[cid])
    with open(path, "wb") as fh:
        fh.write(struct.pack("<qi", len(las), trace_spacing))
        prev_cid = -2
        for i in order:
            td, tb = las.trace(i)
            tlen = 2 * len(td)
            flags = 0
            if las.complement[i]:
                flags |= LAS_FLAGS["complement"]
            if las.disabled[i]:
                flags |= LAS_FLAGS["disabled"]
            cid = int(las.chain_id[i])
            if cid >= 0:
                if cid == prev_cid:
                    flags |= LAS_FLAGS["chain_continuation"]
                else:
                    flags |= LAS_FLAGS["chain_start"] | LAS_FLAGS["best_chain"]
            prev_cid = cid
            fh.write(_HEAD.pack(
                tlen, int(las.diffs[i]),
                int(las.a_begin[i]), int(las.b_begin[i]),
                int(las.a_end[i]), int(las.b_end[i]),
                flags, int(las.a_id[i]) - 1, int(las.b_id[i]) - 1,
            ))
            trace = np.empty(tlen, dtype=trace_dtype)
            trace[0::2] = td
            trace[1::2] = tb
            fh.write(trace.tobytes())


def read_las(path) -> tuple[LocalAlignmentSet, int]:
    """Read a ``.las`` file; returns (LocalAlignmentSet, trace_spacing)."""
    with open(path, "rb") as fh:
        data = fh.read()
    n, trace_spacing = struct.unpack_from("<qi", data, 0)
    large = trace_spacing > 125
    trace_dtype = np.dtype("<u2") if large else np.dtype("<u1")
    itemsize = trace_dtype.itemsize
    off = 12
    cols = {k: [] for k in ("a_id", "b_id", "comp", "ab", "ae", "bb", "be",
                            "diffs", "chain", "disabled")}
    tds, tbs, counts = [], [], []
    chain_counter = -1
    for _ in range(n):
        tlen, diffs, abpos, bbpos, aepos, bepos, flags, aread, bread = \
            _HEAD.unpack_from(data, off)
        off += _HEAD.size
        trace = np.frombuffer(data, dtype=trace_dtype, count=tlen, offset=off)
        off += tlen * itemsize
        if flags & LAS_FLAGS["chain_start"]:
            chain_counter += 1
            chain = chain_counter
        elif flags & LAS_FLAGS["chain_continuation"]:
            chain = chain_counter
        else:
            chain = -1
        cols["a_id"].append(aread + 1)
        cols["b_id"].append(bread + 1)
        cols["comp"].append(bool(flags & LAS_FLAGS["complement"]))
        cols["ab"].append(abpos)
        cols["ae"].append(aepos)
        cols["bb"].append(bbpos)
        cols["be"].append(bepos)
        cols["diffs"].append(diffs)
        cols["chain"].append(chain)
        cols["disabled"].append(bool(flags & LAS_FLAGS["disabled"]))
        tds.append(trace[0::2].astype(np.int32))
        tbs.append(trace[1::2].astype(np.int32))
        counts.append(tlen // 2)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    las = LocalAlignmentSet(
        a_id=np.array(cols["a_id"], dtype=np.int32),
        b_id=np.array(cols["b_id"], dtype=np.int32),
        complement=np.array(cols["comp"], dtype=bool),
        a_begin=np.array(cols["ab"], dtype=np.int32),
        a_end=np.array(cols["ae"], dtype=np.int32),
        b_begin=np.array(cols["bb"], dtype=np.int32),
        b_end=np.array(cols["be"], dtype=np.int32),
        diffs=np.array(cols["diffs"], dtype=np.int32),
        trace_offsets=offsets,
        trace_diffs=(np.concatenate(tds) if tds else np.empty(0, np.int32)),
        trace_b_adv=(np.concatenate(tbs) if tbs else np.empty(0, np.int32)),
        chain_id=np.array(cols["chain"], dtype=np.int64),
        disabled=np.array(cols["disabled"], dtype=bool),
    )
    return las, trace_spacing


def write_mask(anno_path, data_path, region: Region, num_reads: int):
    """Write a Region (tags = 1-based contig ids) as a Dazzler mask track."""
    pointers = [0]
    chunks = []
    byte_off = 0
    for cid in range(1, num_reads + 1):
        pairs = region.for_tag(cid).astype("<i4")
        chunk = pairs.reshape(-1).tobytes()
        chunks.append(chunk)
        byte_off += len(chunk)
        pointers.append(byte_off)
    with open(anno_path, "wb") as fh:
        fh.write(struct.pack("<ii", num_reads, 0))
        fh.write(np.array(pointers, dtype="<i8").tobytes())
    with open(data_path, "wb") as fh:
        for chunk in chunks:
            fh.write(chunk)


def write_dazz_extra(anno_path, name: str, data, accum_mode: int = 0):
    """Append a ``DazzExtra`` record to a mask ``.anno`` file.

    Layout (``dazzler.d:5327-5345`` ``writeDazzExtra``): ``int32[4]``
    header ``[vtype, dataLength, accumMode, nameLength]`` followed by the
    raw name bytes and ``dataLength`` 8-byte elements (``int64`` for
    vtype 0, ``float64`` for vtype 1).  Extras are appended after the
    mask header + pointer table, any number per track.  ``accum_mode``:
    0 = exact-match across blocks, 1 = vector sum (``dazzler.d:5176``).
    """
    arr = np.asarray(data)
    if arr.dtype.kind == "f":
        arr, vtype = arr.astype("<f8"), 1
    else:
        arr, vtype = arr.astype("<i8"), 0
    name_b = name.encode()
    with open(anno_path, "ab") as fh:
        fh.write(struct.pack("<iiii", vtype, len(arr), accum_mode, len(name_b)))
        fh.write(name_b)
        fh.write(arr.tobytes())


def read_dazz_extra(anno_path, name: str):
    """Read the ``DazzExtra`` called ``name``; ``None`` if absent.

    Mirrors ``readDazzExtra`` (``dazzler.d:5243-5310``): skip the mask
    header (``int32 numReads, size`` + ``numReads+1`` ``int64``
    pointers), then scan extra records until the name matches.
    """
    with open(anno_path, "rb") as fh:
        num_reads, _size = struct.unpack("<ii", fh.read(8))
        fh.seek(8 * (num_reads + 1), 1)
        while True:
            head = fh.read(16)
            if len(head) < 16:
                return None
            vtype, dlen, _accum, namelen = struct.unpack("<iiii", head)
            cur = fh.read(namelen).decode()
            raw = fh.read(8 * dlen)
            if cur == name:
                return np.frombuffer(raw, dtype="<f8" if vtype == 1 else "<i8")


def read_mask(anno_path, data_path) -> Region:
    with open(anno_path, "rb") as fh:
        num_reads, size = struct.unpack("<ii", fh.read(8))
        assert size == 0, f"corrupted mask: expected size 0, got {size}"
        pointers = np.frombuffer(fh.read(8 * (num_reads + 1)), dtype="<i8")
    data = np.fromfile(data_path, dtype="<i4")
    triples = []
    for cid in range(1, num_reads + 1):
        lo, hi = pointers[cid - 1] // 4, pointers[cid] // 4
        pairs = data[lo:hi].reshape(-1, 2)
        for b, e in pairs:
            triples.append((cid, int(b), int(e)))
    return Region.from_triples(triples) if triples else Region()
