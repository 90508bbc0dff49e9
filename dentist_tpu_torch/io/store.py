"""On-disk containers for intermediate pipeline state.

The binary-container equivalent of the reference's ``binio/`` layer
(``PileUpDb``/``InsertionDb``, ``source/dentist/common/binio/``): typed
array slabs with an index, here realized as compressed ``.npz`` files —
the arrays are already struct-of-arrays, so (de)serialization is direct.
The reference's advisory file locking is unnecessary: every writer owns
its output path (batch outputs are merged explicitly, as the reference's
``merge-insertions`` does).

Formats:
- ``*.las.npz``     — LocalAlignmentSet (+ optional chain structure)
- ``*.mask.npz``    — Region (tagged intervals)
- ``*.pileups.npz`` — pile-ups with their chain/LAS context
- ``*.insertions.npz`` — insertion records
"""

from __future__ import annotations

import numpy as np

from ..models.alignments import LocalAlignmentSet
from ..models.insertions import Insertion
from ..models.pileups import ReadAlignmentRep, SeededChain, Seed
from ..models.scaffold import ContigPart
from ..ops.chain import Chain
from ..utils.regions import Region

__all__ = [
    "save_alignments", "load_alignments",
    "save_mask", "load_mask",
    "save_pile_ups", "load_pile_ups",
    "save_insertions", "load_insertions",
]


# -- alignments --------------------------------------------------------

def save_alignments(path, las: LocalAlignmentSet, chains: list[Chain] | None = None):
    data = {
        "a_id": las.a_id, "b_id": las.b_id, "complement": las.complement,
        "a_begin": las.a_begin, "a_end": las.a_end,
        "b_begin": las.b_begin, "b_end": las.b_end,
        "diffs": las.diffs, "trace_offsets": las.trace_offsets,
        "trace_diffs": las.trace_diffs, "trace_b_adv": las.trace_b_adv,
        "chain_id": las.chain_id, "disabled": las.disabled,
    }
    if chains is not None:
        data["chain_lens"] = np.array([len(c.indices) for c in chains], dtype=np.int64)
        data["chain_indices"] = (
            np.concatenate([c.indices for c in chains]) if chains else np.empty(0, np.int64)
        )
        data["chain_scores"] = np.array([c.score for c in chains], dtype=np.int64)
        data["chain_alternate"] = np.array([c.alternate for c in chains], dtype=bool)
    np.savez_compressed(path, **data)


def load_alignments(path) -> tuple[LocalAlignmentSet, list[Chain] | None]:
    z = np.load(path, allow_pickle=False)
    las = LocalAlignmentSet(
        a_id=z["a_id"], b_id=z["b_id"], complement=z["complement"],
        a_begin=z["a_begin"], a_end=z["a_end"],
        b_begin=z["b_begin"], b_end=z["b_end"],
        diffs=z["diffs"], trace_offsets=z["trace_offsets"],
        trace_diffs=z["trace_diffs"], trace_b_adv=z["trace_b_adv"],
        chain_id=z["chain_id"], disabled=z["disabled"],
    )
    chains = None
    if "chain_lens" in z:
        chains = []
        off = 0
        for ln, sc, alt in zip(z["chain_lens"], z["chain_scores"], z["chain_alternate"]):
            idx = z["chain_indices"][off : off + ln]
            off += ln
            f = int(idx[0])
            chains.append(Chain(
                indices=idx, a_id=int(las.a_id[f]), b_id=int(las.b_id[f]),
                complement=bool(las.complement[f]), score=int(sc), alternate=bool(alt),
            ))
    return las, chains


# -- masks -------------------------------------------------------------

def save_mask(path, region: Region, extras: dict | None = None):
    """Persist a mask; ``extras`` optionally carries per-interval id lists
    (the reference's ``DazzExtra`` side-channel, ``dazzler.d:5190-5380``),
    e.g. ``{"contig_ids": [...], "read_ids": [...]}`` with one (possibly
    empty) id list per interval of ``region.iv``."""
    payload = {"intervals": region.iv}
    for name, lists in (extras or {}).items():
        assert len(lists) == len(region.iv), f"extra {name} misaligned"
        lens = np.array([len(x) for x in lists], dtype=np.int64)
        flat = (np.concatenate([np.asarray(x, dtype=np.int64) for x in lists])
                if lens.sum() else np.empty(0, np.int64))
        payload[f"extra_{name}_offsets"] = np.concatenate([[0], np.cumsum(lens)])
        payload[f"extra_{name}_data"] = flat
    np.savez_compressed(path, **payload)


def load_mask(path, with_extras: bool = False):
    z = np.load(path, allow_pickle=False)
    region = Region(z["intervals"], _normalized=True)
    if not with_extras:
        return region
    extras = {}
    for key in z.files:
        if key.startswith("extra_") and key.endswith("_offsets"):
            name = key[len("extra_") : -len("_offsets")]
            offs = z[key]
            data = z[f"extra_{name}_data"]
            extras[name] = [data[offs[i] : offs[i + 1]] for i in range(len(offs) - 1)]
    return region, extras


# -- pile-ups ----------------------------------------------------------

def save_pile_ups(path, pile_ups: list[list[ReadAlignmentRep]]):
    """Store pile-ups as flat arrays: rep boundaries + part (chain, seed)."""
    pu_lens = np.array([len(p) for p in pile_ups], dtype=np.int64)
    rep_lens, parts_chain, parts_seed = [], [], []
    for p in pile_ups:
        for rep in p:
            rep_lens.append(len(rep.parts))
            for part in rep.parts:
                parts_chain.append(part.chain_idx)
                parts_seed.append(int(part.seed))
    np.savez_compressed(
        path,
        pu_lens=pu_lens,
        rep_lens=np.array(rep_lens, dtype=np.int64),
        parts_chain=np.array(parts_chain, dtype=np.int64),
        parts_seed=np.array(parts_seed, dtype=np.int8),
    )


def load_pile_ups(path) -> list[list[ReadAlignmentRep]]:
    z = np.load(path, allow_pickle=False)
    pile_ups = []
    ri = 0
    pi = 0
    for n in z["pu_lens"]:
        reps = []
        for _ in range(n):
            m = int(z["rep_lens"][ri])
            ri += 1
            parts = tuple(
                SeededChain(int(z["parts_chain"][pi + k]), Seed(int(z["parts_seed"][pi + k])))
                for k in range(m)
            )
            pi += m
            reps.append(ReadAlignmentRep(parts))
        pile_ups.append(reps)
    return pile_ups


# -- insertions --------------------------------------------------------

def save_insertions(path, insertions: list[Insertion]):
    seq_lens = np.array([len(i.sequence) for i in insertions], dtype=np.int64)
    read_lens = np.array([len(i.read_ids) for i in insertions], dtype=np.int64)
    np.savez_compressed(
        path,
        start=np.array([[i.start_node[0], int(i.start_node[1])] for i in insertions],
                       dtype=np.int64).reshape(-1, 2),
        end=np.array([[i.end_node[0], int(i.end_node[1])] for i in insertions],
                     dtype=np.int64).reshape(-1, 2),
        seq_lens=seq_lens,
        sequences=(np.concatenate([i.sequence for i in insertions])
                   if insertions else np.empty(0, np.uint8)),
        read_lens=read_lens,
        read_ids=(np.concatenate([np.asarray(i.read_ids, dtype=np.int64) for i in insertions])
                  if insertions else np.empty(0, np.int64)),
        error=np.array([i.error for i in insertions], dtype=np.float64),
        n_reads=np.array([i.n_reads for i in insertions], dtype=np.int64),
        crop=np.array([[i.crop_start_node, i.crop_end_node]
                       for i in insertions], dtype=np.int64).reshape(-1, 2),
    )


def load_insertions(path) -> list[Insertion]:
    z = np.load(path, allow_pickle=False)
    out = []
    so = 0
    ro = 0
    for k in range(len(z["seq_lens"])):
        sl = int(z["seq_lens"][k])
        rl = int(z["read_lens"][k])
        out.append(Insertion(
            start_node=(int(z["start"][k, 0]), ContigPart(int(z["start"][k, 1]))),
            end_node=(int(z["end"][k, 0]), ContigPart(int(z["end"][k, 1]))),
            sequence=z["sequences"][so : so + sl],
            read_ids=list(z["read_ids"][ro : ro + rl]),
            error=float(z["error"][k]),
            n_reads=int(z["n_reads"][k]),
            # crop fields absent in containers written before they were
            # persisted (overlapping-contig joins need them to round-trip)
            crop_start_node=(int(z["crop"][k, 0]) if "crop" in z.files else 0),
            crop_end_node=(int(z["crop"][k, 1]) if "crop" in z.files else 0),
        ))
        so += sl
        ro += rl
    return out
