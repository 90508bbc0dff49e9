"""Cut the pile-ups of chosen gaps, with what processing them reads, from
a pipeline run's workdir into a small fixture directory.

    python scripts/cut_pile_up_fixture.py RUN_DIR OUT_DIR 45-46 50-51

``RUN_DIR`` holds ``assembly.fasta``, ``reads.fasta`` and the ``work/``
of a ``pipeline --workdir`` run (``scripts/phase_c_reference.py`` keeps
one).  Each ``A-B`` names a gap by the contig ids of its pile-up.
``OUT_DIR`` receives, in the workdir's own formats (``io/store.py``):

- ``sequences.npz``: the contigs and reads those pile-ups' chains touch
  (``contig_codes``/``contig_lengths``, ``read_codes``/``read_lengths``),
  renumbered 1.. in their original order (``contig_ids`` and
  ``read_ids`` hold the original ids);
- ``reads.las.npz``: those chains and their alignments, renumbered;
- ``pile-ups.npz``: the pile-ups, on the renumbered chains;
- ``repeats-H.mask.npz``: the homogenized repeat mask (the one the
  process stage reads) on the kept contigs;
- ``insertions.npz``: the run's insertions for those gaps, renumbered.

Renumbering keeps every order the process stage reads, so
``process_pile_ups`` over the fixture is the run's process stage over
those pile-ups alone.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from dentist_tpu_torch.io.fasta import read_fasta
    from dentist_tpu_torch.io.store import (load_alignments, load_insertions,
                                            load_mask, load_pile_ups,
                                            save_alignments, save_insertions,
                                            save_mask, save_pile_ups)
    from dentist_tpu_torch.ops.chain import Chain
    from dentist_tpu_torch.models.pileups import ReadAlignmentRep, SeededChain
    from dentist_tpu_torch.models.sequences import split_scaffolds
    from dentist_tpu_torch.utils.regions import Region

    run, out, *names = sys.argv[1:]
    work = os.path.join(run, "work")
    want = {tuple(int(c) for c in n.split("-")) for n in names}
    las, chains = load_alignments(os.path.join(work, "reads.las.npz"))
    pile_ups = load_pile_ups(os.path.join(work, "pile-ups.npz"))

    def contigs_of(p):
        return {chains[part.chain_idx].a_id for rep in p for part in rep.parts}

    keep = [p for p in pile_ups if tuple(sorted(contigs_of(p))) in want]
    if len(keep) != len(want):
        sys.exit(f"found {len(keep)} pile-ups for {sorted(want)}")
    old_chains = sorted({part.chain_idx for p in keep for rep in p
                         for part in rep.parts})
    contig_ids = np.array(sorted({chains[k].a_id for k in old_chains}))
    read_ids = np.array(sorted({chains[k].b_id for k in old_chains}))
    new_contig = {int(c): i + 1 for i, c in enumerate(contig_ids)}
    new_read = {int(r): i + 1 for i, r in enumerate(read_ids)}
    new_chain = {k: i for i, k in enumerate(old_chains)}

    idx = np.concatenate([chains[k].indices for k in old_chains])
    sub = las.select(idx)
    sub.a_id = np.array([new_contig[int(a)] for a in sub.a_id], dtype=sub.a_id.dtype)
    sub.b_id = np.array([new_read[int(b)] for b in sub.b_id], dtype=sub.b_id.dtype)
    sub.chain_id = np.array([new_chain.get(int(c), -1) for c in sub.chain_id],
                            dtype=sub.chain_id.dtype)
    sub_chains, off = [], 0
    for k in old_chains:
        ch = chains[k]
        n = len(ch.indices)
        sub_chains.append(Chain(indices=np.arange(off, off + n), a_id=new_contig[ch.a_id],
                                b_id=new_read[ch.b_id], complement=ch.complement,
                                score=ch.score, alternate=ch.alternate))
        off += n

    contigs, _ = split_scaffolds(read_fasta(os.path.join(run, "assembly.fasta")))
    reads = {i + 1: r.codes for i, r in enumerate(read_fasta(os.path.join(run, "reads.fasta")))
             if i + 1 in new_read}
    os.makedirs(out, exist_ok=True)
    np.savez_compressed(
        os.path.join(out, "sequences.npz"),
        contig_ids=contig_ids, read_ids=read_ids,
        contig_codes=np.concatenate([contigs.get(int(c)) for c in contig_ids]),
        contig_lengths=np.array([contigs.lengths[c - 1] for c in contig_ids]),
        read_codes=np.concatenate([reads[int(r)] for r in read_ids]),
        read_lengths=np.array([len(reads[int(r)]) for r in read_ids]))
    save_alignments(os.path.join(out, "reads.las.npz"), sub, sub_chains)
    save_pile_ups(os.path.join(out, "pile-ups.npz"), [
        [ReadAlignmentRep(tuple(SeededChain(new_chain[part.chain_idx], part.seed)
                                for part in rep.parts)) for rep in p] for p in keep])
    iv = load_mask(os.path.join(work, "repeats-H.mask.npz")).iv
    iv = iv[np.isin(iv[:, 0], contig_ids)].copy()
    iv[:, 0] = [new_contig[int(c)] for c in iv[:, 0]]
    save_mask(os.path.join(out, "repeats-H.mask.npz"), Region.from_triples(iv))
    ins = [i for i in load_insertions(os.path.join(work, "insertions.npz"))
           if (i.start_node[0], i.end_node[0]) in want]
    for i in ins:
        i.start_node = (new_contig[i.start_node[0]], i.start_node[1])
        i.end_node = (new_contig[i.end_node[0]], i.end_node[1])
        i.read_ids = [new_read[int(r)] for r in i.read_ids]
    save_insertions(os.path.join(out, "insertions.npz"), ins)
    print(f"{len(keep)} pile-ups, {len(contig_ids)} contigs, {len(read_ids)} reads, "
          f"{len(sub)} alignments in {len(sub_chains)} chains, {len(ins)} insertions; "
          f"{sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))} bytes")


if __name__ == "__main__":
    main()
