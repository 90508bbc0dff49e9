"""Seeded simulated gap-closing scenarios, written to FASTA.

Four scenarios drive the port end to end:

- :func:`e2e_scenario` — the ``tests/test_e2e.py`` scenario: a 60 kb
  genome with 3 gaps of 80–300 bp and 20× reads of 10 kb ± 4 kb at 13 %
  error (seeds 50/51/52).
- :func:`phase_a_scenario` — the ``bench.py`` phase-A scenario: a 3 Mb
  genome with 16 gaps of 50–500 bp and 20× reads of 25 kb ± 12.5 kb at
  13 % error (seeds 123/124/125).
- :func:`phase_c_scenario` — the ``bench.py`` phase-C scenario, the
  reference example's scale: a 28 Mb genome with 112 copies of a 3 kb
  interspersed repeat, 147 gaps of 100–1000 bp and phase A's read model
  (seeds 321/322/323/324); smaller sizes keep its model.
- :func:`scaffolds_repeats_scenario` — two scaffolds cut from one 2 Mb
  genome with interspersed repeats, 8 gaps of 100–1000 bp and phase A's
  read model, so the masks that mapping, collect and process read are
  not empty.

Both are pure functions of their seeds, so the FASTA files
:func:`write_scenario` and :func:`write_truth` produce are byte-identical
across machines.  :func:`staged_commands` is the staged workflow (one
CLI sub-command per stage, as DENTIST's Snakemake DAG runs them) over
such files, and :func:`phase_c_digests` the digests a run over them is
held to another run by (:func:`diff_digests` names what differs).
:func:`write_phase_c` and :func:`run_phase_c` are the one phase C runner
that ``scripts/phase_c_torch.py`` and ``bench_torch.py`` share, and
:func:`result_digests` digests in-memory stage results (``bench_torch.py``'s
phases A and B) as :func:`phase_c_digests` digests stage artifacts.

The suite scenarios (:data:`SUITE`) are the small cases of the JAX
package's tests of the modules that reach the device: the gap-closing
cases of ``tests/test_anchor_unique.py``, ``test_bubbles.py``,
``test_overlap_crop.py``, ``test_multiscaffold.py`` and
``test_validation_pass.py`` (:func:`gap_case`, :func:`bubble_case`) and
the read sets of ``tests/test_consensus.py`` (:func:`consensus_case`),
with those tests' seeds and sizes.  :func:`run_suite` runs one through
the modules it is given (the port's, :func:`port_modules`, or another
package's of the same names) and :func:`suite_digests` digests what it
returns.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np

from .io.fasta import (FastaRecord, codes_to_seq, read_fasta, seq_to_codes,
                       write_fasta)
from .models.sequences import SeqStore, split_scaffolds
from .sim.genome import insert_repeats, insert_tandem, random_genome
from .sim.partial import build_partial_assembly, random_gaps
from .sim.reads import _mutate, simulate_reads
from .utils.regions import Region

__all__ = ["Scenario", "e2e_scenario", "phase_a_scenario", "phase_c_scenario",
           "scaffolds_repeats_scenario", "unrelated_reads", "write_scenario",
           "repeat_assembly", "write_truth", "staged_commands",
           "closed_exactly", "closed_exactly_in", "inexact_gaps",
           "closed_gap_pairs", "result_digests", "write_phase_c",
           "run_phase_c", "SUITE", "SUITE_REFERENCE", "GapCase", "gap_case", "bubble_case",
           "consensus_case", "port_modules", "run_suite", "suite_digests"]


@dataclass
class Scenario:
    truths: list[np.ndarray]  # the true scaffolds (codes), one per record
    gaps: Region  # gap intervals punched into the truths (tag: record)
    assembly: list[FastaRecord]  # the gapped assembly
    reads: list[np.ndarray]


def _build(truths: list[np.ndarray], n_gaps: int, min_gap: int, max_gap: int,
           margin: int, mean_length: int, sd_length: int, seeds: tuple[int, int],
           ) -> Scenario:
    """Gaps (seed ``seeds[1]``) punched into ``truths`` and 20x reads
    (seed ``seeds[0]``) drawn from them at 13 % error."""
    gaps = random_gaps(truths, n_gaps=n_gaps, min_size=min_gap,
                       max_size=max_gap, margin=margin, seed=seeds[1])
    asm = build_partial_assembly(truths, gaps)
    records = [FastaRecord(f"scaf{i}", s) for i, s in enumerate(asm)]
    reads, _ = simulate_reads(truths, coverage=20, mean_length=mean_length,
                              sd_length=sd_length, error=0.13, seed=seeds[0])
    return Scenario(truths, gaps, records, reads)


def e2e_scenario() -> Scenario:
    return _build([random_genome(60_000, seed=50)], 3, 80, 300, 8000,
                  10_000, 4000, (52, 51))


def phase_a_scenario() -> Scenario:
    return _build([random_genome(3_000_000, seed=123)], 16, 50, 500, 20_000,
                  25_000, 12_500, (124, 125))


def phase_c_scenario(mb: float = 28, n_gaps: int = 147) -> Scenario:
    """``bench.py`` phase C at ``mb`` Mb: a random genome (seed 321) with
    ``4 * mb`` copies (rounded down) of a 3 kb repeat at 2 % divergence
    (seed 322), ``n_gaps`` gaps of 100–1000 bp at a 25 kb margin (seed
    323) and 20x reads of 25 kb ± 12.5 kb at 13 % error (seed 324), built
    in ``bench.py``'s order.  ``mb=3, n_gaps=16`` is the ``--small`` form
    of ``scripts/profile_e2e.py``."""
    g = random_genome(int(mb * 1_000_000), seed=321)
    g = insert_repeats(g, n_copies=int(4 * mb), repeat_length=3000, seed=322)
    return _build([g], n_gaps, 100, 1000, 25_000, 25_000, 12_500, (324, 323))


def scaffolds_repeats_scenario() -> Scenario:
    """A 2 Mb random genome with 8 copies of a 3 kb repeat at 2 %
    divergence (``insert_repeats`` as ``scripts/stress10.py`` plants
    them), cut at 1.2 Mb into two true scaffolds, with 8 gaps of
    100–1000 bp at a 50 kb margin and phase A's read model: 20x reads of
    25 kb ± 12.5 kb at 13 % error (seeds 140/141/142/143)."""
    g = random_genome(2_000_000, seed=140)
    g = insert_repeats(g, n_copies=8, repeat_length=3000, seed=141)
    return _build([g[:1_200_000], g[1_200_000:]], 8, 100, 1000, 50_000,
                  25_000, 12_500, (143, 142))


def unrelated_reads(n: int = 20, length: int = 9000, seed: int = 400
                    ) -> list[np.ndarray]:
    """``n`` random genomes of ``length`` bases (seeds ``seed``,
    ``seed + 1``, ...): reads that support no closed gap, as
    ``tests/test_validation_pass.py`` validates against."""
    return [random_genome(length, seed=seed + i) for i in range(n)]


def write_scenario(sc: Scenario, directory: str) -> tuple[str, str]:
    """Write ``assembly.fasta`` and ``reads.fasta``; returns both paths."""
    os.makedirs(directory, exist_ok=True)
    asm = os.path.join(directory, "assembly.fasta")
    reads = os.path.join(directory, "reads.fasta")
    write_fasta(asm, [(r.header, codes_to_seq(r.codes)) for r in sc.assembly])
    write_fasta(reads, [(f"read{i + 1}", codes_to_seq(r))
                        for i, r in enumerate(sc.reads)])
    return asm, reads


def repeat_assembly(length: int, copies: int, seed: int = 60
                    ) -> list[FastaRecord]:
    """A gapped assembly of a genome that carries what the masking stages
    exist for: ``copies`` copies of a 6 kb interspersed repeat at 1 %
    divergence, ``2 * copies`` of a 300 bp one at 5 %, and tandem arrays
    of 7, 40 and 171 bp units (2.1, 2.4 and 3.4 kb) at a quarter, half
    and three quarters of the genome; cut into contigs by ``copies // 4
    + 1`` gaps, so self-alignments pair repeat copies within and across
    contigs.  A pure function of its arguments."""
    g = random_genome(length, seed=seed)
    g = insert_repeats(g, copies, 6000, seed=seed + 1, divergence=0.01)
    g = insert_repeats(g, 2 * copies, 300, seed=seed + 2, divergence=0.05)
    for i, (unit, n) in enumerate(((7, 300), (40, 60), (171, 20))):
        g = insert_tandem(g, (i + 1) * length // 4, unit, n, seed=seed + 3 + i)
    gaps = random_gaps([g], n_gaps=copies // 4 + 1, min_size=50,
                       max_size=500, margin=length // 20, seed=seed + 6)
    return [FastaRecord(f"scaf{i}", s)
            for i, s in enumerate(build_partial_assembly([g], gaps))]


def write_truth(sc: Scenario, directory: str) -> str:
    """Write the true scaffolds as ``truth.fasta`` (one record ``truth``,
    or ``truth1``, ``truth2``, ...); returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "truth.fasta")
    names = (["truth"] if len(sc.truths) == 1
             else [f"truth{i + 1}" for i in range(len(sc.truths))])
    write_fasta(path, [(n, codes_to_seq(t)) for n, t in zip(names, sc.truths)])
    return path


def staged_commands(directory: str, split: int = 8
                    ) -> list[tuple[str, list[str]]]:
    """The staged workflow over ``assembly.fasta``, ``reads.fasta`` and
    ``truth.fasta`` in ``directory``: (stage name, CLI argv) pairs, run in
    order.  Masks (dust, tandem, self-alignment coverage, coverage of
    the scenarios' 20x reads), alignments, pile-ups, consensus in two
    batches (pile-ups ``0..split`` and ``split..99``, as a cluster runs
    them), merged insertions, the output with AGP, BED and scaffolding
    maps, and ``check-results`` against the truth (printed as one JSON
    line).  Every file the stages write lands in ``directory``."""
    def f(name):
        return os.path.join(directory, name)

    asm, reads = f("assembly.fasta"), f("reads.fasta")
    return [
        ("dust", ["dust", asm, f("dust.mask.npz")]),
        ("tandem", ["tandem", asm, f("tan.mask.npz")]),
        ("align", ["align", asm, f("self.las.npz"), "--mask",
                   f("dust.mask.npz"), f("tan.mask.npz")]),
        ("mask-self", ["mask", asm, f("self.las.npz"), f("self.mask.npz"),
                       "--max-coverage-self", "4"]),
        ("merge-masks", ["merge-masks", f("merged.mask.npz"),
                         f("dust.mask.npz"), f("tan.mask.npz"),
                         f("self.mask.npz")]),
        ("map", ["map", asm, reads, f("reads.las.npz"), "--mask",
                 f("merged.mask.npz")]),
        ("mask-reads", ["mask", asm, f("reads.las.npz"), f("reads.mask.npz"),
                        "--reads-db", reads, "--read-coverage", "20.0"]),
        ("merge-masks-reads", ["merge-masks", f("repeats.mask.npz"),
                               f("merged.mask.npz"), f("reads.mask.npz")]),
        ("collect", ["collect", asm, reads, f("reads.las.npz"),
                     f("pile-ups.npz"), "--mask", f("repeats.mask.npz")]),
        ("process-0", ["process", asm, reads, f("reads.las.npz"),
                       f("pile-ups.npz"), f("insertions.0.npz"), "--mask",
                       f("repeats.mask.npz"), "--batch", f"0..{split}"]),
        ("process-1", ["process", asm, reads, f("reads.las.npz"),
                       f("pile-ups.npz"), f("insertions.1.npz"), "--mask",
                       f("repeats.mask.npz"), "--batch", f"{split}..99"]),
        ("merge-insertions", ["merge-insertions", f("insertions.npz"),
                              f("insertions.0.npz"), f("insertions.1.npz")]),
        ("output", ["output", asm, f("insertions.npz"), f("out.fasta"),
                    "--agp", f("out.agp"), "--closed-gaps-bed",
                    f("out.closed-gaps.bed"), "--scaffolding",
                    f("scaffolding.json")]),
        ("check-results", ["check-results", f("truth.fasta"), asm,
                           f("out.fasta"), "-j"]),
    ]


def inexact_gaps(sc: Scenario, out_seqs: list[np.ndarray],
                 flank: int = 500) -> list[tuple[int, int, int]]:
    """The gaps (record, begin, end) whose true sequence, ``flank`` bp
    either side included, appears verbatim in none of the output
    scaffolds."""
    hay = [np.asarray(o, np.uint8).tobytes() for o in out_seqs]
    return [(int(sid), int(b), int(e)) for sid, b, e in sc.gaps.iv
            if not any(np.asarray(sc.truths[sid][b - flank : e + flank],
                                  np.uint8).tobytes() in h for h in hay)]


def closed_exactly(sc: Scenario, out_seqs: list[np.ndarray],
                   flank: int = 500) -> int:
    """Number of gaps whose true sequence, ``flank`` bp either side
    included, appears verbatim in one of the output scaffolds."""
    return len(sc.gaps.iv) - len(inexact_gaps(sc, out_seqs, flank))


def closed_exactly_in(sc: Scenario, fasta_path: str, flank: int = 500) -> int:
    """:func:`closed_exactly` over the scaffolds of an output FASTA."""
    return closed_exactly(sc, [r.codes for r in read_fasta(fasta_path)], flank)


def closed_gap_pairs(bed_rows) -> set:
    """The (contig id, contig id) pairs of the closed gaps that an
    output's BED rows name (their ``contigIds=a-b`` field): the pairs a
    validation pass purges."""
    return {tuple(int(c) for c in f.split("=")[1].split("-"))
            for row in bed_rows for f in row.split("\t")[3].split(";")
            if f.startswith("contigIds=")}


def file_sha256(path: str) -> str:
    """sha256 of a file's bytes, read 16 MiB at a time."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def arrays_sha256(arrays) -> str:
    """sha256 of named arrays (each one's name, dtype, shape and bytes,
    by name)."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(f"{key} {a.dtype.str} {a.shape}\n".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def npz_sha256(path) -> str:
    """:func:`arrays_sha256` of an npz container's arrays (a path or an
    open file), not of its zip headers, which carry times."""
    with np.load(path, allow_pickle=False) as z:
        return arrays_sha256({key: z[key] for key in z.files})


#: the arrays of a ``*.las.npz`` that hold its chains, not its alignments
CHAIN_ARRAYS = ("chain_lens", "chain_indices", "chain_scores", "chain_alternate")


def result_digests(las=None, chains=None, pile_ups=None, insertions=None
                   ) -> dict[str, str]:
    """The arrays' sha256 of in-memory stage results, taken as
    :func:`phase_c_digests` takes their stage artifacts: the arrays
    ``io.store`` saves to ``reads.las.npz`` (``alignments``, and
    ``chains`` for the :data:`CHAIN_ARRAYS`), ``pile-ups.npz``
    (``pile-ups``) and ``insertions.npz`` (``insertions``), for each
    result given."""
    import io

    from .io.store import save_alignments, save_insertions, save_pile_ups

    def arrays(save, *objs):
        buf = io.BytesIO()
        save(buf, *objs)
        buf.seek(0)
        with np.load(buf, allow_pickle=False) as z:
            return {key: z[key] for key in z.files}

    out = {}
    if las is not None:
        z = arrays(save_alignments, las, chains)
        out["alignments"] = arrays_sha256(
            {k: a for k, a in z.items() if k not in CHAIN_ARRAYS})
        if chains is not None:
            out["chains"] = arrays_sha256({k: z[k] for k in CHAIN_ARRAYS})
    if pile_ups is not None:
        out["pile-ups"] = arrays_sha256(arrays(save_pile_ups, pile_ups))
    if insertions is not None:
        out["insertions"] = arrays_sha256(arrays(save_insertions, insertions))
    return out


def gap_digests(records, bed: str) -> dict[str, dict]:
    """One digest per closed gap, keyed by its BED row's ``contigIds``
    field: the row and the sha256 of the codes of the inserted sequence
    it spans in the output ``records``."""
    seqs = {r.name: r.codes for r in records}
    out = {}
    with open(bed) as fh:
        for row in fh.read().splitlines():
            name, beg, end, data = row.split("\t")
            key = data.split(";")[0].split("=")[1]
            ins = np.ascontiguousarray(seqs[name][int(beg):int(end)])
            out[key] = {"row": row, "sha256": hashlib.sha256(ins).hexdigest()}
    return out


def phase_c_digests(sc: Scenario, directory: str, workdir: str,
                    inputs: str | None = None) -> dict:
    """The digests a phase C run is held by: the sha256 of the inputs in
    ``inputs`` (default ``directory``) and of the outputs in
    ``directory`` (``out.fasta`` with its AGP and BED), the
    arrays' sha256 (:func:`npz_sha256`) of every stage artifact in
    ``workdir`` and the sha256 of its ``validation.json``, one digest
    per closed gap (:func:`gap_digests`), the gaps closed and closed
    byte-exact, and the inexact ones (:func:`inexact_gaps`)."""
    def f(name):
        return os.path.join(directory, name)

    arts = sorted(n for n in os.listdir(workdir) if n.endswith(".mask.npz"))
    arts += ["reads.las.npz", "pile-ups.npz", "insertions.npz"]
    artifacts = {n: npz_sha256(os.path.join(workdir, n)) for n in arts}
    artifacts["validation.json"] = file_sha256(
        os.path.join(workdir, "validation.json"))
    records = read_fasta(f("out.fasta"))
    gaps = gap_digests(records, f("out.closed-gaps.bed"))
    inexact = inexact_gaps(sc, [r.codes for r in records])
    return {
        "inputs": {n: file_sha256(os.path.join(inputs or directory, n))
                   for n in ("assembly.fasta", "reads.fasta")},
        "sha256": {n: file_sha256(f(n)) for n in
                   ("out.fasta", "out.agp", "out.closed-gaps.bed")},
        "artifacts": artifacts,
        "gaps": gaps,
        "closed": len(gaps),
        "closed_exactly": len(sc.gaps.iv) - len(inexact),
        "inexact": [list(g) for g in inexact],
    }


def diff_digests(want: dict, got: dict) -> list[str]:
    """What differs between two :func:`phase_c_digests`: every file,
    artifact and closed gap by name (``gap a-b``), in that order."""
    diffs = [n for part in ("inputs", "sha256", "artifacts")
             for n in sorted(set(want[part]) | set(got[part]))
             if want[part].get(n) != got[part].get(n)]
    diffs += [f"gap {k}" for k in sorted(set(want["gaps"]) | set(got["gaps"]),
                                         key=lambda k: tuple(map(int, k.split("-"))))
              if want["gaps"].get(k) != got["gaps"].get(k)]
    return diffs


def write_phase_c(d: str, mb: float, gaps: int, want_inputs: dict
                  ) -> tuple[Scenario, str, str, float]:
    """``phase_c_scenario(mb, gaps)`` written to ``d`` (``assembly.fasta``,
    ``reads.fasta``, ``truth.fasta``); stops the process if an input does
    not hash as ``want_inputs`` says (a reference entry's ``inputs``: the
    data generator drifted).  Returns the scenario, the assembly's and
    the reads' paths, and the seconds taken."""
    import sys
    import time

    t0 = time.perf_counter()
    sc = phase_c_scenario(mb=mb, n_gaps=gaps)
    asm, reads = write_scenario(sc, d)
    write_truth(sc, d)
    seconds = time.perf_counter() - t0
    for path in (asm, reads):
        name, got = os.path.basename(path), file_sha256(path)
        if got != want_inputs[name]:
            sys.exit(f"phase C {mb:g} Mb: the data generator drifted: {name} "
                     f"sha256 {got} != the reference's {want_inputs[name]}")
    return sc, asm, reads, seconds


def run_phase_c(sc: Scenario, asm: str, reads: str, d: str, cuda: bool,
                recorder=None, store_capacity: int | None = None) -> dict:
    """One phase C run: ``run_pipeline`` on ``asm`` and ``reads`` (as
    :func:`write_phase_c` wrote them) with its output in ``d``
    (``out.fasta`` and its AGP and BED) and every stage artifact in
    ``d/work``, from a fresh device store (of ``store_capacity`` bytes:
    one too small for the reads sends their alignment down the
    host-window path, K1p, as at 100 Mb), the stage seconds and launch
    counts set to 0 first; on the card (``cuda``) its peak device memory
    counted from the start and its clock stopped after a synchronize.
    ``recorder``, a :class:`~dentist_tpu_torch.dryrun.LaunchRecorder`,
    records every launch's bucket (it keeps K3p metas and K4 inputs on
    the card, so without one the run is as a user's).  Returns the wall,
    ``STAGE_SECONDS`` by key, launches per kernel mode, the store's size
    (MiB) and its resets,
    peak device memory and host RSS (GiB), the recorder's ``summary()``
    as ``buckets``, and the run's :func:`phase_c_digests` with the
    seconds they took."""
    import contextlib
    import resource
    import time

    import torch

    from .dryrun import launch_counts, reset_launch_counts
    from .ops import banded
    from .pipeline import (STAGE_SECONDS, PipelineConfig,
                           reset_stage_seconds, run_pipeline)
    from .utils.log import tee_log_file

    work = os.path.join(d, "work")
    store = banded.reset_device_store(store_capacity)
    reset_stage_seconds()
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    epoch0 = banded.device_store().epoch
    with recorder or contextlib.nullcontext():
        t0 = time.perf_counter()
        run_pipeline(asm, reads, os.path.join(d, "out.fasta"),
                     PipelineConfig(read_coverage=20.0, workdir=work))
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tee_log_file(None)  # run_pipeline tees its log into the workdir
    run = {"wall_s": wall, "stage_seconds": dict(STAGE_SECONDS),
           "launches": {k: v for k, v in launch_counts().items() if v},
           "store_mib": store.capacity / 2**20,
           "store_resets": banded.device_store().epoch - epoch0,
           "peak_device_gib": (torch.cuda.max_memory_allocated() / 2**30
                               if cuda else None),
           "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}
    if recorder is not None:
        run["buckets"] = recorder.summary()
    t0 = time.perf_counter()
    run["digests"] = phase_c_digests(sc, d, work, inputs=os.path.dirname(asm))
    run["digest_s"] = time.perf_counter() - t0
    return run


# ======================================================================
# The JAX package's tests of device-reaching modules, as scenarios
# ======================================================================

#: the suite scenarios, each with the JAX test whose scenario it builds:
#: the gap-closing cases (:func:`gap_case`), then ``tests/test_consensus.py``'s
#: read sets (:func:`consensus_case`)
SUITE = {
    "repeat_edge": "tests/test_anchor_unique.py:87",
    "bubbles": "tests/test_bubbles.py:16",
    "overlap_crop": "tests/test_overlap_crop.py:15",
    "two_chromosomes": "tests/test_multiscaffold.py:15",
    "validation_kept": "tests/test_validation_pass.py:26",
    "validation_purged": "tests/test_validation_pass.py:33",
    "consensus_clean": "tests/test_consensus.py:57",
    "consensus_13pct": "tests/test_consensus.py:64",
    "consensus_low_coverage": "tests/test_consensus.py:71",
    "consensus_tie_policy": "tests/test_consensus.py:80",
    "consensus_seeds": "tests/test_consensus.py:94",
    "consensus_moderate": "tests/test_consensus.py:103",
    "consensus_variable_ends": "tests/test_consensus.py:121",
    "consensus_single_read": "tests/test_consensus.py:141",
    "consensus_win_diffs": "tests/test_consensus.py:147",
    "consensus_batch": "tests/test_consensus.py:157",
    "consensus_rank": "tests/test_consensus.py:176",
    "consensus_junk_template": "tests/test_consensus.py:190",
    "consensus_incremental": "tests/test_consensus.py:248",
}


#: the JAX package's digests of the suite scenarios in a checkout of the
#: repository: ``scripts/jax_suite_reference.py`` writes them (the JAX
#: package's CPU run of :func:`run_suite`), ``chip_smoke.py`` phase 19 and
#: ``tests/test_torch_suite_*.py`` hold the port to them
SUITE_REFERENCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
    "jax_suite_reference.json")


@dataclass
class GapCase:
    """A gapped assembly with its truths and reads as ``close_gaps``
    takes them, the ``PipelineConfig`` fields its test sets, and (bubbles
    only) the repeat mask its test maps under."""
    truths: list[np.ndarray]
    contigs: SeqStore
    structure: object
    reads: SeqStore
    read_list: list[np.ndarray]
    config: dict
    repeats: Region | None = None


def _gapped(truths, records, sim, named, config, repeats=None) -> GapCase:
    """``records`` split into contigs, and reads drawn from ``truths`` at
    13 % error with ``sim`` = (coverage, mean length, sd, seed)."""
    contigs, structure = split_scaffolds(records)
    coverage, mean, sd, seed = sim
    read_list, _ = simulate_reads(truths, coverage=coverage, mean_length=mean,
                                  sd_length=sd, error=0.13, seed=seed)
    names = [f"read{i + 1}" for i in range(len(read_list))] if named else None
    reads = SeqStore(np.concatenate(read_list),
                     np.array([len(r) for r in read_list]), names)
    return GapCase(truths, contigs, structure, reads, read_list, config,
                   repeats)


def gap_case(key: str) -> GapCase:
    """The gap-closing scenario of :data:`SUITE`'s ``key``, as its JAX test
    builds it."""
    if key == "repeat_edge":  # the entering contig's edge copied into the gap
        left = random_genome(10_000, seed=71)
        right = random_genome(10_000, seed=72)
        interior = np.concatenate([random_genome(400, seed=73), right[:300],
                                   random_genome(300, seed=74)])
        seq = codes_to_seq(left) + "n" * len(interior) + codes_to_seq(right)
        return _gapped([np.concatenate([left, interior, right])],
                       [FastaRecord("scaf0", seq_to_codes(seq))],
                       (20, 8000, 2000, 75), True,
                       {"no_validation": True, "read_coverage": 20.0})
    if key == "bubbles":  # c1 | gap | c2 (800 bp, masked) | gap | c3
        truths = [random_genome(40_000, seed=90)]
        gaps = Region.from_triples([(0, 18_000, 18_100), (0, 18_900, 19_000)])
        asm = build_partial_assembly(truths, gaps)
        return _gapped(truths, [FastaRecord("scaf0", asm[0])],
                       (20, 8000, 2000, 91), False, {},
                       Region.from_triples([(2, 0, 800)]))
    if key == "overlap_crop":  # the flank contigs share 200 bp
        truth = random_genome(24_000, seed=60)
        seq = (codes_to_seq(truth[:12_200]) + "n" * 50
               + codes_to_seq(truth[12_000:]))
        return _gapped([truth], [FastaRecord("scaf0", seq_to_codes(seq))],
                       (20, 8000, 2000, 61), True,
                       {"no_validation": True, "read_coverage": 20.0})
    if key == "two_chromosomes":
        truths = [random_genome(30_000, seed=500), random_genome(24_000, seed=501)]
        gaps = Region.from_triples([(0, 14_000, 14_150), (1, 11_000, 11_090)])
        asm = build_partial_assembly(truths, gaps)
        return _gapped(truths, [FastaRecord(f"chr{i + 1}", s)
                                for i, s in enumerate(asm)],
                       (18, 8000, 2500, 502), False, {"read_coverage": 18})
    if key in ("validation_kept", "validation_purged"):
        truths = [random_genome(40_000, seed=300)]
        gaps = random_gaps(truths, n_gaps=1, min_size=80, max_size=200,
                           margin=9000, seed=301)
        asm = build_partial_assembly(truths, gaps)
        config = {"read_coverage": 18}
        if key == "validation_purged":
            config["no_validation"] = True
        return _gapped(truths, [FastaRecord("s0", asm[0])],
                       (18, 9000, 2500, 302), False, config)
    raise KeyError(key)


def _noisy(truth: np.ndarray, n: int, error: float, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [_mutate(truth, rng, error) for _ in range(n)]


def consensus_case(key: str) -> list[tuple[np.ndarray, list[np.ndarray]]]:
    """The (truth, reads) pairs of :data:`SUITE`'s consensus ``key``, as
    ``tests/test_consensus.py`` draws them."""
    if key == "consensus_clean":
        t = random_genome(800, seed=1)
        return [(t, [t.copy() for _ in range(5)])]
    if key == "consensus_13pct":
        t = random_genome(1000, seed=2)
        return [(t, _noisy(t, 20, 0.13, 3))]
    if key == "consensus_low_coverage":
        t = random_genome(600, seed=4)
        return [(t, _noisy(t, 8, 0.13, 5))]
    if key == "consensus_tie_policy":
        t = random_genome(700, seed=61)
        return [(t, _noisy(t, 20, 0.13, 62))]
    if key == "consensus_seeds":
        return [(t, _noisy(t, 20, 0.13, seed + 50)) for seed in (100, 101, 102)
                for t in [random_genome(700, seed=seed)]]
    if key == "consensus_moderate":
        pairs = []
        for seed in (1000 + 0 * 7 + 14 * 131 + 600, 1000 + 7 * 7 + 14 * 131 + 600,
                     1000 + 5 * 7 + 14 * 131 + 1500, 1000 + 11 * 7 + 14 * 131 + 1500):
            length = 600 if seed < 1000 + 14 * 131 + 1000 else 1500
            t = random_genome(length, seed=seed)
            rng = np.random.default_rng(seed)
            pairs.append((t, [_mutate(t, rng, 0.13) for _ in range(14)]))
        return pairs
    if key == "consensus_variable_ends":
        t = random_genome(1500, seed=6)
        rng = np.random.default_rng(7)
        ends = [1500, 1500, 1500, 1200, 1000, 800, 1500, 1400, 1300, 1500,
                1500, 1500, 1100, 1500, 1500]
        return [(t, [_mutate(t[:e], rng, 0.13) for e in ends])]
    if key == "consensus_single_read":
        t = random_genome(300, seed=8)
        return [(t, [t])]
    if key == "consensus_win_diffs":
        t = random_genome(1000, seed=9)
        return [(t, _noisy(t, 15, 0.13, 10))]
    if key == "consensus_batch":
        return [(t, _noisy(t, 12, 0.13, seed + 7)) for seed in (200, 201, 202, 203)
                for t in [random_genome(400 + 137 * (seed % 3), seed=seed)]]
    if key == "consensus_rank":  # read 4 much worse than the rest
        t = random_genome(900, seed=30)
        reads = _noisy(t, 10, 0.13, 31)
        reads[4] = _mutate(t, np.random.default_rng(32), 0.45)
        return [(t, reads)]
    if key == "consensus_junk_template":  # the median-length read is junk
        t = random_genome(800, seed=40)
        reads = _noisy(t, 15, 0.13, 41)
        med = _median_read(reads)
        reads[med] = random_genome(len(reads[med]), seed=999)
        return [(t, reads)]
    if key == "consensus_incremental":
        t = random_genome(900, seed=31)
        return [(t, _noisy(t, 12, 0.12, 32))]
    raise KeyError(key)


def _median_read(reads) -> int:
    order = sorted(range(len(reads)), key=lambda i: len(reads[i]))
    return order[len(order) // 2]


def port_modules():
    """The port's modules :func:`run_suite` calls, by the names it uses."""
    from types import SimpleNamespace

    from . import pipeline
    from .models import pileups, process
    from .ops import consensus, mapper

    return SimpleNamespace(pipeline=pipeline, mapper=mapper, pileups=pileups,
                           process=process, consensus=consensus)


def run_suite(key: str, mods) -> dict:
    """:data:`SUITE`'s ``key`` through ``mods`` (:func:`port_modules`, or
    another package's ``pipeline``, ``mapper``, ``pileups``, ``process``
    and ``consensus`` modules), called as the JAX test calls them; returns
    the scenario (``case``) and what each call returned, by name."""
    if key.startswith("consensus_"):
        return _run_consensus(key, mods.consensus)
    case = gap_case(key)
    if key == "bubbles":
        c, PU = case.contigs, mods.pileups
        las, chains = mods.mapper.map_reads(
            c.codes, c.offsets, c.lengths, case.read_list,
            config=mods.mapper.MapperConfig(), mask_intervals=case.repeats.iv)
        ctx = PU.ChainCtx(las, chains, c.lengths, case.reads.lengths)
        plain = PU.collect_pile_ups(
            PU.ChainCtx(las, chains, c.lengths, case.reads.lengths),
            case.structure.gaps, case.repeats, PU.CollectConfig())
        pile_ups = PU.collect_pile_ups(ctx, case.structure.gaps, case.repeats,
                                       PU.CollectConfig(), contigs=c,
                                       reads=case.reads)
        insertions = mods.process.process_pile_ups(
            pile_ups, ctx, c, case.reads, case.repeats,
            mods.process.ProcessConfig())
        return {"case": case, "las": las, "chains": chains, "plain": plain,
                "ctx": ctx, "pile_ups": pile_ups, "insertions": insertions}
    P = mods.pipeline
    cfg = P.PipelineConfig(**case.config)
    result = P.close_gaps(case.contigs, case.structure, case.reads,
                          case.read_list, cfg)
    out = {"case": case, "result": result}
    if key == "validation_purged":  # against reads that support nothing
        noise = unrelated_reads()
        noise_store = SeqStore(np.concatenate(noise),
                               np.array([len(r) for r in noise]))
        out["skip"] = P._validation_pass(result, noise, noise_store, cfg)
    return out


def _run_consensus(key: str, C) -> dict:
    pairs = consensus_case(key)
    out = {"pairs": pairs}
    if key == "consensus_tie_policy":
        reads = pairs[0][1]
        out["results"] = [C.consensus(reads)] + [
            C.consensus(reads, tie_policy=p) for p in ("delete", "insert", "none")]
    elif key == "consensus_batch":
        sets = [reads for _, reads in pairs]
        out["results"] = C.consensus_batch(sets) + [C.consensus(rs) for rs in sets]
    elif key == "consensus_junk_template":
        reads = pairs[0][1]
        med = _median_read(reads)
        first = C.consensus(reads, template_idx=med)
        ranked = C.rank_reference_reads(first.win_diffs, first.read_spans)
        nxt = next(int(r) for r in ranked if int(r) != med)
        out.update(results=[first, C.consensus(reads, template_idx=nxt)],
                   ranked=ranked, med=med, next=nxt)
    elif key == "consensus_incremental":
        reads = pairs[0][1]
        template = reads[5]
        [base] = C._run_round([C._ConsJob(template, reads)], 128)
        [full] = C._run_round([C._ConsJob(template, reads, base.jpath)], 128)
        dirty = np.ones(len(template), dtype=bool)
        [inc] = C._run_round([C._ConsJob(template, reads, base.jpath,
                                         prev=base, dirty=dirty)], 128)
        out["rounds"] = [base, full, inc]
    else:
        out["results"] = [C.consensus(reads) for _, reads in pairs]
        if key == "consensus_rank":
            res = out["results"][0]
            out["ranked"] = C.rank_reference_reads(res.win_diffs, res.read_spans)
    return out


#: the fields of a consensus result and of a realign round that the suite
#: digests hold
CONSENSUS_FIELDS = ("sequence", "read_diffs", "read_spans", "win_diffs",
                    "coverage")
ROUND_FIELDS = ("sym", "ins", "jpath", "win", "diffs")


def suite_digests(key: str, out: dict) -> dict:
    """The digests of :func:`run_suite`'s ``out``: a gap-closing case's
    FASTA records, AGP and BED rows (sha256 of their JSON) and gaps
    closed, with the skip set a validation pass returned; the bubbles
    case's :func:`result_digests` and its pile-ups without bubble
    resolution; a consensus case's result fields (realign rounds'
    fields), each result's by index, with the ranks and template indices
    it computed."""
    import json

    if "result" in out:
        r = out["result"]
        d = {"output": hashlib.sha256(json.dumps(
                 [r.records, r.agp_rows, r.bed_rows]).encode()).hexdigest(),
             "closed": int(r.n_closed_gaps)}
        if "skip" in out:
            d["skip"] = sorted([int(a), int(b)] for a, b in out["skip"])
        return d
    if "pile_ups" in out:
        d = result_digests(out["las"], out["chains"], out["pile_ups"],
                           out["insertions"])
        d["pile-ups without bubbles"] = result_digests(
            pile_ups=out["plain"])["pile-ups"]
        return d
    if "rounds" in out:
        arrays = {f"{i}.{f}": getattr(r, f) for i, r in enumerate(out["rounds"])
                  for f in ROUND_FIELDS}
        return {"rounds": arrays_sha256(arrays)}
    arrays = {f"{i}.{f}": getattr(r, f) for i, r in enumerate(out["results"])
              for f in CONSENSUS_FIELDS}
    d = {"results": arrays_sha256(arrays)}
    if "ranked" in out:
        d["ranked"] = [int(x) for x in out["ranked"]]
    for name in ("med", "next"):
        if name in out:
            d[name] = int(out[name])
    return d
