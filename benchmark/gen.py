"""Seeded gap-closing inputs: a genome, a gapped assembly and long reads.

A frozen copy of the port's generator, so that later changes to the port
cannot move the yardstick: ``dentist_tpu_torch/sim/genome.py``
(``random_genome``, ``insert_repeats``), ``sim/partial.py``
(``random_gaps``, ``build_partial_assembly``), ``sim/reads.py``
(``_mutate``, ``simulate_reads``), ``io/fasta.py`` (``write_fasta``,
``reverse_complement``) and the composition of
``scenarios.phase_c_scenario`` (genome, repeats, gaps, then reads from
the true genome), all as of commit 6dfa3e3.  Given phase C's seeds it
writes the bytes ``scenarios.write_scenario`` writes
(``benchmark/tests/test_bench_gen.py``).  The FASTA writer is
vectorised; its bytes are ``write_fasta``'s.

Run as a script it writes one unit of work into a directory, so that the
generator's CPU time and memory stay out of the measured process::

    python benchmark/gen.py OUT_DIR PARAMS_JSON SEED UNIT

``PARAMS_JSON`` is a configuration merged with a traffic mix (see
``benchmark/README.md``).  The directory receives ``assembly.fasta`` and
``reads.fasta`` (what the program reads), ``truth.npz`` (the true genome,
the gaps and each read's origin: what the reference reads) and
``unit.json`` (sizes).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

CODE_N = 4
_BASES = np.frombuffer(b"acgtn", dtype=np.uint8)
#: FASTA line width of the port's writer (and of DENTIST's default)
LINE_WIDTH = 50


def unit_seeds(seed: int, unit) -> list[int]:
    """Four seeds (genome, repeats, gaps, reads) for one unit of work:
    ``unit`` is a window index or ``"warmup"``.  Any whole ``seed``."""
    key = [2**32 - 1, 0] if unit == "warmup" else [0, int(unit)]
    ss = np.random.SeedSequence([int(seed) % 2**64, *key])
    return [int(s) for s in ss.generate_state(4)]


def random_genome(length: int, seed: int, gc: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p_at = (1.0 - gc) / 2
    p_gc = gc / 2
    return rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at]).astype(np.uint8)


def insert_repeats(genome: np.ndarray, n_copies: int, repeat_length: int,
                   seed: int, divergence: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = genome.copy()
    unit = rng.integers(0, 4, repeat_length).astype(np.uint8)
    for _ in range(n_copies):
        pos = int(rng.integers(0, len(g) - repeat_length))
        copy = unit.copy()
        n_mut = rng.binomial(repeat_length, divergence)
        sites = rng.choice(repeat_length, size=n_mut, replace=False)
        copy[sites] = (copy[sites] + rng.integers(1, 4, n_mut)) % 4
        g[pos : pos + repeat_length] = copy
    return g


def random_gaps(length: int, n_gaps: int, min_size: int, max_size: int,
                margin: int, seed: int) -> np.ndarray:
    """(n, 2) sorted gap intervals on one record of ``length`` bases, at
    least ``margin`` from its ends and from each other."""
    rng = np.random.default_rng(seed)
    placed: list[tuple[int, int]] = []
    attempts = 0
    while len(placed) < n_gaps and attempts < n_gaps * 100:
        attempts += 1
        int(rng.integers(0, 1))  # the record draw of the multi-record form
        if length < 2 * margin + max_size:
            continue
        size = int(rng.integers(min_size, max_size + 1))
        begin = int(rng.integers(margin, length - margin - size))
        end = begin + size
        if any(not (end + margin <= b or e + margin <= begin) for b, e in placed):
            continue
        placed.append((begin, end))
    return np.array(sorted(placed), dtype=np.int64).reshape(-1, 2)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.uint8)
    rev = codes[::-1]
    out = np.empty_like(codes)
    np.subtract(3, rev, out=out)
    if len(out) and codes.max() > 3:
        bad = rev > 3
        out[bad] = rev[bad]
    return out


def _mutate(codes: np.ndarray, rng: np.random.Generator, error: float,
            mix=(0.55, 0.25, 0.20)) -> np.ndarray:
    """CLR-like errors: (insertion, deletion, substitution) shares."""
    n = len(codes)
    if n == 0 or error <= 0:
        return codes
    p_ins, p_del, p_sub = (error * m for m in mix)
    r = rng.random(n)
    is_del = r < p_del
    is_sub = (r >= p_del) & (r < p_del + p_sub)
    is_ins = (r >= p_del + p_sub) & (r < p_del + p_sub + p_ins)
    subs = codes.copy()
    n_sub = int(is_sub.sum())
    subs[is_sub] = (codes[is_sub] + rng.integers(1, 4, n_sub)) % 4
    reps = np.ones(n, dtype=np.int64)
    reps[is_del] = 0
    reps[is_ins] = 2
    out = np.repeat(subs, reps)
    starts = np.cumsum(np.concatenate([[0], reps[:-1]]))
    ins_pos = starts[is_ins]
    out[ins_pos] = rng.integers(0, 4, len(ins_pos)).astype(np.uint8)
    return out


def simulate_reads(source: np.ndarray, coverage: float, mean_length: int,
                   sd_length: int, min_length: int, error: float, seed: int):
    """Reads drawn from one source record: (reads, origins), each origin
    (begin, end, complement) on the source's forward strand."""
    rng = np.random.default_rng(seed)
    target = coverage * len(source)
    reads, origins = [], []
    total = 0
    while total < target:
        rng.choice(1, p=[1.0])  # the record draw of the multi-record form
        L = int(np.clip(rng.normal(mean_length, sd_length), min_length, len(source)))
        begin = int(rng.integers(0, len(source) - L + 1))
        frag = source[begin : begin + L]
        comp = bool(rng.random() < 0.5)
        if comp:
            frag = reverse_complement(frag)
        reads.append(_mutate(frag, rng, error))
        origins.append((begin, begin + L, comp))
        total += L
    return reads, np.array(origins, dtype=np.int64).reshape(-1, 3)


def scenario(p: dict, seeds: list[int]) -> dict:
    """One unit's data from parameters ``p`` and seeds (genome, repeats,
    gaps, reads), composed in ``phase_c_scenario``'s order."""
    s_genome, s_repeats, s_gaps, s_reads = seeds
    mb = float(p["assembly_mb"])
    g = random_genome(int(mb * 1_000_000), seed=s_genome)
    g = insert_repeats(g, n_copies=int(p["repeats_per_mb"] * mb),
                       repeat_length=int(p["repeat_length"]), seed=s_repeats,
                       divergence=float(p["repeat_divergence"]))
    n_gaps = int(round(p["gaps_per_mb"] * mb))
    gaps = random_gaps(len(g), n_gaps, int(p["gap_min"]), int(p["gap_max"]),
                       int(p["gap_margin"]), seed=s_gaps)
    asm = g.copy()
    for b, e in gaps:
        asm[b:e] = CODE_N
    reads, origins = simulate_reads(
        g, coverage=float(p["read_coverage"]), mean_length=int(p["read_mean"]),
        sd_length=int(p["read_sd"]), min_length=int(p["read_min"]),
        error=float(p["read_error"]), seed=s_reads)
    return {"truth": g, "gaps": gaps, "assembly": asm, "reads": reads,
            "origins": origins, "n_gaps_asked": n_gaps}


def fasta_bytes(header: str, codes: np.ndarray) -> bytes:
    """One FASTA record as the port's ``write_fasta`` writes it
    (lower-case bases, ``LINE_WIDTH`` to a line)."""
    seq = _BASES[np.asarray(codes, dtype=np.uint8)]
    full, rem = divmod(len(seq), LINE_WIDTH)
    rows = np.empty((full, LINE_WIDTH + 1), dtype=np.uint8)
    rows[:, :LINE_WIDTH] = seq[: full * LINE_WIDTH].reshape(full, LINE_WIDTH)
    rows[:, LINE_WIDTH] = ord("\n")
    tail = seq[full * LINE_WIDTH :].tobytes() + (b"\n" if rem else b"")
    return f">{header}\n".encode() + rows.tobytes() + tail


def _settle(fh) -> None:
    """Write a file's pages to disk now, while the measuring clock is
    paused, so that their write-back does not land in a timed pipeline."""
    fh.flush()
    os.fsync(fh.fileno())


def write_unit(directory: str, p: dict, seeds: list[int]) -> dict:
    """Write one unit's inputs and truth into ``directory``; returns its
    sizes (also written to ``unit.json``)."""
    os.makedirs(directory, exist_ok=True)
    sc = scenario(p, seeds)
    with open(os.path.join(directory, "assembly.fasta"), "wb") as fh:
        fh.write(fasta_bytes("scaf0", sc["assembly"]))
        _settle(fh)
    with open(os.path.join(directory, "reads.fasta"), "wb") as fh:
        for i, r in enumerate(sc["reads"]):
            fh.write(fasta_bytes(f"read{i + 1}", r))
        _settle(fh)
    np.savez(os.path.join(directory, "truth.npz"), truth=sc["truth"],
             gaps=sc["gaps"], origins=sc["origins"],
             read_lengths=np.array([len(r) for r in sc["reads"]], np.int64))
    info = {"seeds": seeds, "assembly_bases": int(len(sc["assembly"])),
            "n_gaps": int(len(sc["gaps"])), "n_gaps_asked": sc["n_gaps_asked"],
            "n_reads": len(sc["reads"]),
            "read_chars": int(sum(len(r) for r in sc["reads"]))}
    with open(os.path.join(directory, "unit.json"), "w") as fh:
        json.dump(info, fh)
    return info


def main(argv: list[str]) -> int:
    if len(argv) != 4:
        print(__doc__, file=sys.stderr)
        return 2
    out, params, seed, unit = argv
    write_unit(out, json.loads(params), unit_seeds(int(seed), unit))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
