"""Profile the port's process (consensus) stage at the reference
example's scale.

    python scripts/profile_e2e_process_torch.py [--fresh] [--trials N]
        [--device cuda|cpu] [--cache PATH] [--mb MB --gaps N]

The port of ``scripts/profile_e2e_process.py``.  It builds phase C's
collect inputs (``scenarios.phase_c_scenario``: 28 Mb, 147 gaps, 20x
reads; ``--mb``/``--gaps`` for other sizes of the same model): the
reads mapped with ``map_reads``, a coverage repeat mask and
``collect_pile_ups``, and caches them in a pickle (``--cache``, by
default ``dentist-torch-profile-e2e-<mb>mb-<gaps>.pkl`` in the temporary
directory; ``--fresh`` rebuilds it).  A cache is read only if it carries
this script's format tag and names no class outside the port (a pickle
of the JAX package's ``dentist_tpu`` classes is refused).  Then it runs
``process_pile_ups`` over the pile-ups ``--trials`` times (default 3) on
``--device`` (the card unless ``cpu`` is asked for), with the kernels
built (timed apart) beforehand:

- every trial counts the calls and host seconds of the consensus entry
  points, patched in ``dentist_tpu_torch.ops.consensus``, the namespace
  that calls them: the K2p, K2r and K3p wrappers (``nw_round_packed``,
  ``nw_round_resident``, ``nw_dist_pairs_packed``; a wrapper returns
  once its launch is queued, so its seconds are the enqueue, not the
  kernel) and ``_run_round``, ``_run_round_full``,
  ``_run_round_windowed``, ``_window_gains_multi`` and
  ``_polish_batch`` (host seconds, waits on the card included);
- on the card, the second-to-last trial runs under ``torch.profiler``
  (CUDA activity only) for the card's busy share of the stage;
- the last trial runs under a
  :class:`~dentist_tpu_torch.utils.stacks.StackSampler`, which charges
  host time to functions and threads, the pools' workers included.

Diagnostics go to stderr; the last line of stdout is one JSON object:
the card's ``nvidia-smi`` name and power limit, the build and input
seconds, each trial's wall, insertions, kernel launches and entry-point
counts, the busy share, the host table, peak host RSS and peak device
memory.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contextlib  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import pickle  # noqa: E402
import resource  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

#: the cache's format tag
FORMAT = "dentist_tpu_torch/profile_e2e_process/1"
#: consensus kernel wrappers: their seconds are the enqueue
DISPATCHES = {"nw_round_packed": "K2p enqueue", "nw_round_resident": "K2r enqueue",
              "nw_dist_pairs_packed": "K3p enqueue"}
#: consensus host functions: their seconds include waits on the card
TOTALS = ("_run_round", "_run_round_full", "_run_round_windowed",
          "_window_gains_multi", "_polish_batch")


class _PortUnpickler(pickle.Unpickler):
    """Refuses a class of the JAX package or of JAX itself."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("jax", "jaxlib", "dentist_tpu"):
            raise pickle.UnpicklingError(
                f"{module}.{name} is not a class of dentist_tpu_torch")
        return super().find_class(module, name)


def load_cache(path: str, mb: float, n_gaps: int) -> dict:
    """The inputs cached at ``path`` for phase C at ``mb`` Mb and
    ``n_gaps`` gaps; raises ``ValueError`` for another format or size."""
    with open(path, "rb") as fh:
        blob = _PortUnpickler(fh).load()
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a cache of this script ({FORMAT})")
    if (blob["mb"], blob["n_gaps"]) != (mb, n_gaps):
        raise ValueError(f"{path}: cached for {blob['mb']} Mb and "
                         f"{blob['n_gaps']} gaps, not {mb} and {n_gaps}")
    return blob["inputs"]


def build_inputs(mb: float, n_gaps: int) -> tuple[dict, dict]:
    """Phase C's collect inputs, and the seconds of each step."""
    from dentist_tpu_torch.models.mask import coverage_mask, pack_chain_intervals
    from dentist_tpu_torch.models.pileups import (ChainCtx, CollectConfig,
                                                  collect_pile_ups)
    from dentist_tpu_torch.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu_torch.ops.mapper import MapperConfig, map_reads
    from dentist_tpu_torch.scenarios import phase_c_scenario

    seconds = {}
    t0 = time.perf_counter()
    sc = phase_c_scenario(mb=mb, n_gaps=n_gaps)
    contigs, structure = split_scaffolds(sc.assembly)
    reads = sc.reads
    seconds["datagen"] = time.perf_counter() - t0
    c, o, l = contigs.codes, contigs.offsets, contigs.lengths
    t0 = time.perf_counter()
    las, chains = map_reads(c, o, l, reads, config=MapperConfig())
    seconds["map"] = time.perf_counter() - t0
    ctx = ChainCtx(las, chains, contigs.lengths, np.array([len(r) for r in reads]))
    store = SeqStore(np.concatenate(reads), np.array([len(r) for r in reads]),
                     [f"read{i + 1}" for i in range(len(reads))])
    repeat_mask = coverage_mask(pack_chain_intervals(las), l, 0, 60)
    t0 = time.perf_counter()
    pile_ups = collect_pile_ups(ctx, structure.gaps, repeat_mask, CollectConfig(),
                                contigs=contigs, reads=store)
    seconds["collect"] = time.perf_counter() - t0
    print(f"inputs: {json.dumps({k: round(v, 1) for k, v in seconds.items()})} s, "
          f"{len(reads)} reads, {len(pile_ups)} pile-ups", file=sys.stderr)
    return dict(ctx=ctx, contigs=contigs, reads_store=store,
                repeat_mask=repeat_mask, pile_ups=pile_ups), seconds


@contextlib.contextmanager
def instrument():
    """Count the calls and host seconds of the consensus entry points
    (:data:`DISPATCHES`, :data:`TOTALS`) by patching them in
    ``dentist_tpu_torch.ops.consensus``; yields {label: [calls,
    seconds]}, and restores the module on exit."""
    import dentist_tpu_torch.ops.consensus as C

    stats, lock = {}, threading.Lock()
    labels = {**DISPATCHES, **{name: name for name in TOTALS}}
    saved = {name: getattr(C, name) for name in labels}

    def wrap(label, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    s = stats.setdefault(label, [0, 0.0])
                    s[0] += 1
                    s[1] += dt
        return wrapped

    for name, label in labels.items():
        setattr(C, name, wrap(label, saved[name]))
    try:
        yield stats
    finally:
        for name, fn in saved.items():
            setattr(C, name, fn)


def main():
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fresh", action="store_true", help="rebuild the cache")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache", help="the cache's path")
    ap.add_argument("--mb", type=float, default=28)
    ap.add_argument("--gaps", type=int, default=147)
    args = ap.parse_args()

    from dentist_tpu_torch import _build
    from dentist_tpu_torch.device import card_line, device_busy, set_device
    from dentist_tpu_torch.dryrun import launch_counts, reset_launch_counts
    from dentist_tpu_torch.models.process import ProcessConfig, process_pile_ups
    from dentist_tpu_torch.utils.stacks import StackSampler, format_report

    dev = set_device(args.device)
    cuda = dev.type == "cuda"
    smi = card_line() if cuda else None
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
    cache = args.cache or os.path.join(
        tempfile.gettempdir(),
        f"dentist-torch-profile-e2e-{args.mb:g}mb-{args.gaps}.pkl")
    t0 = time.perf_counter()
    if args.fresh or not os.path.exists(cache):
        inputs, input_seconds = build_inputs(args.mb, args.gaps)
        with open(cache, "wb") as fh:
            pickle.dump({"format": FORMAT, "mb": args.mb, "n_gaps": args.gaps,
                         "inputs": inputs}, fh, protocol=pickle.HIGHEST_PROTOCOL)
        input_seconds["write"] = time.perf_counter() - t0 - sum(input_seconds.values())
    else:
        inputs = load_cache(cache, args.mb, args.gaps)
        input_seconds = {"load": time.perf_counter() - t0}
        print(f"loaded {cache}: {input_seconds['load']:.1f} s", file=sys.stderr)

    trials, digests, busy, host, sampler = [], set(), None, None, None
    for trial in range(args.trials):
        traced = cuda and args.trials > 1 and trial == args.trials - 2
        sampled = trial == args.trials - 1
        reset_launch_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        if sampled:
            sampler = StackSampler(stages=(("process", ("models/process.py:process_pile_ups",)),))
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as trace, \
                (sampler if sampled else contextlib.nullcontext()), \
                instrument() as stats:
            t0 = time.perf_counter()
            ins = process_pile_ups(inputs["pile_ups"], inputs["ctx"],
                                   inputs["contigs"], inputs["reads_store"],
                                   inputs["repeat_mask"], ProcessConfig())
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        digests.add(hashlib.sha256(pickle.dumps(ins)).hexdigest())
        row = {"wall_s": wall, "insertions": len(ins),
               "launches": {k: v for k, v in launch_counts().items() if v},
               "entry_points": dict(sorted(stats.items(), key=lambda kv: -kv[1][1])),
               "profiler": "torch.profiler" if traced else
                           "stack sampler" if sampled else None,
               "peak_device_gib": (torch.cuda.max_memory_allocated() / 2**30
                                   if cuda else None)}
        trials.append(row)
        print(f"process trial {trial}: {wall:.2f} s, {len(ins)} insertions"
              f"{' (' + row['profiler'] + ')' if row['profiler'] else ''}; "
              f"launches {json.dumps(row['launches'])}", file=sys.stderr)
        for label, (n, s) in row["entry_points"].items():
            print(f"  {label}: {n} calls, {s:.3f} s", file=sys.stderr)
        if traced:
            busy_ms, by_name = device_busy(trace)
            busy = {"trial": trial, "ms": busy_ms, "share": busy_ms / 1e3 / wall,
                    "by_name": {k[:80]: v for k, v in list(by_name.items())[:12]}}
            print(f"  device busy {busy_ms:.1f} ms of {wall:.2f} s "
                  f"({100 * busy['share']:.2f} %)", file=sys.stderr)
        if sampled:
            host = sampler.report(10)
            print(format_report(host, sampler.interval), file=sys.stderr)

    print(json.dumps({
        "script": "profile_e2e_process_torch",
        "scenario": {"mb": args.mb, "n_gaps": args.gaps,
                     "n_pile_ups": len(inputs["pile_ups"])},
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "nvidia_smi": smi,
        "build_seconds": build_s,
        "input_seconds": input_seconds,
        "trials": trials,
        "insertions_equal_across_trials": len(digests) == 1,
        "busy": busy,
        "sampler_interval_ms": sampler.interval * 1e3,
        "samples": sampler.samples if sampler else 0,
        "host": host,
        "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }))


if __name__ == "__main__":
    main()
