"""Micro-bench K2p, the consensus round kernel: forward scan against
scan and traceback.

    python scripts/bench_consensus_kernel_torch.py [--device cuda|cpu]
        [--shapes T,RL,N ...] [--reps R]

The port of ``scripts/bench_consensus_kernel.py``.  At each (T, RL, N)
shape (by default the original's four: (2048, 2048, 64), (8192, 8192,
64), (32768, 32768, 8), (32768, 32768, 64)) it builds N lanes of random
2-bit template and read codes, read_len = min(RL, T), band centers
stepping by one from 0, W = 128 and NWIN = ``TB_nwin(T)``, and launches
``nw_round_packed`` (``ops/nw_round.py``) on ``--device`` (the card
unless ``cpu`` is asked for) with the full traceback budget S = T + RL
and with S = 0, the forward scan alone.  On the card each is timed warm
with CUDA events over ``--reps`` launches (device time), after a first
call timed by the host clock; the kernels are built first and the build
is reported apart.  Up to T = 8192 the full launch is also held against
its plain PyTorch version (``nw_round_packed_reference``) on the same
inputs, tolerance 0.  A shape the wrapper or the card refuses is
recorded with its error.  On the CPU the plain version runs and the
host clock times it.  Diagnostics go to stderr; the last line of stdout
is one JSON object with the card's ``nvidia-smi`` name and power limit
and a row per shape.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

SHAPES = ((2048, 2048, 64), (8192, 8192, 64), (32768, 32768, 8),
          (32768, 32768, 64))
W = 128
#: the largest template the plain version is run at for the check
CHECK_T = 8192


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shapes", nargs="+", metavar="T,RL,N",
                    help="the (T, RL, N) shapes (default: the original's four)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from dentist_tpu_torch import _build
    from dentist_tpu_torch.device import card_line, set_device
    from dentist_tpu_torch.errors import KernelError
    from dentist_tpu_torch.ops.nw_round import (nw_round_packed,
                                                nw_round_packed_reference)
    from dentist_tpu_torch.ops.pack2 import pack2bit
    from dentist_tpu_torch.ops.round_pack import TB_nwin

    dev = set_device(args.device)
    cuda = dev.type == "cuda"
    shapes = ([tuple(int(x) for x in s.split(",")) for s in args.shapes]
              if args.shapes else SHAPES)
    smi = card_line() if cuda else None
    build_s = None
    if cuda:
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def device_ms(fn, reps):
        if not cuda:  # the host clock: the CPU has no device time
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    rng = np.random.default_rng(0)
    rows = []
    for T, RL, N in shapes:
        row = {"T": T, "RL": RL, "N": N, "W": W, "NWIN": max(TB_nwin(T), 1)}
        tpl = rng.integers(0, 4, size=(N, T), dtype=np.uint8)
        reads = rng.integers(0, 4, size=(N, RL), dtype=np.uint8)
        steps = np.ones((N, T), dtype=np.uint8)
        meta = np.stack([np.full(N, T), np.full(N, min(RL, T)),
                         np.zeros(N)]).astype(np.int32)
        chars = torch.from_numpy(np.concatenate(
            [pack2bit(tpl), pack2bit(reads), pack2bit(steps)], axis=1)).to(dev)
        meta = torch.from_numpy(meta).to(dev)
        kw = dict(T=T, RL=RL, W=W, NWIN=row["NWIN"])
        try:
            t0 = time.perf_counter()
            out = nw_round_packed(chars, meta, S=T + RL, **kw)
            sync()
            row["first_call_ms"] = (time.perf_counter() - t0) * 1e3
            for name, S in (("full_ms", T + RL), ("scan_ms", 0)):
                nw_round_packed(chars, meta, S=S, **kw)  # warm
                row[name] = device_ms(
                    lambda S=S: nw_round_packed(chars, meta, S=S, **kw), args.reps)
            row["traceback_ms"] = row["full_ms"] - row["scan_ms"]
            row["timer"] = "CUDA events" if cuda else "host clock"
            if cuda and T <= CHECK_T:
                ref = nw_round_packed_reference(chars, meta, S=T + RL, **kw)
                row["max_abs_err"] = max(int((a.long() - b.long()).abs().max())
                                         for a, b in zip(out, ref))
        except (KernelError, RuntimeError) as exc:
            row["refused"] = f"{type(exc).__name__}: {exc}"[:400]
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps({"script": "bench_consensus_kernel_torch",
                      "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "nvidia_smi": smi, "build_seconds": build_s,
                      "reps": args.reps, "shapes": rows}))


if __name__ == "__main__":
    main()
