"""Multi-rank runs of the port: a spawner, its worker, and a dry run.

Port of ``__graft_entry__.dryrun_multichip``.  :func:`run_ranks` starts
one worker process per rank, joined in a ``torch.distributed`` group
through the variables :func:`~dentist_tpu_torch.parallel.dp.init_distributed`
reads, runs one call in every rank and returns every rank's result and
kernel launch counts.  The worker is this module's ``__main__``::

    python -m dentist_tpu_torch.dryrun worker SPEC OUT --device cuda:0 \\
        --backend gloo

with ``DENTIST_TPU_COORDINATOR``, ``DENTIST_TPU_NUM_PROCESSES`` and
``DENTIST_TPU_PROCESS_ID`` set; ``SPEC`` is a pickle of ``(fn, args,
kwargs, pass_group)`` written by :func:`run_ranks` and ``OUT`` the
pickle the worker writes back.  The CPU tests and ``chip_smoke.py`` use
it, and :func:`dryrun_multigpu` checks ``map_reads``, ``consensus_batch``
and ``close_gaps`` sharded over ``n`` cards against one card.
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

__all__ = ["run_ranks", "free_port", "launch_counts", "reset_launch_counts",
           "dryrun_multigpu", "dryrun"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds :func:`run_ranks` waits for every rank's result
RANK_TIMEOUT = 600


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_counts() -> dict:
    """Launches of each kernel mode in this process: K1, K1p, K2, K2p,
    K2r, K3, K3p, K3f, K3b, K4 (sparse) and K4dense, K4w (sparse) and
    K4wdense, K5."""
    from .ops import banded, nw_dist, nw_round, round_pack

    return {"K1": banded.launches, "K1p": banded.packed_launches,
            "K2": nw_round.launches, "K2p": nw_round.packed_launches,
            "K2r": nw_round.resident_launches,
            "K3": nw_dist.launches, "K3p": nw_dist.packed_launches,
            "K3f": nw_dist.full_launches, "K3b": nw_dist.banded_launches,
            "K4": round_pack.sparse_launches,
            "K4dense": round_pack.dense_launches,
            "K4w": round_pack.window_sparse_launches,
            "K4wdense": round_pack.window_dense_launches,
            "K5": banded.store_write_launches}


def reset_launch_counts() -> None:
    """Set every kernel mode's launch count to 0."""
    from .ops import banded, nw_dist, nw_round, round_pack

    for mod, names in ((banded, ("launches", "packed_launches",
                                 "store_write_launches")),
                       (nw_round, ("launches", "packed_launches",
                                   "resident_launches")),
                       (nw_dist, ("launches", "packed_launches",
                                  "full_launches", "banded_launches")),
                       (round_pack, ("sparse_launches", "dense_launches",
                                     "window_sparse_launches",
                                     "window_dense_launches"))):
        for name in names:
            setattr(mod, name, 0)


def run_ranks(fn, args=(), kwargs=None, *, n: int, devices, backend: str,
              pass_group: bool = True, threads: int = 1) -> list[dict]:
    """Run ``fn(*args, **kwargs)`` in ``n`` ranks of a new process group.

    ``devices[r]`` is rank r's device (``"cpu"``, ``"cuda:0"``, ...);
    ``backend`` the group's (``"gloo"`` or ``"nccl"``).  With
    ``pass_group`` the call gets ``group=`` the rank's
    :class:`~dentist_tpu_torch.parallel.dp.DPGroup`; otherwise ``fn``
    finds the group itself (``default_group()``, as ``close_gaps``
    does).  ``threads`` caps each rank's PyTorch and BLAS threads.
    Returns one ``{"rank", "result", "launches"}`` dict per rank; raises
    if any rank fails or outlives :data:`RANK_TIMEOUT` (all are stopped).
    """
    with tempfile.TemporaryDirectory(prefix="dentist_ranks_") as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as fh:
            pickle.dump((fn, tuple(args), dict(kwargs or {}), pass_group), fh)
        env = dict(os.environ,
                   DENTIST_TPU_COORDINATOR=f"localhost:{free_port()}",
                   DENTIST_TPU_NUM_PROCESSES=str(n),
                   OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=os.pathsep.join(
                       [_ROOT, *filter(None, [os.environ.get("PYTHONPATH")])]))
        # the workers exist to run sharded
        env.pop("DENTIST_TPU_FORCE_SINGLE", None)
        procs, outs, logs = [], [], []
        for r in range(n):
            outs.append(os.path.join(tmp, f"out{r}.pkl"))
            logs.append(open(os.path.join(tmp, f"log{r}.txt"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dentist_tpu_torch.dryrun", "worker",
                 spec, outs[r], "--device", str(devices[r]), "--backend",
                 backend, "--threads", str(threads)],
                env=dict(env, DENTIST_TPU_PROCESS_ID=str(r)), cwd=_ROOT,
                stdout=logs[r], stderr=subprocess.STDOUT))
        error = None
        try:
            # a rank that fails leaves its peers blocked in a collective:
            # watch all of them and stop the rest at the first failure
            deadline = time.monotonic() + RANK_TIMEOUT
            while error is None and any(p.poll() is None for p in procs):
                for r, p in enumerate(procs):
                    if p.poll() not in (None, 0):
                        logs[r].seek(0)
                        error = (f"rank {r} exited {p.returncode}:\n"
                                 f"{logs[r].read()[-3000:]}")
                        break
                else:
                    if time.monotonic() > deadline:
                        error = f"no result within {RANK_TIMEOUT} s"
                    time.sleep(0.05)
            for r, p in enumerate(procs):
                if error is None and p.returncode != 0:
                    logs[r].seek(0)
                    error = (f"rank {r} exited {p.returncode}:\n"
                             f"{logs[r].read()[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for fh in logs:
                fh.close()
        if error:
            raise RuntimeError(error)
        results = []
        for path in outs:
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _worker(spec: str, out: str, device: str, backend: str,
            threads: int) -> None:
    import torch
    import torch.distributed as dist

    from .device import set_device
    from .parallel.dp import DPGroup, init_distributed

    torch.set_num_threads(threads)
    set_device(device)
    if not init_distributed(backend=backend):
        raise RuntimeError("the worker needs DENTIST_TPU_COORDINATOR, "
                           "DENTIST_TPU_NUM_PROCESSES and DENTIST_TPU_PROCESS_ID")
    group = DPGroup.world()
    with open(spec, "rb") as fh:
        fn, args, kwargs, pass_group = pickle.load(fh)
    if pass_group:
        kwargs = dict(kwargs, group=group)
    result = fn(*args, **kwargs)
    if isinstance(result, torch.Tensor):
        result = result.cpu().numpy()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    with open(out, "wb") as fh:
        pickle.dump({"rank": group.rank, "result": result,
                     "launches": launch_counts()}, fh)
    dist.destroy_process_group()


def _e2e_inputs():
    """The 60 kb scenario (``scenarios.e2e_scenario``) as ``close_gaps``
    inputs, and three consensus pile-ups (the JAX dry run's)."""
    from .models.sequences import SeqStore, split_scaffolds
    from .sim.reads import _mutate

    from .scenarios import e2e_scenario

    sc = e2e_scenario()
    contigs, structure = split_scaffolds(sc.assembly)
    reads = SeqStore(np.concatenate(sc.reads),
                     np.array([len(r) for r in sc.reads]),
                     [f"read{i + 1}" for i in range(len(sc.reads))])
    rng = np.random.default_rng(11)
    sets = []
    for t_len, n_reads in ((700, 9), (420, 7), (980, 11)):
        truth = np.asarray(rng.integers(0, 4, t_len), dtype=np.uint8)
        sets.append([_mutate(truth, rng, 0.12) for _ in range(n_reads)])
    return contigs, structure, reads, list(sc.reads), sets


def dryrun_multigpu(n: int) -> None:
    """``map_reads``, ``consensus_batch`` and ``close_gaps`` on the 60 kb
    scenario, sharded over ``n`` cards (one NCCL rank each) and on one
    card in this process; raises unless they are equal."""
    import torch

    from .device import set_device

    if torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multigpu({n}) needs {n} cards, "
                           f"found {torch.cuda.device_count()}")
    set_device("cuda:0")
    dryrun([f"cuda:{r}" for r in range(n)], "nccl", threads=4)


def dryrun(devices, backend: str, threads: int) -> None:
    """The checks of :func:`dryrun_multigpu`, sharded over one rank per
    entry of ``devices`` in a ``backend`` group, against this process
    on its chosen device (``["cpu"] * 4`` with gloo rehearses the
    multi-card run on the CPU)."""
    from .ops.consensus import consensus_batch
    from .ops.mapper import MapperConfig, map_reads
    from .pipeline import PipelineConfig, close_gaps

    contigs, structure, reads, read_list, sets = _e2e_inputs()
    map_args = (contigs.codes, contigs.offsets, contigs.lengths, read_list)
    cases = [
        (map_reads, map_args, {"config": MapperConfig()}, True),
        (consensus_batch, (sets,), {}, True),
        (close_gaps, (contigs, structure, reads, read_list,
                      PipelineConfig(read_coverage=20.0)), {}, False),
    ]
    for fn, args, kwargs, pass_group in cases:
        t0 = time.perf_counter()
        single = fn(*args, **kwargs)
        t1 = time.perf_counter()
        outs = run_ranks(fn, args, kwargs, n=len(devices), devices=devices,
                         backend=backend, pass_group=pass_group,
                         threads=threads)
        for out in outs:
            _assert_equal(out["result"], single,
                          f"{fn.__name__} rank {out['rank']}")
        print(f"{fn.__name__}: {len(devices)} {backend} ranks == one process "
              f"({t1 - t0:.1f} s single, {time.perf_counter() - t1:.1f} s "
              f"sharded); launches by rank "
              f"{[out['launches'] for out in outs]}", flush=True)


def _assert_equal(a, b, what: str) -> None:
    """Deep equality of results made of tuples, lists, dataclasses and
    numpy arrays."""
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} items != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{what}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _assert_equal(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(a, np.ndarray):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: arrays differ")
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dentist_tpu_torch.dryrun")
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker", help="one rank of run_ranks")
    w.add_argument("spec")
    w.add_argument("out")
    w.add_argument("--device", required=True)
    w.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    w.add_argument("--threads", type=int, default=1)
    d = sub.add_parser("multigpu", help="dryrun_multigpu over N cards")
    d.add_argument("n", type=int)
    a = ap.parse_args(argv)
    if a.cmd == "worker":
        _worker(a.spec, a.out, a.device, a.backend, a.threads)
    else:
        dryrun_multigpu(a.n)
        print(f"dryrun_multigpu({a.n}): sharded == single card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
