"""The default consensus transport on a data-parallel group.

Two gloo ranks on the CPU (``dentist_tpu_torch.dryrun`` workers, one
thread each) run ``consensus_batch`` with ``DENTIST_TPU_DENSE_CONS``
unset: every full and windowed round splits its lanes over the ranks and
gathers the sparse result blocks, and the lanes that overflow the sparse
caps are fetched again as dense blocks, gathered too.  The windows stay
host-built under a group (the store-resident windows are single-rank).
Every rank must return what one process returns on the same read sets
with the store-resident windows.
"""

import numpy as np

from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.dryrun import run_ranks
from dentist_tpu_torch.ops.consensus import consensus_batch
from dentist_tpu_torch.sim.reads import _mutate
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_two_rank_sparse_consensus_equals_one_device(monkeypatch):
    set_device("cpu")
    monkeypatch.delenv("DENTIST_TPU_DENSE_CONS", raising=False)
    rng = np.random.default_rng(23)
    sets = []
    for t_len, n_reads, err in ((700, 9, 0.12), (420, 7, 0.25),
                                (980, 11, 0.12)):
        truth = np.asarray(rng.integers(0, 4, t_len), dtype=np.uint8)
        sets.append([_mutate(truth, rng, err) for _ in range(n_reads)])
    single = consensus_batch(sets)
    outs = run_ranks(consensus_batch, (sets,), n=2, devices=["cpu"] * 2,
                     backend="gloo", threads=1)
    assert sorted(o["rank"] for o in outs) == [0, 1]
    for o in outs:
        for k, (a, b) in enumerate(zip(o["result"], single)):
            for f in ("sequence", "win_diffs", "read_diffs", "read_spans",
                      "coverage"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f"rank {o['rank']} {k} {f}")
