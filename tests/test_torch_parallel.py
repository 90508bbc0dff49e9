"""The data-parallel path (``dentist_tpu_torch.parallel``) against JAX.

Two- and three-rank gloo groups on the CPU (three is the
non-power-of-two case, as in ``tests/test_consensus.py``: every lane
count pads), each rank a ``dentist_tpu_torch.dryrun`` worker process
limited to one thread, run the port's plain kernel versions on their
lane blocks and gather the results.  Every rank must return what the
JAX package returns single device and on a mesh of the same size: the
sharded K1p dispatch, ``map_reads`` and ``consensus_batch`` (JAX's
mesh consensus with ``DENTIST_TPU_DENSE_CONS=1``, the dense result path
the port gathers), and a two-rank ``close_gaps`` on the cut-down 30 kb
scenario of ``test_torch_slice.py``, held by the sha256 of JAX's output
that ``test_torch_slice.py::test_close_gaps_equals_jax`` checks against
a live JAX run (which takes 40 s here).
"""

import numpy as np
import pytest
import torch
from test_torch_slice import (JAX_CLOSE_GAPS_SHA256, close_gaps_digest,
                              close_gaps_scenario)

from dentist_tpu_torch.dryrun import run_ranks
from dentist_tpu_torch.parallel import dp

_LAS_FIELDS = ("a_id", "b_id", "complement", "a_begin", "a_end", "b_begin",
               "b_end", "diffs", "trace_offsets", "trace_diffs", "trace_b_adv",
               "chain_id")


def _ranks(fn, args, kwargs=None, n=2, **kw):
    return run_ranks(fn, args, kwargs, n=n, devices=["cpu"] * n,
                     backend="gloo", threads=1, **kw)


def test_lane_helpers_without_a_group():
    x = np.arange(12).reshape(3, 4)
    assert dp.pad_lanes(5, None) == 5
    assert dp.local_lanes(x, None, 1) is x
    t = torch.ones(2)
    assert dp.gather_lanes(t, None, 0) is t
    g = dp.DPGroup(rank=1, size=3, backend="gloo")
    assert dp.pad_lanes(7, g) == 9
    np.testing.assert_array_equal(dp.local_lanes(np.arange(9), g, 0), [3, 4, 5])
    with pytest.raises(ValueError):
        dp.local_lanes(np.arange(8), g, 0)
    assert dp.dispatch_workers(4) == 4  # no process group here


def test_gather_lanes_tiles_every_rank_in_order():
    """Each rank gathers its own block along axis 1; bool travels too."""
    x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    for out in _ranks(dp.gather_lanes, (x,), {"axis": 1}, n=3):
        np.testing.assert_array_equal(out["result"],
                                      torch.cat([x, x, x], dim=1).numpy())
    b = torch.tensor([True, False, True])
    for out in _ranks(dp.gather_lanes, (b,), {"axis": 0}):
        assert out["result"].dtype == np.bool_
        np.testing.assert_array_equal(out["result"], [1, 0, 1, 1, 0, 1])


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_k1p_equals_jax_mesh(n):
    from dentist_tpu.ops.banded import extend_batch_packed_async
    from dentist_tpu.parallel.dp import make_mesh
    from dentist_tpu_torch.ops.banded import bw_for, extend_batch_packed

    W, N, R, K = 64, 12, 252, 3
    rng = np.random.default_rng(40 + n)
    a = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b = rng.integers(0, 4, (N, bw_for(R, W))).astype(np.uint8)
    b[::2, W : W + R // 2] = a[::2, : R // 2]
    args = (a, b, rng.integers(R // 2, R + 1, N).astype(np.int32),
            rng.integers(R // 2, int(1.1 * R), N).astype(np.int32),
            np.array([R, int(1.05 * R), int(0.95 * R)], np.int32),
            (np.arange(N) % K).astype(np.int32))
    diag_hi = np.full(N, 1 << 20, np.int32)
    diag_hi[::4] = 40
    kw = {"W": W, "diag_hi": diag_hi}
    single = np.asarray(extend_batch_packed_async(*args, **kw))
    mesh = np.asarray(extend_batch_packed_async(*args, **kw, mesh=make_mesh(n)))
    np.testing.assert_array_equal(mesh, single)
    assert (single[0] > 0).any()
    outs = _ranks(extend_batch_packed, args, kw, n=n)
    assert [o["rank"] for o in outs] == list(range(n))
    for o in outs:
        np.testing.assert_array_equal(o["result"], single)


@pytest.fixture(scope="module")
def map_case():
    import __graft_entry__ as g
    from dentist_tpu.ops.mapper import MapperConfig, map_reads

    contigs, reads = g._simulated_scenario(seed=21)
    args = (contigs.codes, contigs.offsets, contigs.lengths, reads)
    return args, map_reads(*args, config=MapperConfig())


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_map_reads_equals_jax(map_case, n):
    from dentist_tpu.ops.mapper import MapperConfig, map_reads
    from dentist_tpu.parallel.dp import make_mesh
    from dentist_tpu_torch.ops import mapper as port_mapper

    args, (las_1, chains_1) = map_case
    las_m, chains_m = map_reads(*args, config=MapperConfig(), mesh=make_mesh(n))
    cfg = port_mapper.MapperConfig()
    cfg.aligner.seed_threads = 1  # host seeding threads: no effect on records
    outs = _ranks(port_mapper.map_reads, args, {"config": cfg}, n=n)
    assert len(las_1) > 0
    for las_j in (las_1, las_m):
        for o in outs:
            las_p, chains_p = o["result"]
            for f in _LAS_FIELDS:
                np.testing.assert_array_equal(getattr(las_p, f),
                                              getattr(las_j, f), err_msg=f)
    for chains_j in (chains_1, chains_m):
        for o in outs:
            assert [(c.a_id, c.b_id, c.score) for c in o["result"][1]] == \
                [(c.a_id, c.b_id, c.score) for c in chains_j]
    for o in outs:
        assert o["launches"]["K1"] == 0, "a group ships host windows"


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_consensus_equals_jax(monkeypatch, n):
    from dentist_tpu.ops.consensus import consensus_batch as jax_cons
    from dentist_tpu.parallel.dp import make_mesh
    from dentist_tpu.sim.reads import _mutate
    from dentist_tpu_torch.ops.consensus import consensus_batch as port_cons

    rng = np.random.default_rng(11 + n)
    sets = []
    for t_len, n_reads in ((700, 9), (420, 7), (980, 11)):
        truth = np.asarray(rng.integers(0, 4, t_len), dtype=np.uint8)
        sets.append([_mutate(truth, rng, 0.12) for _ in range(n_reads)])
    single = jax_cons(sets)
    monkeypatch.setenv("DENTIST_TPU_DENSE_CONS", "1")
    mesh = jax_cons(sets, mesh=make_mesh(n))
    outs = _ranks(port_cons, (sets,), n=n)
    for ref in (single, mesh):
        for o in outs:
            for k, (a, b) in enumerate(zip(o["result"], ref)):
                for f in ("sequence", "win_diffs", "read_diffs", "read_spans",
                          "coverage"):
                    np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                                  err_msg=f"{k} {f}")


def test_two_rank_close_gaps_equals_jax():
    """The whole pipeline on two ranks: every rank returns the JAX
    package's single-device FASTA, AGP and BED rows."""
    from dentist_tpu_torch import pipeline as port_pipeline

    outs = _ranks(port_pipeline.close_gaps,
                  (*close_gaps_scenario(),
                   port_pipeline.PipelineConfig(read_coverage=20.0)),
                  pass_group=False)
    for o in outs:
        res_p = o["result"]
        assert res_p.n_closed_gaps == 1
        assert close_gaps_digest(res_p) == JAX_CLOSE_GAPS_SHA256
        for mode in ("K1p", "K2p", "K3p"):
            assert o["launches"][mode] == 0, "CPU ranks run the plain versions"


def test_resume_state_rank0_writes_other_ranks_read(tmp_path, monkeypatch):
    """Under a group only rank 0 removes stale artifacts and writes the
    manifest; another rank writes nothing, and on a resumed run it
    follows the artifacts that exist after the barrier."""
    from dentist_tpu.models.sequences import SeqStore
    from dentist_tpu_torch import pipeline as P

    monkeypatch.setattr(P, "barrier", lambda group: None)  # one process here
    store = SeqStore(np.zeros(8, np.uint8), np.array([8]))
    cfg = P.PipelineConfig(read_coverage=20.0, workdir=str(tmp_path))
    (tmp_path / "pile-ups.npz").write_bytes(b"stale")
    rank1 = P._ResumeState(cfg, store, store, None, dp.DPGroup(1, 2, "gloo"))
    assert not rank1.valid
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pile-ups.npz"]
    rank0 = P._ResumeState(cfg, store, store, None, dp.DPGroup(0, 2, "gloo"))
    assert not rank0.valid
    assert sorted(p.name for p in tmp_path.iterdir()) == ["manifest.json"]
    (tmp_path / "insertions.npz").write_bytes(b"from rank 0")
    rank1 = P._ResumeState(cfg, store, store, None, dp.DPGroup(1, 2, "gloo"))
    assert rank1.valid and rank1.present == {"insertions.npz"}
    assert rank1._have("insertions.npz") and not rank1._have("pile-ups.npz")
    rank1.save_validation({(1, 2)})
    assert not (tmp_path / "validation.json").exists()
