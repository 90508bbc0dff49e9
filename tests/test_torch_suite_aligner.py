"""The JAX package's tests of its aligner and of the eight-array
extension dispatch, on the port.

Counterparts of ``tests/test_aligner.py:53,72,91,102,113,130,141``
(``align_store_pair``: an exact slice, a mutated one, a reverse
complement, a split match, self-alignment that finds a repeat and not
the identity, multi-contig ids, a→b translation),
``tests/test_exact_alignment.py:10`` (exact trace reconstruction) and
``tests/test_parallel.py:82,106,134`` (the packed dispatch equals the
eight-array dispatch, with diagonal bounds, and beside the mesh's).
Each builds the JAX test's scenario with its seeds and sizes from the
port's copies of ``sim/`` and ``io/``, runs the JAX package's function
and the port's (``set_device("cpu")``: the kernels' plain versions,
``DENTIST_TPU_FORCE_SINGLE=1``), asserts their results equal field by
field (tolerance 0: the DPs are integer), then asserts the JAX test's
own property on the port's result.  The eight-array dispatch is the
port's ``extend_batch_multi`` (K1t, the extension DP's table mode), on
the tests' ladder of band schedules and on a table with a random-walk
schedule; its gloo-group form is a case of
``tests/test_torch_parallel.py::test_sharded_k1p_equals_jax_mesh``.
"""

import numpy as np
import pytest

from dentist_tpu.ops import aligner as JA
from dentist_tpu.ops import banded as JB
from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.io.fasta import reverse_complement
from dentist_tpu_torch.models.alignments import TRACE_SPACING, _trace_boundaries
from dentist_tpu_torch.ops import aligner as PA
from dentist_tpu_torch.ops import banded as PB
from dentist_tpu_torch.sim.genome import random_genome
from dentist_tpu_torch.sim.reads import _mutate
from k1t_tables import walk_table
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _single_device_cpu(monkeypatch):
    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")


_FIELDS = ("a_id", "b_id", "complement", "a_begin", "a_end", "b_begin",
           "b_end", "diffs", "trace_offsets", "trace_diffs", "trace_b_adv")
#: ``tests/test_aligner.py``'s ``CFG``
_CFG = dict(band_width=64, min_length=300, batch_size=16)


def _store(seqs):
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])[:-1]
    return np.concatenate(seqs), offsets, lengths


def _align_both(codes, offsets, lengths, queries, cfg=_CFG, **kw):
    """Both packages' ``align_store_pair``: the port's records and JAX's,
    after asserting them equal field by field."""
    las_j = JA.align_store_pair(codes, offsets, lengths, queries,
                                config=JA.AlignerConfig(**cfg), **kw)
    las_p = PA.align_store_pair(codes, offsets, lengths, queries,
                                config=PA.AlignerConfig(**cfg), **kw)
    assert len(las_p) == len(las_j)
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(las_p, f), getattr(las_j, f),
                                      err_msg=f)
    return las_p, las_j


def _exact_slice():  # test_aligner.py:53
    g = random_genome(5000, seed=3)
    las, _ = _align_both(*_store([g]), [g[1000:3000].copy()])
    assert len(las) == 1
    assert not las.complement[0]
    assert abs(int(las.a_begin[0]) - 1000) <= 30
    assert abs(int(las.a_end[0]) - 3000) <= 30
    assert int(las.b_begin[0]) <= 30 and int(las.b_end[0]) >= 1970
    assert las.error_rate(0) < 0.02
    td, tb = las.trace(0)
    assert tb.sum() == las.b_length(0)
    assert len(tb) == len(_trace_boundaries(int(las.a_begin[0]),
                                            int(las.a_end[0]))) - 1


def _mutated_slice():  # test_aligner.py:72
    g = random_genome(8000, seed=4)
    q = _mutate(g[2000:6000], np.random.default_rng(5), 0.13)
    las, _ = _align_both(*_store([g]), [q])
    assert len(las) == 1
    assert abs(int(las.a_begin[0]) - 2000) < 100
    assert abs(int(las.a_end[0]) - 6000) < 100
    assert 0.05 < las.error_rate(0) < 0.25
    las.check_invariants()
    td, tb = las.trace(0)
    assert tb.sum() == las.b_length(0)
    assert td.sum() == las.diffs[0]
    assert tb.max() < 2 * TRACE_SPACING


def _revcomp():  # test_aligner.py:91
    g = random_genome(5000, seed=6)
    las, _ = _align_both(*_store([g]), [reverse_complement(g[1500:3500])])
    assert len(las) == 1
    assert las.complement[0]
    assert abs(int(las.a_begin[0]) - 1500) <= 30
    assert abs(int(las.a_end[0]) - 3500) <= 30


def _split_match():  # test_aligner.py:102
    g = random_genome(20000, seed=7)
    spacer = random_genome(5000, seed=8)
    q = np.concatenate([g[1000:2500], spacer, g[9000:10500]])
    las, _ = _align_both(*_store([g]), [q])
    assert len(las) == 2
    starts = sorted(int(x) for x in las.a_begin)
    assert abs(starts[0] - 1000) < 50 and abs(starts[1] - 9000) < 50


def _self_repeat():  # test_aligner.py:113
    g = random_genome(12000, seed=9).copy()
    g[8000:9200] = _mutate(g[1000:2200], np.random.default_rng(10), 0.05)[:1200]
    las, _ = _align_both(*_store([g]), [g], query_ids=[1], self_alignment=True)
    assert len(las) >= 1
    for i in range(len(las)):
        assert not (las.a_begin[i] < 100 and las.a_end[i] > 11000)
    regions = {(int(las.a_begin[i]) // 1000, int(las.b_begin[i]) // 1000)
               for i in range(len(las))}
    assert any(a in (0, 1) and b in (7, 8) or a in (7, 8) and b in (0, 1)
               for a, b in regions)


def _multi_contig():  # test_aligner.py:130
    g1, g2 = random_genome(4000, seed=11), random_genome(4000, seed=12)
    las, _ = _align_both(*_store([g1, g2]), [g2[500:2500].copy()])
    assert len(las) == 1
    assert int(las.a_id[0]) == 2
    assert abs(int(las.a_begin[0]) - 500) <= 30


def _translate():  # test_aligner.py:141
    g = random_genome(6000, seed=13)
    q = _mutate(g[1000:5000], np.random.default_rng(14), 0.1)
    las, _ = _align_both(*_store([g]), [q])
    assert len(las) == 1
    a_mid = (int(las.a_begin[0]) + int(las.a_end[0])) // 2
    a_at, b_at = las.translate_a_to_b(0, a_mid)
    assert a_at % TRACE_SPACING == 0 or a_at == las.a_begin[0]
    assert abs(b_at - (a_at - 1000)) < 0.06 * 4000 + 50


_ALIGN_CASES = {"exact_slice": _exact_slice, "mutated_slice": _mutated_slice,
                "revcomp": _revcomp, "split_match": _split_match,
                "self_repeat_not_identity": _self_repeat,
                "multi_contig_ids": _multi_contig, "translate_a_to_b": _translate}


@pytest.mark.parametrize("case", list(_ALIGN_CASES))
def test_align_store_pair_equals_jax(case):
    _ALIGN_CASES[case]()


def test_exact_alignment_reconstruction_equals_jax():
    """``tests/test_exact_alignment.py:10``: the records and both
    reconstructions (the whole alignment, and a sub-interval snapped
    outward to trace boundaries) equal JAX's; the ops walk the port's
    alignment consistently."""
    g = random_genome(3000, seed=40)
    q = _mutate(g[500:2500], np.random.default_rng(41), 0.1)
    cfg = dict(min_length=300, batch_size=16)
    las, las_j = _align_both(g, np.array([0]), np.array([3000]), [q], cfg)
    assert len(las) == 1
    a0, b0, ops = las.exact_alignment(0, g, q)
    assert (a0, b0, ops) == las_j.exact_alignment(0, g, q)
    a_pos, b_pos, n_edits = a0, b0, 0
    for kind, ai, bi in ops:
        if kind in ("match", "sub"):
            assert ai == a_pos and bi == b_pos, (kind, ai, bi, a_pos, b_pos)
            assert (g[ai] == q[bi]) == (kind == "match")
            n_edits += kind == "sub"
            a_pos += 1
            b_pos += 1
        elif kind == "del":
            a_pos += 1
            n_edits += 1
        else:
            b_pos += 1
            n_edits += 1
    assert a_pos == int(las.a_end[0]) and b_pos == int(las.b_end[0])
    assert n_edits <= int(las.diffs[0]) * 1.2 + 5
    mid = (int(las.a_begin[0]) + int(las.a_end[0])) // 2
    sub = las.exact_alignment(0, g, q, a_interval=(mid, mid + 100))
    assert sub == las_j.exact_alignment(0, g, q, a_interval=(mid, mid + 100))
    assert sub[0] <= mid
    assert len(sub[2]) < len(ops)


def _dispatch_lanes(seed: int, N: int, K: int, full: bool):
    """``tests/test_parallel.py``'s lanes: W = 64, R = 252, random A and B
    windows, random lengths (``full``: every row and column), the slopes
    R, 1.05R, 0.95R, R (``full``: R each) and their ladder of offsets."""
    W, R = 64, 252
    rng = np.random.default_rng(seed)
    a_win = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b_win = rng.integers(0, 4, (N, PB.bw_for(R, W))).astype(np.uint8)
    if full:
        a_len = b_len = np.full(N, R, np.int32)
        num_k = np.full(K, R, np.int32)
    else:
        a_len = rng.integers(R // 2, R + 1, N).astype(np.int32)
        b_len = rng.integers(R // 2, int(1.1 * R), N).astype(np.int32)
        num_k = np.array([R, int(1.05 * R), int(0.95 * R), R][:K], np.int32)
    lane_k = (np.arange(N) % K).astype(np.int32)
    return W, R, a_win, b_win, a_len, b_len, num_k, lane_k


#: (seed, N, K, every row and column, diagonal bounds) of
#: ``tests/test_parallel.py:82``, ``:106`` and ``:134``
_DISPATCH_CASES = {"packed_equals_multi": (11, 16, 4, False, False),
                   "diag_bounds": (12, 8, 2, True, True),
                   "on_mesh": (13, 16, 4, False, False)}


@pytest.mark.parametrize("table", ["ladder", "walks"])
@pytest.mark.parametrize("case", list(_DISPATCH_CASES))
def test_eight_array_dispatch_equals_jax(case, table):
    """JAX's ``extend_batch_multi_async`` and the port's
    ``extend_batch_multi`` on the same lanes and table: equal blocks.
    The JAX tests' property on the port: on the ladder its packed
    dispatch (K1p) equals the eight-array one; ``on_mesh`` also holds
    JAX's dispatches over an 8-device mesh, packed and unpacked, equal
    to the port's (the port's group form runs in
    ``tests/test_torch_parallel.py``)."""
    from dentist_tpu.parallel.dp import make_mesh

    seed, N, K, full, bounded = _DISPATCH_CASES[case]
    W, R, a_win, b_win, a_len, b_len, num_k, lane_k = _dispatch_lanes(
        seed, N, K, full)
    offs = (PB.ladder(num_k, R, W) if table == "ladder"
            else walk_table(seed, num_k, R, W, walks=K // 2))
    kw = {"W": W}
    if bounded:  # tandem-style identity exclusion on even lanes
        kw["diag_lo"] = np.full(N, -PB.DIAG_UNBOUNDED, np.int32)
        kw["diag_hi"] = np.full(N, PB.DIAG_UNBOUNDED, np.int32)
        kw["diag_hi"][::2] = 40
    args = (a_win, b_win, a_len, b_len)
    ref = np.asarray(JB.extend_batch_multi_async(*args, offs.astype(np.int32),
                                                 lane_k, **kw))
    launches = PB.table_launches
    got = PB.extend_batch_multi(*args, offs, lane_k, **kw).numpy()
    assert PB.table_launches == launches, "a CPU tensor must not launch K1t"
    assert got.shape == (4 + R // 126, N)
    np.testing.assert_array_equal(got, ref)
    if table == "ladder":
        np.testing.assert_array_equal(
            PB.extend_batch_packed(*args, num_k, lane_k, **kw).numpy(), got)
    if case == "on_mesh":
        mesh = make_mesh(8)
        np.testing.assert_array_equal(np.asarray(JB.extend_batch_multi_async(
            *args, offs.astype(np.int32), lane_k, mesh=mesh, **kw)), got)
        if table == "ladder":
            np.testing.assert_array_equal(np.asarray(
                JB.extend_batch_packed_async(*args, num_k, lane_k, mesh=mesh,
                                             **kw)), got)
