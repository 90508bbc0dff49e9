"""The store-resident consensus transport against the JAX package.

- K2r + K4w (``nw_round_resident`` then ``window_pack``, resident) on a
  store against ``_nw_window_round_resident`` (sparse rows) and
  ``_nw_window_round_resident_dense`` on a ``jnp`` arena of the same
  bytes.
- K5 and :class:`DeviceStore`: ``store_write`` against
  ``_arena_write_chunk``, one ``store_write`` call per upload, and the
  whole store's bytes against the JAX ``_Arena``'s after the same
  uploads, a reset included.
- ``consensus_batch`` in the default configuration (store-resident
  windows, sparse blocks) == with ``DENTIST_TPU_DENSE_CONS=1`` == the JAX
  package's, on the seven read sets of ``tests/test_sparse_transport.py``
  (seed 7; one with a high error rate that overflows the sparse caps).

The port runs on the CPU, where every wrapper takes its plain PyTorch
version; the tests hold those bit for bit against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dentist_tpu.ops.banded as B
from dentist_tpu.ops import consensus as C
from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.ops import banded as TB
from dentist_tpu_torch.ops import nw_round as K2
from dentist_tpu_torch.ops import round_pack as RP
from dentist_tpu_torch.sim.reads import _mutate
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 128


def _resident_lanes(seed, err, N=32, L=1 << 16):
    """A store of L random codes with N lanes planted in it: a template
    window (t_len ≤ 192) and a mutated read segment (≤ 384) each, some
    starting in the last 192 / 384 bytes of the store (clamped starts),
    one whose segment is too long for its template (center steps above 2
    that the schedule clips), and ``loc0`` offsets in [0, 33]."""
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 4, L).astype(np.uint8)
    meta = np.zeros((5, N), np.int32)
    pos = 1000
    for n in range(N):
        tl = C._WS if n % 3 else int(rng.integers(130, C._WS + 1))
        t = store[pos : pos + tl].copy()
        r = _mutate(t, rng, 0.5 if err == 0.25 and n % 4 == 1 else err)
        r = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 9))), r])
        r = r[: C._SEG].astype(np.uint8)
        seg_start = pos + 600
        store[seg_start : seg_start + len(r)] = r
        meta[:, n] = (tl, len(r), min(33, tl - 126) if n % 2 else 0, pos,
                      seg_start)
        pos += 1200
    meta[3, -1] = L - 100  # a template start the store clamps
    meta[4, -2] = L - 200  # a segment start the store clamps
    meta[:2, -3] = (130, C._SEG)  # over-slope: center steps above 2 clip
    return store, meta


@pytest.mark.parametrize("err", [0.13, 0.25])
def test_resident_rows_equal_jax(err):
    store, meta = _resident_lanes(int(100 * err), err)
    N = meta.shape[1]
    st, mt = torch.from_numpy(store), torch.from_numpy(meta)
    cen = torch.empty((N, C._WS + 1), dtype=torch.int32)
    launches = K2.resident_launches
    fields = K2.nw_round_resident(st, mt, T=C._WS, RL=C._SEG, W=W,
                                  S=C._WS + C._SEG, NWIN=2,
                                  lead_free=2 * C._LEAD_SLACK, centers_out=cen)
    assert K2.resident_launches == launches, "a CPU tensor must not launch"
    assert fields[6].numpy()[:-3].all()
    arena = jnp.asarray(store)
    for sparse, jax_fn in ((True, C._nw_window_round_resident),
                           (False, C._nw_window_round_resident_dense)):
        ref = np.asarray(jax_fn(arena, jnp.asarray(meta), W=W))
        got = RP.window_pack(st, mt, fields[:3], cen, sparse,
                             resident=True).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"sparse={sparse}")
        if sparse:
            # the over-slope lane and the two clamped lanes read
            # unrelated bytes: leave them out
            ovf = ref.view(np.uint8).reshape(N, -1)[:-3, 166]
            assert bool(ovf.any()) == (err == 0.25)


def test_resident_inputs_equal_jax():
    """K2r's plain inputs are JAX's ``_window_resident_inputs``."""
    store, meta = _resident_lanes(5, 0.13, N=8)
    ref = C._window_resident_inputs(jnp.asarray(store), jnp.asarray(meta))
    got = K2.window_resident_inputs(torch.from_numpy(store),
                                    torch.from_numpy(meta), C._WS, C._SEG)
    for name, r, g in zip(("tpl", "reads", "t_lens", "seg_lens", "centers",
                           "loc0"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(
            g.numpy().dtype), err_msg=name)


def test_store_write_equals_jax_chunk():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, TB._ARENA_CHUNK // 4).astype(np.uint8)
    L = 3 * TB._ARENA_CHUNK
    off = TB._ARENA_CHUNK + 4096
    ref = np.asarray(B._arena_write_chunk(jnp.zeros(L, jnp.uint8),
                                          jnp.asarray(packed), jnp.int32(off)))
    store = torch.zeros(L, dtype=torch.uint8)
    launches = TB.store_write_launches
    TB.store_write(torch.from_numpy(packed), store, off)
    assert TB.store_write_launches == launches
    np.testing.assert_array_equal(store.numpy(), ref)


def test_device_store_bytes_equal_jax_arena(monkeypatch):
    """Same uploads into a 24 MiB port store and a 24 MiB JAX arena: the
    same offsets, the same epoch (one reset) and the same bytes over the
    whole store."""
    monkeypatch.setenv("DENTIST_TPU_ARENA_MB", "24")
    rng = np.random.default_rng(9)
    sizes = [1000, 70_001, 3_000_000, 5_000_003, 9_000_000, 123]
    uploads = [rng.integers(0, 4, n).astype(np.uint8) for n in sizes]
    arena = B._Arena()
    store = TB.DeviceStore(torch.device("cpu"))
    assert store.capacity == B._arena_capacity() == 24 << 20
    for codes in uploads:
        assert store.offset_of(codes) == arena.offset_of(codes)
        assert (store.pos, store.epoch) == (arena.pos, arena.epoch)
        np.testing.assert_array_equal(store.array.numpy(),
                                      np.asarray(arena.array))
    assert store.epoch == 1, "the uploads must reset the store once"
    assert store.offset_of(uploads[-1]) == arena.offset_of(uploads[-1])  # cached
    with pytest.raises(MemoryError):
        store.offset_of(np.zeros(30 << 20, np.uint8))



def test_device_store_one_write_per_upload_whole_store_equal(monkeypatch):
    """One K5 call per upload, of the upload's own characters, and the
    whole store, [0, capacity), equal to the JAX arena's after every
    upload: uploads of 123 characters to more than one 4 Mi-char chunk
    (the arena writes each upload's last chunk whole, its zero tail
    reaching into the next regions; the port writes no tail), a reset,
    an upload again after the reset and a cached re-upload."""
    monkeypatch.setenv("DENTIST_TPU_ARENA_MB", "24")
    calls = []
    write = TB.store_write

    def counted(packed, store, off):
        calls.append((off, 4 * packed.numel()))
        write(packed, store, off)

    monkeypatch.setattr(TB, "store_write", counted)
    rng = np.random.default_rng(12)
    sizes = [123, 70_001, TB._ARENA_CHUNK + 1, 1000, 5_000_003, 13_000_000]
    uploads = [rng.integers(0, 4, n).astype(np.uint8) for n in sizes]
    arena = B._Arena()
    store = TB.DeviceStore(torch.device("cpu"))
    epochs = []
    for codes in [*uploads, uploads[0], uploads[0]]:
        n_calls = len(calls)
        cached = store.keys.get(id(codes), (0, None))[1] is codes
        off = store.offset_of(codes)
        assert off == arena.offset_of(codes)
        assert (store.pos, store.epoch) == (arena.pos, arena.epoch)
        assert calls[n_calls:] == ([] if cached else
                                   [(off, -(-len(codes) // 4) * 4)])
        np.testing.assert_array_equal(store.array.numpy(),
                                      np.asarray(arena.array))
        epochs.append(store.epoch)
    assert epochs == [0, 0, 0, 0, 0, 1, 1, 1], "one reset, at 13 M chars"
    assert len(calls) == 7, "one write per upload, none for the cached one"

def _seven_read_sets():
    rng = np.random.default_rng(7)
    sets = []
    for t_len, n_reads, err in (
        (700, 9, 0.13),
        (420, 7, 0.25),   # high error: exercises cap-overflow refetch
        (980, 11, 0.13),
        (2500, 21, 0.13),
        (150, 3, 0.05),
        (60, 2, 0.30),    # tiny template + extreme error
        (5000, 15, 0.18),
    ):
        truth = np.asarray(rng.integers(0, 4, t_len), dtype=np.uint8)
        sets.append([_mutate(truth, rng, err) for _ in range(n_reads)])
    return sets


def test_consensus_default_equals_dense_equals_jax(monkeypatch):
    from dentist_tpu.ops.consensus import consensus_batch as jax_cons
    from dentist_tpu_torch.ops import consensus as PC

    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")
    monkeypatch.delenv("DENTIST_TPU_DENSE_CONS", raising=False)
    sets = _seven_read_sets()
    calls = {"resident": 0, "sparse": 0, "dense": 0}
    real_round, real_pack = PC.nw_round_resident, PC.round_pack

    def counted_round(*a, **k):
        calls["resident"] += 1
        return real_round(*a, **k)

    def counted_pack(*a, sparse, **k):
        calls["sparse" if sparse else "dense"] += 1
        return real_pack(*a, sparse=sparse, **k)

    monkeypatch.setattr(PC, "nw_round_resident", counted_round)
    monkeypatch.setattr(PC, "round_pack", counted_pack)
    default = PC.consensus_batch(sets)
    assert calls["resident"] and calls["sparse"] and calls["dense"], calls
    ref = jax_cons(sets)
    monkeypatch.setenv("DENTIST_TPU_DENSE_CONS", "1")
    calls.update(resident=0, sparse=0)
    dense = PC.consensus_batch(sets)
    assert calls["resident"] == calls["sparse"] == 0, calls
    for k, (a, b, r) in enumerate(zip(default, dense, ref)):
        for f in ("sequence", "win_diffs", "read_spans", "read_diffs",
                  "coverage"):
            np.testing.assert_array_equal(getattr(a, f), getattr(r, f),
                                          err_msg=f"default {k} {f}")
            np.testing.assert_array_equal(getattr(b, f), getattr(r, f),
                                          err_msg=f"dense {k} {f}")
