"""K4 and K4w (``dentist_tpu_torch.ops.round_pack``) against the JAX
package's result packings, and the port's host decoders.

Seeded numpy lanes — mutated copies of templates at error rates 0.05,
0.13 and 0.25 (the 0.25 cases add error-dense lanes, every other base
substituted, that overflow the sparse caps), lanes whose read is the template itself (no
events), uncovered lanes (a read far longer than its template) and empty
reads — go 2-bit packed through the JAX kernels
(``jax.jit`` on the CPU backend) and through K2p then K4 / K4w in the
port, whose wrappers run the plain PyTorch versions on CPU tensors.  The
blocks must be equal word for word (tolerance 0), and the port's
decoders must rebuild exactly the dense fields of K2p's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dentist_tpu.ops import consensus as C
from dentist_tpu.sim.reads import _mutate
from dentist_tpu_torch.errors import KernelError
from dentist_tpu_torch.ops import nw_round as K2
from dentist_tpu_torch.ops import round_pack as RP
from dentist_tpu_torch.ops.pack2 import pack2bit

W = 128
ERRORS = (0.05, 0.13, 0.25)


def _read_of(t, rng, err, n):
    """A mutated copy of ``t``; in the 0.25 cases every third lane is
    error-dense instead (every other base substituted): its events
    overflow the sparse caps and take the dense refetch."""
    if err == 0.25 and n % 3 == 0:
        r = t.copy()
        r[::2] = (r[::2] + 1) % 4
        return r
    return _mutate(t, rng, err)


def _full_lanes(seed, T, err, N=10):
    """(lanes, chars, meta): ``lanes`` as the round executor lists them
    (job, read, template, read); chars / meta K2p's packed inputs with
    the first-round slope-1 centers."""
    rng = np.random.default_rng(seed)
    RL = 2 * T
    lanes = []
    for n in range(N):
        L = int(rng.integers(T // 2, T + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        if n == 0:  # the read is the template: covered, no events
            r = t.copy()
        elif n == 1:  # a read far longer than its template: uncovered
            t = t[: L // 4]
            r = rng.integers(0, 4, RL).astype(np.uint8)
        elif n == 2:
            r = np.zeros(0, np.uint8)
        else:
            r = _read_of(t, rng, err, n)[:RL]
        lanes.append((0, n, t, r))
    tpl = np.zeros((N, T), np.uint8)
    reads = np.zeros((N, RL), np.uint8)
    t_lens = np.ones(N, np.int32)
    r_lens = np.zeros(N, np.int32)
    for n, (_, _, t, r) in enumerate(lanes):
        tpl[n, : len(t)] = t
        t_lens[n] = len(t)
        reads[n, : len(r)] = r
        r_lens[n] = len(r)
    centers = C._make_centers(T, r_lens.astype(np.int64), None)
    steps = np.clip(np.diff(centers, axis=0), 0, 2).astype(np.uint8).T
    chars = np.concatenate([pack2bit(tpl), pack2bit(reads), pack2bit(steps)],
                           axis=1)
    meta = np.stack([t_lens, r_lens, centers[0]]).astype(np.int32)
    return lanes, chars, meta, centers


def _port_round(chars, meta, T):
    RL = 2 * T
    N = meta.shape[1]
    chars_t, meta_t = torch.from_numpy(chars), torch.from_numpy(meta)
    cen = torch.empty((N, T + 1), dtype=torch.int32)
    fields = K2.nw_round_packed(chars_t, meta_t, T=T, RL=RL, W=W, S=T + RL,
                                NWIN=C.TB_nwin(T), centers_out=cen)
    return chars_t, fields, cen


@pytest.mark.parametrize("err", ERRORS)
@pytest.mark.parametrize("T", [512, 1024])
def test_full_round_blocks_equal_jax(T, err):
    lanes, chars, meta, _ = _full_lanes(int(T + 100 * err), T, err)
    RL, NWIN = 2 * T, C.TB_nwin(T)
    chars_t, fields, cen = _port_round(chars, meta, T)
    launches = (RP.sparse_launches, RP.dense_launches)
    kw = dict(T=T, RL=RL, W=W, S=T + RL, NWIN=NWIN)
    for sparse, jax_fn in ((True, C._nw_round_packed_sparse),
                           (False, C._nw_round_packed)):
        ref = np.asarray(jax_fn(jnp.asarray(chars), jnp.asarray(meta.reshape(-1)),
                                **kw))
        got = RP.round_pack(chars_t, fields, cen, T, RL, NWIN, sparse).numpy()
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref, err_msg=f"sparse={sparse}")
        if sparse:
            words = RP.sparse_words(T, NWIN)
            assert ref.shape[1] == words
            ovf = ref[:, words - NWIN - 1]
            assert bool(ovf.any()) == (err == 0.25), ovf
    assert (RP.sparse_launches, RP.dense_launches) == launches, \
        "a CPU tensor must not launch the kernel"
    cov = fields[6].numpy()
    assert cov[0] and not cov[1]


def _window_lanes(seed, err, N=24):
    """Host-window lanes as ``_dispatch_windowed_lanes`` builds them:
    192-row template windows (some shorter), segments with up to 8
    leading slack chars, proportional 2-bit center steps, ``loc0``."""
    rng = np.random.default_rng(seed)
    T, RL = C._WS, C._SEG
    tpl = np.zeros((N, T), np.uint8)
    seg = np.zeros((N, RL), np.uint8)
    meta = np.zeros((4, N), np.int32)
    for n in range(N):
        L = T if n % 3 else int(rng.integers(130, T + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        r = t.copy() if n == 0 else _read_of(t, rng, err, n)
        lead = rng.integers(0, 4, int(rng.integers(0, 9))).astype(np.uint8)
        r = np.concatenate([lead, r])[:RL]
        tpl[n, :L] = t
        seg[n, : len(r)] = r
        meta[:, n] = (L, len(r), 0, min(33, L - 126) if n % 4 else 0)
    rows = np.arange(T + 1)
    tl = np.maximum(meta[0, :, None].astype(np.int64), 1)
    cen = (np.minimum(rows[None, :], tl) * meta[1, :, None]) // tl
    steps = np.diff(cen, axis=1).clip(0, 2).astype(np.uint8)
    chars = np.concatenate([pack2bit(tpl), pack2bit(seg), pack2bit(steps)],
                           axis=1)
    return tpl, chars, meta


def _port_window(chars, meta):
    N = meta.shape[1]
    chars_t, meta_t = torch.from_numpy(chars), torch.from_numpy(meta)
    cen = torch.empty((N, C._WS + 1), dtype=torch.int32)
    fields = K2.nw_round_packed(chars_t, meta_t, T=C._WS, RL=C._SEG, W=W,
                                S=C._WS + C._SEG, NWIN=2,
                                lead_free=2 * C._LEAD_SLACK, centers_out=cen)
    return chars_t, meta_t, fields, cen


@pytest.mark.parametrize("err", ERRORS)
def test_window_rows_equal_jax(err):
    _, chars, meta = _window_lanes(int(1000 * err), err)
    chars_t, meta_t, fields, cen = _port_window(chars, meta)
    launches = (RP.window_sparse_launches, RP.window_dense_launches)
    for sparse, jax_fn in ((True, C._nw_window_round_sparse),
                           (False, C._nw_window_round)):
        ref = np.asarray(jax_fn(jnp.asarray(chars), jnp.asarray(meta), W=W))
        got = RP.window_pack(chars_t, meta_t, fields[:3], cen, sparse,
                             resident=False).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"sparse={sparse}")
        if sparse:
            ovf = ref.view(np.uint8).reshape(len(ref), -1)[:, 166]
            assert bool(ovf.any()) == (err == 0.25)
    assert (RP.window_sparse_launches, RP.window_dense_launches) == launches


@pytest.mark.parametrize("err", [0.13, 0.25])
def test_full_round_decoders_rebuild_k2p_fields(err):
    T = 512
    lanes, chars, meta, centers = _full_lanes(7, T, err)
    chars_t, fields, cen = _port_round(chars, meta, T)
    want = [f.numpy() for f in fields]
    chunk = list(range(len(lanes)))
    NWIN = C.TB_nwin(T)
    sparse_outs, dense_outs = {}, {}
    block = RP.round_pack(chars_t, fields, cen, T, 2 * T, NWIN, True).numpy()
    ovf = RP._collect_chunk_sparse(lanes, chunk, T, sparse_outs, fetched=block)
    assert bool(ovf) == (err == 0.25)
    block = RP.round_pack(chars_t, fields, cen, T, 2 * T, NWIN, False).numpy()
    RP._collect_chunk(lanes, chunk, T, dense_outs, fetched=block,
                      centers=centers)
    assert sorted(sparse_outs) == [(0, k) for k in chunk if k not in ovf]
    for outs in (sparse_outs, dense_outs):
        for (_, k), got in outs.items():
            for name, g, w in zip(("sym", "ins", "jpath", "spans", "diffs",
                                   "win", "covered"), got, want):
                np.testing.assert_array_equal(np.asarray(g), w[k],
                                              err_msg=f"{k} {name}")


@pytest.mark.parametrize("err", [0.13, 0.25])
def test_window_decoders_rebuild_k2p_fields(err):
    tpl, chars, meta = _window_lanes(11, err)
    chars_t, meta_t, fields, cen = _port_window(chars, meta)
    loc0 = meta[3].astype(np.int64)[:, None]
    intr = loc0 + np.arange(RP._ADV)[None, :]
    bnd = loc0 + np.arange(RP._ADV + 1)[None, :]
    sym, ins, jpath = (f.numpy() for f in fields[:3])
    want_sym = np.take_along_axis(sym, intr, 1)
    want_ins = np.take_along_axis(ins, bnd[:, :, None], 1)
    want_jp = np.take_along_axis(jpath, bnd, 1)
    rows = RP.window_pack(chars_t, meta_t, fields[:3], cen, True,
                          resident=False).numpy()
    tpl_i = np.take_along_axis(tpl, intr, 1).astype(np.int8)
    s, i, j, ovf = RP._unpack_window_rows_sparse(rows, tpl_i)
    assert bool(ovf.any()) == (err == 0.25)
    ok = ~ovf
    np.testing.assert_array_equal(s[ok], want_sym[ok])
    np.testing.assert_array_equal(i[ok], want_ins[ok])
    np.testing.assert_array_equal(j[ok], want_jp[ok])
    rows = RP.window_pack(chars_t, meta_t, fields[:3], cen, False,
                          resident=False).numpy()
    tl = np.maximum(meta[0, :, None].astype(np.int64), 1)
    cen_b = np.minimum(bnd, tl) * meta[1, :, None] // tl
    s, i, j = RP._unpack_window_rows(rows, cen_b)
    np.testing.assert_array_equal(s, want_sym)
    np.testing.assert_array_equal(i, want_ins)
    np.testing.assert_array_equal(j, want_jp)


def test_round_pack_rejects_bad_arguments():
    T = 512
    _, chars, meta, _ = _full_lanes(3, T, 0.13, N=2)
    chars_t, fields, cen = _port_round(chars, meta, T)
    with pytest.raises(KernelError):  # T not a multiple of 256
        RP.round_pack(chars_t, fields, cen, 320, 2 * T, 3, True)
    with pytest.raises(KernelError):  # centers of the wrong shape
        RP.round_pack(chars_t, fields, cen[:, :-1], T, 2 * T, C.TB_nwin(T), False)
    with pytest.raises(KernelError):  # a resident row needs (5, N) meta
        RP.window_pack(torch.zeros(1 << 16, dtype=torch.uint8),
                       torch.zeros((4, 2), dtype=torch.int32),
                       (torch.zeros((2, 192), dtype=torch.int8),
                        torch.zeros((2, 193, 4), dtype=torch.int8),
                        torch.zeros((2, 193), dtype=torch.int32)),
                       torch.zeros((2, 193), dtype=torch.int32), True,
                       resident=True)
