"""The 2-bit packed inputs of K1, K2 and K3 (K1p, K2p, K3p) against JAX.

The port's packer must write the JAX package's bytes for every input
(with the native packer and with its numpy shift-or, codes above 3
included), and each packed mode's plain version — unpack, then the
unpacked mode's plain function — must give the JAX packed programs' results bit for bit
on the same seeded numpy inputs: ``extend_batch_packed_async``
(``_extend_scan_v3_packed``), ``_nw_round_packed`` and
``_nw_window_round`` (decoded by the JAX host decoders) and
``_nw_dist_pair_packed``.  Integer DPs: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dentist_tpu.native as native
import dentist_tpu_torch.native as port_native
import dentist_tpu.ops.banded as B
from dentist_tpu.ops import consensus as C
from dentist_tpu.sim.reads import _mutate
from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.errors import KernelError
from dentist_tpu_torch.ops import banded as TB
from dentist_tpu_torch.ops import nw_dist as K3
from dentist_tpu_torch.ops import nw_round as K2
from dentist_tpu_torch.ops.pack2 import pack2bit, unpack2bit


@pytest.fixture(params=["native", "numpy"])
def packer(request, monkeypatch):
    """Run a test with the native packer, then with the numpy one (the
    JAX package and the port each load the library through their own
    ``native`` module)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(port_native, "_load", lambda: None)
    else:
        assert native._load() is not None, "the native library must build"
        assert port_native._load() is not None, "the native library must build"
    return request.param


@pytest.mark.parametrize("hi", [4, 256])
def test_pack2bit_bytes_equal_jax(packer, hi):
    """``hi`` = 4: codes 0..3 only; 256: any byte (N, pad and garbage
    codes above 3 pack as JAX packs them)."""
    rng = np.random.default_rng(hi)
    a = rng.integers(0, hi, (37, 96)).astype(np.uint8)
    a[0, :4] = [4, 7, 255, 3]
    np.testing.assert_array_equal(pack2bit(a), B._pack2bit(a))


def test_pack2bit_rejects_ragged_rows():
    with pytest.raises(ValueError):
        pack2bit(np.zeros((2, 6), np.uint8))


def test_unpack2bit_equals_jax():
    p = np.random.default_rng(1).integers(0, 256, (9, 40)).astype(np.uint8)
    np.testing.assert_array_equal(unpack2bit(torch.from_numpy(p)).numpy(),
                                  np.asarray(B._unpack2bit(jnp.asarray(p))))
    codes = np.random.default_rng(2).integers(0, 4, (5, 64)).astype(np.uint8)
    np.testing.assert_array_equal(
        unpack2bit(torch.from_numpy(pack2bit(codes))).numpy(), codes)


def _k1_lanes(seed, W, N, R, K):
    rng = np.random.default_rng(seed)
    BW = TB.bw_for(R, W)
    a_win = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b_win = rng.integers(0, 4, (N, BW)).astype(np.uint8)
    for n in range(0, N, 2):  # lanes that align
        r = _mutate(a_win[n, : R // 2], rng, 0.1)[: R // 2]
        b_win[n, W : W + len(r)] = r
    a_len = rng.integers(R // 2, R + 1, N).astype(np.int32)
    b_len = rng.integers(R // 2, int(1.1 * R), N).astype(np.int32)
    num_k = np.array([R, int(1.05 * R), int(0.95 * R), R][:K], np.int32)
    lane_k = (np.arange(N) % K).astype(np.int32)
    return a_win, b_win, a_len, b_len, num_k, lane_k


@pytest.mark.parametrize("bounded", [False, True])
def test_k1p_plain_equals_jax_packed_dispatch(bounded):
    set_device("cpu")
    W, N, R, K = 64, 16, 252, 3
    a_win, b_win, a_len, b_len, num_k, lane_k = _k1_lanes(7, W, N, R, K)
    diag_lo = diag_hi = None
    if bounded:
        diag_lo = np.full(N, -TB.DIAG_UNBOUNDED, np.int32)
        diag_hi = np.full(N, TB.DIAG_UNBOUNDED, np.int32)
        diag_hi[::2] = 40
        diag_lo[1::4] = -30
    ref = np.asarray(B.extend_batch_packed_async(
        a_win, b_win, a_len, b_len, num_k, lane_k, W=W, diag_lo=diag_lo,
        diag_hi=diag_hi))
    launches = TB.packed_launches
    got = TB.extend_batch_packed(a_win, b_win, a_len, b_len, num_k, lane_k,
                                 W=W, diag_lo=diag_lo, diag_hi=diag_hi).numpy()
    assert TB.packed_launches == launches, "a CPU tensor must not launch"
    assert (ref[0] > 0).any(), "scenario must produce alignments"
    np.testing.assert_array_equal(got, ref)


def test_k1p_rejects_bad_rows():
    R, W = 252, 64
    with pytest.raises(KernelError):
        TB.extend_packed(torch.zeros((2, 10), dtype=torch.uint8),
                         torch.zeros((5, 2), dtype=torch.int32),
                         np.array([R], np.int32), R=R, W=W)


def _k2_full(seed, T, N):
    rng = np.random.default_rng(seed)
    RL = 2 * T
    tpl = np.zeros((N, T), np.uint8)
    reads = np.zeros((N, RL), np.uint8)
    t_lens = np.ones(N, np.int32)
    r_lens = np.zeros(N, np.int32)
    for n in range(N):
        L = int(rng.integers(T // 2, T + 1))
        t = (np.zeros(L, np.uint8) if n % 5 == 0
             else rng.integers(0, 4, L).astype(np.uint8))
        r = (rng.integers(0, 4, RL).astype(np.uint8) if n % 7 == 3
             else _mutate(t, rng, 0.13))[:RL]
        tpl[n, :L] = t
        t_lens[n] = L
        reads[n, : len(r)] = r
        r_lens[n] = len(r)
    centers = C._make_centers(T, r_lens.astype(np.int64), None)  # (T+1, N)
    steps = np.clip(np.diff(centers, axis=0), 0, 2).astype(np.uint8).T
    meta = np.stack([t_lens, r_lens, centers[0].astype(np.int32)])
    return tpl, reads, steps, meta, centers


def test_k2p_plain_equals_jax_nw_round_packed():
    T, N, W = 256, 12, 128
    tpl, reads, steps, meta, centers = _k2_full(3, T, N)
    RL, NWIN = 2 * T, C.TB_nwin(T)
    chars = np.concatenate([pack2bit(x) for x in (tpl, reads, steps)], axis=1)
    chars_j = np.concatenate([B._pack2bit(x) for x in (tpl, reads, steps)],
                             axis=1)
    np.testing.assert_array_equal(chars, chars_j)
    packed = np.asarray(C._nw_round_packed(
        jnp.asarray(chars_j), jnp.asarray(meta.reshape(-1)), T=T, RL=RL, W=W,
        S=T + RL, NWIN=NWIN))
    outs = {}
    C._collect_chunk([(0, k, None, None) for k in range(N)], range(N), T, outs,
                     fetched=packed, centers=centers)
    launches = K2.packed_launches
    got = K2.nw_round_packed(torch.from_numpy(chars), torch.from_numpy(meta),
                             T=T, RL=RL, W=W, S=T + RL, NWIN=NWIN)
    assert K2.packed_launches == launches, "a CPU tensor must not launch"
    got = [g.numpy() for g in got]
    cov = got[6]
    assert cov.any() and not cov.all(), "need covered and uncovered lanes"
    for k in range(N):
        for f, (r, g) in enumerate(zip(outs[(0, k)], (x[k] for x in got))):
            np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                          np.asarray(r).astype(np.int64),
                                          err_msg=f"lane {k} field {f}")


def test_k2p_plain_equals_jax_window_round():
    N, W = 16, 128
    T, RL = C._WS, C._SEG
    rng = np.random.default_rng(5)
    tpl = np.zeros((N, T), np.uint8)
    seg = np.zeros((N, RL), np.uint8)
    meta = np.zeros((4, N), np.int32)  # t_lens, seg_lens, c0, loc0
    for n in range(N):
        L = int(rng.integers(C._ADV + 20, T + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        r = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 9))),
                            _mutate(t, rng, 0.13)])[:RL].astype(np.uint8)
        tpl[n, :L] = t
        seg[n, : len(r)] = r
        meta[:, n] = (L, len(r), 0, int(rng.integers(0, L - C._ADV + 1)))
    rows = np.arange(T + 1, dtype=np.int32)
    tl = np.maximum(meta[0, :, None], 1)
    cen = (np.minimum(rows[None, :], tl) * meta[1, :, None]) // tl
    steps = np.diff(cen, axis=1).clip(0, 2).astype(np.uint8)
    chars = np.concatenate([pack2bit(x) for x in (tpl, seg, steps)], axis=1)
    packed = np.asarray(C._nw_window_round(jnp.asarray(chars),
                                           jnp.asarray(meta), W=W))
    r_b = meta[3, :, None] + np.arange(C._ADV + 1)[None, :]
    cen_b = np.minimum(r_b, tl) * meta[1, :, None] // tl
    sym_j, ins_j, jp_j = C._unpack_window_rows(packed, cen_b)
    sym, ins, jpath, *_ = K2.nw_round_packed(
        torch.from_numpy(chars), torch.from_numpy(meta), T=T, RL=RL, W=W,
        S=T + RL, NWIN=max(C.TB_nwin(T), 1), lead_free=2 * C._LEAD_SLACK)
    lo = meta[3, :, None]
    c_idx = lo + np.arange(C._ADV)[None, :]
    np.testing.assert_array_equal(np.take_along_axis(sym.numpy(), c_idx, 1),
                                  sym_j)
    np.testing.assert_array_equal(
        np.take_along_axis(ins.numpy(), r_b[:, :, None], 1), ins_j)
    np.testing.assert_array_equal(np.take_along_axis(jpath.numpy(), r_b, 1),
                                  jp_j)


@pytest.mark.parametrize("NB", [8, 32])
def test_k3p_plain_equals_jax_pair_packed(NB):
    TW, TWp, RW, V = 34, 36, 48, 16
    rng = np.random.default_rng(NB)
    buf = np.zeros((V, 2 * TWp + NB * RW), np.uint8)
    meta = np.zeros((V, 2 + NB), np.int32)
    for v in range(V):
        wl = int(rng.integers(1, TW + 1))
        w = rng.integers(0, 4, wl).astype(np.uint8)
        e = np.delete(w, wl // 2)
        buf[v, :wl] = w
        buf[v, TWp : TWp + len(e)] = e
        meta[v, :2] = (wl, len(e))
        for nb in range(int(rng.integers(0, NB + 1))):
            r = _mutate(w, rng, 0.13)[:RW]
            buf[v, 2 * TWp + nb * RW : 2 * TWp + nb * RW + len(r)] = r
            meta[v, 2 + nb] = len(r)
    ref = np.asarray(C._nw_dist_pair_packed(
        jnp.asarray(B._pack2bit(buf)), jnp.asarray(meta), TW=TW, TWp=TWp,
        RW=RW, NB=NB))
    launches = K3.packed_launches
    got = K3.nw_dist_pairs_packed(torch.from_numpy(pack2bit(buf)),
                                  torch.from_numpy(meta), TW=TW, TWp=TWp,
                                  RW=RW, NB=NB).numpy()
    assert K3.packed_launches == launches, "a CPU tensor must not launch"
    np.testing.assert_array_equal(got, ref)
