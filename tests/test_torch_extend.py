"""K1 (``dentist_tpu_torch.ops.banded``) against the JAX extension DP.

The same seeded numpy inputs go through ``_extend_scan_v3`` /
``_extend_scan_v3_resident`` (plain ``jax.jit`` on the CPU backend) and
through the port's wrapper on CPU tensors, which runs the plain PyTorch
version.  Every DP here is integer, so the tolerance is 0: outputs must
be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dentist_tpu.ops.banded as B
import dentist_tpu_torch.ops.banded as TB
from dentist_tpu_torch.errors import KernelError
from dentist_tpu_torch.ops.pack2 import pack2bit


def _offs(num_k, R, W):
    rows = np.arange(R + 1, dtype=np.int64)
    return ((rows[:, None] * num_k[None, :]) // R - W // 2).astype(np.int32)


def _host_lanes(seed, W, N, R, K, a_len=None, b_len=None):
    rng = np.random.default_rng(seed)
    BW = TB.bw_for(R, W)
    a_win = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b_win = rng.integers(0, 4, (N, BW)).astype(np.uint8)
    # lanes that share most of A with their B window, so alignments form
    for n in range(0, N, 2):
        L = R // 2
        b_win[n, W : W + L] = a_win[n, :L]
    if a_len is None:
        a_len = rng.integers(R // 2, R + 1, N).astype(np.int32)
    if b_len is None:
        b_len = rng.integers(R // 2, int(1.1 * R), N).astype(np.int32)
    num_k = np.array([R, int(1.05 * R), int(0.95 * R), R][:K], np.int32)
    lane_k = (np.arange(N) % K).astype(np.int32)
    return a_win, b_win, a_len, b_len, num_k, lane_k, BW


#: a_len edges: no row, one row, the kernel's 32-row staging chunks,
#: JAX's 42-row chunks and the 126-row trace samples (the window's R is
#: added per case)
_EDGE_A_LENS = (0, 1, 31, 32, 33, 41, 42, 43, 125, 126, 127)


def _max_num(R, W):
    """The steepest schedule the wrapper takes: 2R (the band moves two
    columns every row) where the B window allows it, else the widest."""
    return min(2 * R, TB.bw_for(R, W) - 2 * W - 2 * TB._CHUNK + W // 2 + 1)


def _edge_nums(kind, R, W):
    """Band slopes: every row shifts 0 columns, the steepest slope, or
    both among ordinary ones."""
    return np.array({"zero": [0], "max": [_max_num(R, W)],
                     "mixed": [R, 0, _max_num(R, W), int(0.95 * R)]}[kind],
                    np.int32)


def _edge_a_lens(seed, N, R):
    lens = np.array([*_EDGE_A_LENS, R], np.int32)
    return lens[(np.arange(N) + seed) % len(lens)]


def _edge_host_lanes(seed, W, N, R, kind):
    """Host windows at the kernel's edges: a_len on chunk and trace
    boundaries, flat or steepest schedules, B windows that hold A from
    column W (even lanes) or with a B column range cut through the band
    (lanes 3 mod 4: zeros outside it, as the gather writes them)."""
    rng = np.random.default_rng(seed)
    BW = TB.bw_for(R, W)
    a_win = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b_win = rng.integers(0, 4, (N, BW)).astype(np.uint8)
    b_win[::2, W : W + R] = a_win[::2]
    for n in range(3, N, 4):
        c_lo = W + 20 + n % 17
        b_win[n, :c_lo] = 0
        b_win[n, c_lo + R // 2 :] = 0
    a_len = _edge_a_lens(seed, N, R)
    b_len = rng.integers(R // 2, int(1.1 * R), N).astype(np.int32)
    num_k = _edge_nums(kind, R, W)
    lane_k = (np.arange(N) % len(num_k)).astype(np.int32)
    return a_win, b_win, a_len, b_len, num_k, lane_k, BW


def _jax_packed(a_win, b_win, a_len, b_len, num_k, lane_k, diag_lo, diag_hi,
                R, W, bound_diag):
    """JAX's K1p program on the same lanes: ``_extend_scan_v3_packed``."""
    N = a_win.shape[0]
    chars = np.concatenate([B._pack2bit(a_win), B._pack2bit(b_win)], axis=1)
    meta = np.concatenate([b_len, lane_k, a_len, diag_lo, diag_hi,
                           num_k]).astype(np.int32)
    return np.asarray(B._extend_scan_v3_packed(
        jnp.asarray(chars), jnp.asarray(meta), R=R, N=N, K=len(num_k), W=W,
        bound_diag=bound_diag))


def _port_packed(a_win, b_win, a_len, b_len, num_k, lane_k, diag_lo, diag_hi,
                 R, W):
    chars = np.concatenate([pack2bit(a_win), pack2bit(b_win)], axis=1)
    meta5 = np.stack([b_len, lane_k, a_len, diag_lo, diag_hi]).astype(np.int32)
    return TB.extend_packed(torch.from_numpy(chars), torch.from_numpy(meta5),
                            num_k, R=R, W=W).numpy()


def _port_host_windows(a_win, b_win, a_len, b_len, num_k, lane_k, diag_lo,
                       diag_hi, R, W):
    N = a_win.shape[0]
    BW = b_win.shape[1]
    scratch = torch.from_numpy(np.concatenate([a_win.ravel(), b_win.ravel()]))
    meta = TB.host_window_meta(a_len, b_len, lane_k, diag_lo, diag_hi, N, R, BW)
    launches = TB.launches
    out = TB.extend(scratch, torch.from_numpy(meta), num_k, R=R, W=W)
    assert TB.launches == launches, "a CPU tensor must not launch the kernel"
    return out.numpy()


#: edge cases at the kernel's widths: W = 32 and 96 (padded bands), 256
#: (the aligner's), 512 (the widest band with 2R schedules at R = 252);
#: one lane, a few, and 129 (a ragged last block of four lanes)
_EDGE_CASES = [(32, 1, 252, "max", 31), (96, 129, 252, "mixed", 32),
               (256, 5, 252, "zero", 33), (256, 129, 504, "mixed", 34),
               (512, 129, 252, "max", 35)]


#: band widths that are not multiples of 32 (16 is one of 16), on both
#: sides of the consensus band's 128: the card kernel pads them with
#: unreachable cells
_NARROW_CASES = [(16, 8, 252, "mixed", 41), (48, 8, 252, "max", 42),
                 (100, 8, 252, "mixed", 43), (130, 8, 252, "zero", 44)]


@pytest.mark.parametrize("W,N,R,K,seed,kind", [
    pytest.param(64, 16, 252, 4, 11, None, id="64-16-252-4-11"),
    pytest.param(256, 8, 504, 3, 21, None, id="256-8-504-3-21"),
    *[pytest.param(W, N, R, 0, seed, kind, id=f"edges-W{W}-N{N}-R{R}-{kind}")
      for W, N, R, kind, seed in _EDGE_CASES + _NARROW_CASES]])
def test_extend_random_lanes_equal_jax(W, N, R, K, seed, kind):
    if kind is None:
        lanes = _host_lanes(seed, W, N, R, K)
    else:
        lanes = _edge_host_lanes(seed, W, N, R, kind)
    a_win, b_win, a_len, b_len, num_k, lane_k, _ = lanes
    diag_lo = np.full(N, -TB.DIAG_UNBOUNDED, np.int32)
    diag_hi = np.full(N, TB.DIAG_UNBOUNDED, np.int32)
    ref = np.asarray(B._extend_scan_v3(
        jnp.asarray(np.ascontiguousarray(a_win.T)), jnp.asarray(b_win),
        jnp.asarray(b_len), jnp.asarray(_offs(num_k, R, W)),
        jnp.asarray(lane_k), jnp.asarray(a_len), jnp.asarray(diag_lo),
        jnp.asarray(diag_hi), W=W, bound_diag=False))
    got = _port_host_windows(a_win, b_win, a_len, b_len, num_k, lane_k,
                             diag_lo, diag_hi, R, W)
    assert ref.shape == got.shape == (4 + R // 126, N)
    assert (ref[0] > 0).any(), "scenario must produce alignments"
    np.testing.assert_array_equal(got, ref)
    if kind is not None:  # the packed mode on the same lanes
        args = (a_win, b_win, a_len, b_len, num_k, lane_k, diag_lo, diag_hi, R, W)
        np.testing.assert_array_equal(_port_packed(*args),
                                      _jax_packed(*args, bound_diag=False))


def _diag_bounded(N, seed):
    """Identity-diagonal bounds (tandem-style: j - r <= -1 or >= 1) on
    most lanes, nearer and wider bounds on others."""
    diag_lo = np.full(N, -TB.DIAG_UNBOUNDED, np.int32)
    diag_hi = np.full(N, TB.DIAG_UNBOUNDED, np.int32)
    diag_hi[seed % 3 :: 3] = -1
    diag_lo[(seed + 1) % 3 :: 3] = 1
    diag_hi[(seed + 1) % 3 :: 6] = 40
    diag_lo[::5] = -30
    return diag_lo, diag_hi


def test_extend_diag_bounds_equal_jax():
    W, N, R, K = 64, 8, 252, 2
    a_win, b_win, a_len, b_len, _, lane_k, _ = _host_lanes(
        12, W, N, R, K, a_len=np.full(N, R, np.int32),
        b_len=np.full(N, R, np.int32))
    num_k = np.array([R, R], np.int32)
    diag_lo = np.full(N, -TB.DIAG_UNBOUNDED, np.int32)
    diag_hi = np.full(N, TB.DIAG_UNBOUNDED, np.int32)
    diag_hi[::2] = 40  # tandem-style identity exclusion on even lanes
    diag_lo[1::4] = -30
    ref = np.asarray(B._extend_scan_v3(
        jnp.asarray(np.ascontiguousarray(a_win.T)), jnp.asarray(b_win),
        jnp.asarray(b_len), jnp.asarray(_offs(num_k, R, W)),
        jnp.asarray(lane_k), jnp.asarray(a_len), jnp.asarray(diag_lo),
        jnp.asarray(diag_hi), W=W, bound_diag=True))
    got = _port_host_windows(a_win, b_win, a_len, b_len, num_k, lane_k,
                             diag_lo, diag_hi, R, W)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("W,N,R,kind,seed", _EDGE_CASES[:2] + _EDGE_CASES[3:])
def test_extend_diag_bounds_edges_equal_jax(W, N, R, kind, seed):
    """The diagonal-bounded DP at the edge cases, both modes: B windows
    that repeat A, so the identity diagonal would win where not bounded."""
    a_win, b_win, a_len, b_len, num_k, lane_k, _ = _edge_host_lanes(
        seed, W, N, R, kind)
    b_win[:, W : W + R] = a_win
    diag_lo, diag_hi = _diag_bounded(N, seed)
    args = (a_win, b_win, a_len, b_len, num_k, lane_k, diag_lo, diag_hi, R, W)
    ref = _jax_packed(*args, bound_diag=True)
    assert (ref[0] > 0).any(), "scenario must produce alignments"
    np.testing.assert_array_equal(_port_host_windows(*args), ref)
    np.testing.assert_array_equal(_port_packed(*args), ref)


def _resident_case(seed, W, N, R, K, kind=None):
    """A random store plus lanes with reversed A, reversed and/or
    complemented B, clipped [c_lo, c_hi) and a few diagonal bounds;
    with ``kind``, the edge cases' a_len, schedules (``_edge_nums``),
    column ranges cut through the band and identity-diagonal bounds."""
    rng = np.random.default_rng(seed)
    BW = TB.bw_for(R, W)
    size = 4 * (R + BW) + 2 * TB.RESIDENT_PAD
    arena = rng.integers(0, 4, size).astype(np.uint8)
    src = rng.integers(TB.RESIDENT_PAD, size - TB.RESIDENT_PAD - R, N)
    meta = np.zeros((12, N), np.int32)
    meta[0] = src
    meta[1] = rng.integers(0, 2, N)
    meta[2] = rng.integers(R // 2, R + 1, N)
    # B windows start near the A window so lanes align (with flips they
    # mostly do not, which exercises the low-score paths)
    meta[3] = src - W + rng.integers(-3, 4, N)
    meta[4] = rng.integers(0, 2, N)
    meta[5] = rng.integers(0, 2, N)
    meta[6] = rng.integers(0, W // 2, N)
    meta[7] = meta[6] + rng.integers(R, BW - W // 2, N)
    meta[8] = rng.integers(R // 2, int(1.1 * R), N)
    meta[9] = np.arange(N) % K
    meta[10] = -TB.DIAG_UNBOUNDED
    meta[11] = TB.DIAG_UNBOUNDED
    meta[11, ::5] = 25
    num_k = np.array([R, int(1.04 * R), int(0.97 * R), R][:K], np.int32)
    if kind is not None:
        num_k = _edge_nums(kind, R, W)
        meta[9] = np.arange(N) % len(num_k)
        meta[2] = _edge_a_lens(seed, N, R)
        meta[6, 3::4] = W + 20 + np.arange(3, N, 4) % 17
        meta[7, 3::4] = meta[6, 3::4] + R // 2
        meta[10], meta[11] = _diag_bounded(N, seed)
    return arena, meta, num_k, BW


@pytest.mark.parametrize("seed,W,N,R,kind", [
    pytest.param(3, 64, 16, 252, None, id="3"),
    pytest.param(4, 64, 16, 252, None, id="4"),
    *[pytest.param(seed, W, N, R, kind, id=f"edges-W{W}-N{N}-R{R}-{kind}")
      for W, N, R, kind, seed in _EDGE_CASES[1:3] + _EDGE_CASES[4:]]])
def test_extend_resident_lanes_equal_jax(seed, W, N, R, kind):
    arena, meta, num_k, BW = _resident_case(seed, W, N, R, 3, kind)
    ref = np.asarray(B._extend_scan_v3_resident(
        jnp.asarray(arena), jnp.asarray(meta), jnp.asarray(num_k), R=R, N=N,
        K=len(num_k), W=W, BW=BW, bound_diag=True))
    got = TB.extend(torch.from_numpy(arena), torch.from_numpy(meta), num_k,
                    R=R, W=W).numpy()
    np.testing.assert_array_equal(got, ref)


def test_unpack_extension_matches_jax():
    arena, meta, num_k, BW = _resident_case(5, 64, 8, 252, 2)
    out = TB.extend(torch.from_numpy(arena), torch.from_numpy(meta), num_k,
                    R=252, W=64)
    for a, b in zip(TB.unpack_extension(out), B.unpack_extension(out.numpy())):
        np.testing.assert_array_equal(a, b)


def test_extend_rejects_out_of_range_schedules():
    arena, meta, _, _ = _resident_case(6, 64, 4, 252, 1)
    with pytest.raises(KernelError):
        TB.extend(torch.from_numpy(arena), torch.from_numpy(meta),
                  np.array([3 * 252], np.int32), R=252, W=64)


def test_device_store_bytes_equal_jax_arena(monkeypatch):
    """Same uploads into the JAX arena and the port's store: same
    offsets, same epochs, same bytes — through a reset."""
    monkeypatch.setenv("DENTIST_TPU_ARENA_MB", "16")
    arena = B._Arena()
    store = TB.DeviceStore(torch.device("cpu"))
    assert store.capacity == B._arena_capacity() == 16 << 20
    rng = np.random.default_rng(7)
    seqs = [rng.integers(0, 4, n).astype(np.uint8)
            for n in (1000, 70_000, 3_000_000, 5_000_000, 6_000_000, 123)]
    for s in seqs:
        assert store.offset_of(s) == arena.offset_of(s)
        assert store.epoch == arena.epoch
        np.testing.assert_array_equal(store.array.numpy(),
                                      np.asarray(arena.array))
    assert store.epoch > 0, "the uploads must force a reset"
    with pytest.raises(MemoryError):
        store.offset_of(np.zeros(20 << 20, np.uint8))


def test_device_store_from_seqstore():
    from dentist_tpu.models.sequences import SeqStore

    codes = np.random.default_rng(8).integers(0, 4, 5000).astype(np.uint8)
    seqs = SeqStore(codes, np.array([2000, 3000]))
    store = TB.DeviceStore.from_seqstore(seqs, torch.device("cpu"))
    off = store.offset_of(seqs.codes)
    np.testing.assert_array_equal(store.array[off : off + 5000].numpy(), codes)


@pytest.mark.parametrize("W", [0, 1025])
@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K1p"])
def test_extend_rejects_bad_widths(packed, W):
    """K1 and K1p take 1 <= W <= 1024 (the card kernel keeps the band in
    registers) and refuse the widths outside."""
    R, N = 252, 2
    num_k = np.array([R], np.int32)
    with pytest.raises(KernelError, match="unsupported shape"):
        if packed:
            TB.extend_packed(torch.zeros((N, (R + 512) // 4), dtype=torch.uint8),
                             torch.zeros((5, N), dtype=torch.int32), num_k,
                             R=R, W=W)
        else:
            TB.extend(torch.zeros(4096, dtype=torch.uint8),
                      torch.zeros((12, N), dtype=torch.int32), num_k, R=R, W=W)
