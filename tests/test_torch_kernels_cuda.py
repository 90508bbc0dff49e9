"""The CUDA kernels against their plain PyTorch versions, on the card.

Each kernel runs in its unpacked mode and in its 2-bit packed mode
(K1p, K2p, K3p); K2r, K4 and K4w (both modes), K5, and K3f and K3b (both
end modes) too.  K3f also at reads of 0 to 127 bytes (one to four 32-bit
limbs) on codes and on bytes 0..255, reads off a 4-byte boundary, and
t_len past T.  K5 also at 16-byte, 4-byte and no alignment, an upload
of several chunks in one launch, and through the device store; K3b at
band widths of 1 to 256 cells, bands that move more than 32 cells a row
and reads of one char.  Skipped where there is no GPU (a CUDA kernel has no CPU or interpret
mode); on a machine with one, run ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (``tests/conftest.py`` imports JAX).  Inputs are seeded numpy arrays at
small shapes; every output must be bit-equal (integer DPs).  K1, K1p
and K1t (K1's table mode, on random-walk schedules) also run at their
edges: band widths 16 to 512, flat and steepest
schedules, a_len on chunk and trace boundaries, B column ranges cut
through the band, identity-diagonal bounds, and ragged lane blocks; K3
and K3p at read widths of one and two words, read lengths on the word
edges, padded slots, empty candidates and the main path's largest
launch.
"""

import numpy as np
import pytest
import torch
from k3f_pairs import k3f_pairs

from dentist_tpu_torch.ops import banded as K1
from dentist_tpu_torch.ops import nw_dist as K3
from dentist_tpu_torch.ops import nw_round as K2
from dentist_tpu_torch.ops import round_pack as K4
from dentist_tpu_torch.ops.pack2 import pack2bit

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _resident(seed, W, N, R, K):
    rng = np.random.default_rng(seed)
    BW = K1.bw_for(R, W)
    size = 2 * K1.RESIDENT_PAD + 4 * (R + BW)
    store = rng.integers(0, 4, size).astype(np.uint8)
    src = rng.integers(K1.RESIDENT_PAD, size - K1.RESIDENT_PAD - R, N)
    meta = np.zeros((12, N), np.int32)
    meta[0] = src
    meta[1] = rng.integers(0, 2, N)
    meta[2] = rng.integers(R // 2, R + 1, N)
    meta[3] = src - W + rng.integers(-3, 4, N)
    meta[4] = rng.integers(0, 2, N)
    meta[5] = rng.integers(0, 2, N)
    meta[6] = rng.integers(0, W // 2, N)
    meta[7] = meta[6] + rng.integers(R, BW - W // 2, N)
    meta[8] = rng.integers(R // 2, int(1.1 * R), N)
    meta[9] = np.arange(N) % K
    meta[10] = -K1.DIAG_UNBOUNDED
    meta[11] = K1.DIAG_UNBOUNDED
    meta[11, ::5] = 25
    num_k = np.array([R, int(1.04 * R), int(0.97 * R), R][:K], np.int32)
    return store, meta, num_k


#: a_len edges: no row, one row, the kernel's 32-row staging chunks,
#: JAX's 42-row chunks, the 126-row trace samples, then R
_EDGE_A_LENS = (0, 1, 31, 32, 33, 41, 42, 43, 125, 126, 127)
#: (W, N, R, schedules): W = 32 and 96 (padded bands), 256 (the
#: aligner's), 512 (2R schedules fit at R = 252); one lane, a few, and
#: 129 (a ragged last block of four lanes)
_EDGES = [(W, N, 252, kind) for W in (32, 96, 256, 512)
          for N, kind in ((1, "max"), (5, "zero"), (129, "mixed"))]
#: band widths that are not multiples of 32 (but 16), narrower and
#: wider than a warp's 32 cells, and 300 (the 32-cell-a-thread mode)
_EDGES += [(W, N, 252, kind) for W in (16, 48, 100, 130, 300)
           for N, kind in ((5, "mixed"), (129, "max"))]


def _edge_nums(kind, R, W):
    """Flat schedules (s = 0 every row), the steepest the wrapper takes
    (2R, s = 2 every row, where the B window allows it) or both among
    ordinary slopes."""
    top = min(2 * R, K1.bw_for(R, W) - 2 * W - 2 * K1._CHUNK + W // 2 + 1)
    return np.array({"zero": [0], "max": [top],
                     "mixed": [R, 0, top, int(0.95 * R)]}[kind], np.int32)


def _edge_bounds(meta_lo, meta_hi, seed):
    """Identity-diagonal bounds (j - r <= -1 or >= 1) and wider ones."""
    meta_hi[seed % 3 :: 3] = -1
    meta_lo[(seed + 1) % 3 :: 3] = 1
    meta_hi[(seed + 1) % 3 :: 6] = 40
    meta_lo[::5] = -30


def _edge_resident(seed, W, N, R, kind):
    """``_resident`` lanes at the kernel's edges: a_len on chunk and trace
    boundaries, the schedules of ``kind``, B column ranges cut through
    the band (lanes 3 mod 4), identity-diagonal bounds."""
    store, meta, _ = _resident(seed, W, N, R, 1)
    num_k = _edge_nums(kind, R, W)
    meta[9] = np.arange(N) % len(num_k)
    lens = np.array([*_EDGE_A_LENS, R], np.int32)
    meta[2] = lens[(np.arange(N) + seed) % len(lens)]
    meta[6, 3::4] = W + 20 + np.arange(3, N, 4) % 17
    meta[7, 3::4] = meta[6, 3::4] + R // 2
    _edge_bounds(meta[10], meta[11], seed)
    return store, meta, num_k


@pytest.mark.parametrize("W,N,R,kind", [
    pytest.param(256, 64, 504, None, id="resident"),
    *[pytest.param(*e, id="edges-W{}-N{}-R{}-{}".format(*e)) for e in _EDGES]])
def test_extend_kernel_equals_plain(cuda, W, N, R, kind):
    if kind is None:
        store, meta, num_k = _resident(1, W, N, R, 4)
    else:
        store, meta, num_k = _edge_resident(2, W, N, R, kind)
    s, m = torch.from_numpy(store).to(cuda), torch.from_numpy(meta).to(cuda)
    n0 = K1.launches
    got = K1.extend(s, m, num_k, R=R, W=W)
    torch.cuda.synchronize()
    assert K1.launches == n0 + 1
    ref = K1.extend_reference(s, m, num_k, R=R, W=W)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("W,N,R,kind", [
    pytest.param(*e, id="edges-W{}-N{}-R{}-{}".format(*e)) for e in _EDGES])
def test_extend_table_kernel_equals_plain(cuda, W, N, R, kind):
    """K1t, the table mode, on the store-mode edges with a table whose
    later schedules are random walks; on the ladder of the slopes, equal
    to K1."""
    from k1t_tables import walk_table

    store, meta, num_k = _edge_resident(3, W, N, R, kind)
    offs = walk_table(3, num_k, R, W, walks=max(1, len(num_k) // 2))
    s, m = torch.from_numpy(store).to(cuda), torch.from_numpy(meta).to(cuda)
    n0 = K1.table_launches
    got = K1.extend_table(s, m, offs, R=R, W=W)
    torch.cuda.synchronize()
    assert K1.table_launches == n0 + 1
    assert torch.equal(got, K1.extend_table_reference(s, m, offs, R=R, W=W))
    assert torch.equal(K1.extend_table(s, m, K1.ladder(num_k, R, W), R=R, W=W),
                       K1.extend(s, m, num_k, R=R, W=W))


def _lanes(seed, T, RL, N):
    rng = np.random.default_rng(seed)
    tpl = np.zeros((T, N), np.uint8)
    reads = np.zeros((N, RL), np.uint8)
    t_lens = rng.integers(T // 2, T + 1, N).astype(np.int32)
    r_lens = np.zeros(N, np.int32)
    for n in range(N):
        t = rng.integers(0, 4, t_lens[n]).astype(np.uint8)
        keep = rng.random(len(t)) > 0.08
        r = t[keep][: RL]
        tpl[: t_lens[n], n] = t
        reads[n, : len(r)] = r
        r_lens[n] = len(r)
    rows = np.arange(T + 1, dtype=np.int64)
    cen = np.minimum(rows[:, None] * r_lens[None, :] // np.maximum(t_lens, 1),
                     r_lens[None, :])
    steps = np.clip(np.diff(cen, axis=0), 0, 2)
    centers = np.concatenate([cen[:1], cen[:1] + np.cumsum(steps, axis=0)])
    return tpl, t_lens, reads, r_lens, centers.astype(np.int32)


@pytest.mark.parametrize("T,RL,N,lead_free", [(512, 1024, 16, -1),
                                               (192, 384, 256, 16)])
def test_nw_round_kernel_equals_plain(cuda, T, RL, N, lead_free):
    args = [torch.from_numpy(a).to(cuda) for a in _lanes(2, T, RL, N)]
    kw = dict(T=T, W=128, S=T + RL, NWIN=-(-T // 126), lead_free=lead_free)
    n0 = K2.launches
    got = K2.nw_round(*args, **kw)
    torch.cuda.synchronize()
    assert K2.launches == n0 + 1
    ref = K2.nw_round_reference(*args, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_nw_dist_kernel_equals_plain(cuda):
    TW, TWp, RW, NB, V = 34, 36, 48, 8, 64
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 4, (V, 2 * TWp + NB * RW)).astype(np.uint8)
    meta = np.concatenate([rng.integers(0, TW + 1, (V, 2)),
                           rng.integers(0, RW + 1, (V, NB))], axis=1)
    b = torch.from_numpy(buf).to(cuda)
    m = torch.from_numpy(meta.astype(np.int32)).to(cuda)
    n0 = K3.launches
    got = K3.nw_dist_pairs(b, m, TW=TW, TWp=TWp, RW=RW, NB=NB)
    torch.cuda.synchronize()
    assert K3.launches == n0 + 1
    assert torch.equal(got, K3.nw_dist_pairs_reference(b, m, TW, TWp, RW, NB))


@pytest.mark.parametrize("W,N,R,kind", [
    pytest.param(256, 64, 504, None, id="packed"),
    *[pytest.param(*e, id="edges-W{}-N{}-R{}-{}".format(*e)) for e in _EDGES]])
def test_extend_packed_kernel_equals_plain(cuda, W, N, R, kind):
    rng = np.random.default_rng(4)
    BW = K1.bw_for(R, W)
    a = rng.integers(0, 4, (N, R)).astype(np.uint8)
    b = rng.integers(0, 4, (N, BW)).astype(np.uint8)
    b[::2, W : W + R // 2] = a[::2, : R // 2]
    meta5 = np.stack([rng.integers(R // 2, int(1.1 * R), N), np.arange(N) % 3,
                      rng.integers(R // 2, R + 1, N),
                      np.full(N, -K1.DIAG_UNBOUNDED), np.full(N, K1.DIAG_UNBOUNDED)])
    meta5[4, ::5] = 25
    num_k = np.array([R, int(1.04 * R), int(0.97 * R)], np.int32)
    if kind is not None:  # the edges of _edge_resident on host windows
        num_k = _edge_nums(kind, R, W)
        meta5[1] = np.arange(N) % len(num_k)
        lens = np.array([*_EDGE_A_LENS, R])
        meta5[2] = lens[(np.arange(N) + 3) % len(lens)]
        for n in range(3, N, 4):  # a B column range cut through the band
            c_lo = W + 20 + n % 17
            b[n, :c_lo] = 0
            b[n, c_lo + R // 2 :] = 0
        _edge_bounds(meta5[3], meta5[4], 3)
    c = torch.from_numpy(np.concatenate([pack2bit(a), pack2bit(b)], 1)).to(cuda)
    m = torch.from_numpy(meta5.astype(np.int32)).to(cuda)
    n0 = K1.packed_launches
    got = K1.extend_packed(c, m, num_k, R=R, W=W)
    torch.cuda.synchronize()
    assert K1.packed_launches == n0 + 1
    assert torch.equal(got, K1.extend_packed_reference(c, m, num_k, R=R, W=W))


@pytest.mark.parametrize("T,RL,N,lead_free", [(512, 1024, 16, -1),
                                               (192, 384, 256, 16)])
def test_nw_round_packed_kernel_equals_plain(cuda, T, RL, N, lead_free):
    tpl, t_lens, reads, r_lens, centers = _lanes(5, T, RL, N)
    steps = np.diff(centers, axis=0).astype(np.uint8).T
    chars = np.concatenate([pack2bit(np.ascontiguousarray(tpl.T)),
                            pack2bit(reads), pack2bit(steps)], 1)
    meta = np.stack([t_lens, r_lens, centers[0]]).astype(np.int32)
    c, m = torch.from_numpy(chars).to(cuda), torch.from_numpy(meta).to(cuda)
    kw = dict(T=T, RL=RL, W=128, S=T + RL, NWIN=-(-T // 126),
              lead_free=lead_free)
    n0 = K2.packed_launches
    got = K2.nw_round_packed(c, m, **kw)
    torch.cuda.synchronize()
    assert K2.packed_launches == n0 + 1
    for g, r in zip(got, K2.nw_round_packed_reference(c, m, **kw)):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_nw_dist_packed_kernel_equals_plain(cuda):
    TW, TWp, RW, NB, V = 34, 36, 48, 8, 64
    rng = np.random.default_rng(6)
    buf = rng.integers(0, 4, (V, 2 * TWp + NB * RW)).astype(np.uint8)
    meta = np.concatenate([rng.integers(0, TW + 1, (V, 2)),
                           rng.integers(0, RW + 1, (V, NB))], axis=1)
    c = torch.from_numpy(pack2bit(buf)).to(cuda)
    m = torch.from_numpy(meta.astype(np.int32)).to(cuda)
    n0 = K3.packed_launches
    got = K3.nw_dist_pairs_packed(c, m, TW=TW, TWp=TWp, RW=RW, NB=NB)
    torch.cuda.synchronize()
    assert K3.packed_launches == n0 + 1
    assert torch.equal(got, K3.nw_dist_pairs_packed_reference(c, m, TW, TWp,
                                                              RW, NB))


def _packed_lanes(seed, T, RL, N):
    tpl, t_lens, reads, r_lens, centers = _lanes(seed, T, RL, N)
    steps = np.diff(centers, axis=0).astype(np.uint8).T
    chars = np.concatenate([pack2bit(np.ascontiguousarray(tpl.T)),
                            pack2bit(reads), pack2bit(steps)], 1)
    return chars, t_lens, r_lens, centers


@pytest.mark.parametrize("sparse", [True, False])
def test_round_pack_kernel_equals_plain(cuda, sparse):
    T, RL, N = 512, 1024, 16
    chars, t_lens, r_lens, centers = _packed_lanes(7, T, RL, N)
    meta = np.stack([t_lens, r_lens, centers[0]]).astype(np.int32)
    c, m = torch.from_numpy(chars).to(cuda), torch.from_numpy(meta).to(cuda)
    cen = torch.empty((N, T + 1), dtype=torch.int32, device=cuda)
    fields = K2.nw_round_packed(c, m, T=T, RL=RL, W=128, S=T + RL, NWIN=5,
                                centers_out=cen)
    n0 = (K4.sparse_launches, K4.dense_launches)
    got = K4.round_pack(c, fields, cen, T, RL, 5, sparse)
    torch.cuda.synchronize()
    assert (K4.sparse_launches, K4.dense_launches) == (n0[0] + sparse,
                                                       n0[1] + (not sparse))
    assert torch.equal(got, K4.round_pack_reference(c, fields, cen, T, RL, 5,
                                                    sparse))


@pytest.mark.parametrize("sparse", [True, False])
def test_resident_round_and_window_pack_kernels_equal_plain(cuda, sparse):
    T, RL, N = 192, 384, 64
    rng = np.random.default_rng(8)
    store = rng.integers(0, 4, 1 << 16).astype(np.uint8)
    meta = np.zeros((5, N), np.int32)
    for n in range(N):
        t0, s0 = 500 + 1000 * n, 1000 * n + 900
        tl = int(rng.integers(130, T + 1))
        keep = rng.random(tl) > 0.1
        seg = store[t0 : t0 + tl][keep]
        store[s0 : s0 + len(seg)] = seg
        meta[:, n] = (tl, len(seg), min(33, tl - 126), t0, s0)
    meta[3, -1] = (1 << 16) - 50  # a start the store clamps
    s, m = torch.from_numpy(store).to(cuda), torch.from_numpy(meta).to(cuda)
    kw = dict(T=T, RL=RL, W=128, S=T + RL, NWIN=2, lead_free=16)
    cen = torch.empty((N, T + 1), dtype=torch.int32, device=cuda)
    n0 = K2.resident_launches
    fields = K2.nw_round_resident(s, m, centers_out=cen, **kw)
    torch.cuda.synchronize()
    assert K2.resident_launches == n0 + 1
    ref = K2.nw_round_resident(s.cpu(), m.cpu(), **kw)
    for g, r in zip(fields, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)
    got = K4.window_pack(s, m, fields[:3], cen, sparse, resident=True)
    want = K4.window_pack_reference(s, m, fields[:3], cen, sparse,
                                    resident=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("align", [0, 4, 3])
def test_store_write_kernel_one_launch(cuda, align):
    """K5 writes an upload of more than two 4 Mi-char chunks (and 12
    chars past its last 16-char group) in one launch, at a destination
    16-byte aligned (16-byte stores), 4-byte aligned and unaligned (byte
    stores), and from a packed array at an odd address (byte loads);
    nothing outside the upload changes."""
    rng = np.random.default_rng(10 + align)
    n = 2 * K1._ARENA_CHUNK + 28
    packed = torch.from_numpy(rng.integers(0, 256, n // 4 + 1).astype(np.uint8))
    off = 4096 + 16 * 5 + align
    init = torch.from_numpy(rng.integers(0, 256, n + 8192).astype(np.uint8))
    on_card = packed.to(cuda)
    for cut in (slice(0, n // 4), slice(1, None)):  # the second at an odd address
        store = init.to(cuda)
        n0 = K1.store_write_launches
        K1.store_write(on_card[cut], store, off)
        torch.cuda.synchronize()
        assert K1.store_write_launches == n0 + 1
        want = init.clone()
        K1.store_write_reference(packed[cut], want, off)
        assert torch.equal(store.cpu(), want)


@pytest.mark.parametrize("n", [4, 12, 16, 28, 4096 + 12])
def test_store_write_kernel_short_uploads(cuda, n):
    """K5 on uploads with no 16-char group or a ragged last one (the
    tail's 1 to 3 packed bytes), aligned and not."""
    rng = np.random.default_rng(n)
    packed = torch.from_numpy(rng.integers(0, 256, n // 4).astype(np.uint8))
    for off in (64, 64 + 3):
        store = torch.zeros(n + 256, dtype=torch.uint8, device=cuda)
        K1.store_write(packed.to(cuda), store, off)
        want = torch.zeros(n + 256, dtype=torch.uint8)
        K1.store_write_reference(packed, want, off)
        assert torch.equal(store.cpu(), want), off


def test_device_store_one_launch_per_upload(cuda, monkeypatch):
    """A store on the card makes one K5 launch per upload and holds the
    bytes of a store on the CPU after the same uploads, a reset
    included."""
    monkeypatch.setenv("DENTIST_TPU_ARENA_MB", "24")
    rng = np.random.default_rng(13)
    uploads = [rng.integers(0, 4, n).astype(np.uint8)
               for n in (123, 70_001, K1._ARENA_CHUNK + 1, 5_000_003,
                         13_000_000)]
    on_card = K1.DeviceStore(cuda)
    on_cpu = K1.DeviceStore(torch.device("cpu"))
    for codes in uploads:
        n0 = K1.store_write_launches
        assert on_card.offset_of(codes) == on_cpu.offset_of(codes)
        torch.cuda.synchronize()
        assert K1.store_write_launches == n0 + 1
        assert torch.equal(on_card.array.cpu(), on_cpu.array)
    assert on_card.epoch == 1


def test_store_write_kernel_equals_plain(cuda):
    rng = np.random.default_rng(9)
    packed = torch.from_numpy(rng.integers(0, 256, 1 << 18).astype(np.uint8))
    store = torch.zeros(3 << 20, dtype=torch.uint8, device=cuda)
    n0 = K1.store_write_launches
    K1.store_write(packed.to(cuda), store, 4096)
    K1.store_write(packed[:1000].to(cuda), store, (2 << 20) + 3)  # unaligned
    torch.cuda.synchronize()
    assert K1.store_write_launches == n0 + 2
    want = torch.zeros(3 << 20, dtype=torch.uint8)
    K1.store_write_reference(packed, want, 4096)
    K1.store_write_reference(packed[:1000], want, (2 << 20) + 3)
    assert torch.equal(store.cpu(), want)


def _general_pairs(seed, V, N, T, RL):
    """(template, read) pairs on the general layout: empty templates,
    templates of T and more than T chars, homopolymers, empty reads,
    noisy copies and reads many times longer than their template."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (V, T)).astype(np.uint8)
    tpl[::5] = 3
    t_lens = rng.integers(1, T + 1, V).astype(np.int32)
    t_lens[::6], t_lens[1::6], t_lens[2::6] = 0, T, T + 3
    reads = rng.integers(0, 4, (V, N, RL)).astype(np.uint8)
    r_lens = rng.integers(0, RL + 1, (V, N)).astype(np.int32)
    r_lens[:, ::4] = 0
    for v in range(V):
        t = tpl[v, : min(t_lens[v], T)]
        for n in range(1, N, 4):
            r = np.concatenate([t] * 8)[:RL]
            flip = rng.random(len(r)) < 0.1
            r[flip] = rng.integers(0, 4, int(flip.sum()))
            reads[v, n, : len(r)] = r
            r_lens[v, n] = len(r) if n % 8 == 1 else min(len(r), len(t))
    return tpl, t_lens, reads, r_lens


@pytest.mark.parametrize("global_ends", [False, True])
def test_nw_dist_full_kernel_equals_plain(cuda, global_ends):
    T, RL = 34, 48
    args = [torch.from_numpy(a).to(cuda) for a in _general_pairs(10, 64, 16, T, RL)]
    n0 = K3.full_launches
    got = K3.nw_dist_full(*args, T=T, global_ends=global_ends)
    torch.cuda.synchronize()
    assert K3.full_launches == n0 + 1
    assert torch.equal(got, K3.nw_dist_full_reference(*args, T, global_ends))


@pytest.mark.parametrize("RL", [0, 1, 63, 64, 65, 127])
@pytest.mark.parametrize("global_ends", [False, True])
def test_nw_dist_full_kernel_at_edges(cuda, RL, global_ends):
    """K3f against its plain version at one to four 32-bit limbs (and no
    read column), on codes and on bytes 0..255, reads starting 0 to 3
    bytes off a 4-byte boundary; then with every t_len past T (the
    free-shift search on every pair)."""
    V, N, T = 64, 8, 40
    tpl, t_lens, reads, r_lens = k3f_pairs(RL + 1000 * global_ends, V, N, T, RL)
    for tl in (t_lens,) if global_ends else (t_lens, t_lens.clip(T + 1)):
        args = [torch.from_numpy(a).to(cuda) for a in (tpl, tl, r_lens)]
        want = None
        for align in range(4):
            flat = torch.zeros(align + reads.size, dtype=torch.uint8, device=cuda)
            flat[align:] = torch.from_numpy(reads.reshape(-1))
            rd = flat[align:].view(V, N, RL)
            n0 = K3.full_launches
            got = K3.nw_dist_full(args[0], args[1], rd, args[2], T=T,
                                  global_ends=global_ends)
            torch.cuda.synchronize()
            assert K3.full_launches == n0 + 1
            if want is None:
                want = K3.nw_dist_full_reference(args[0], args[1], rd, args[2],
                                                 T, global_ends)
            assert torch.equal(got, want), (align, tl is t_lens)
        assert (want < K3.INF).any()


#: K3b's band widths: one cell, one register exactly and one cell more,
#: the phase-3 widths, and four and eight registers (the widest band)
_K3B_WIDTHS = [1, 32, 33, 64, 65, 128, 256]


@pytest.mark.parametrize("W", _K3B_WIDTHS)
@pytest.mark.parametrize("global_ends", [False, True])
def test_banded_nw_dist_kernel_equals_plain(cuda, W, global_ends):
    T, RL = 96, 400
    args = [torch.from_numpy(a).to(cuda) for a in _general_pairs(11, 32, 16, T, RL)]
    n0 = K3.banded_launches
    got = K3.banded_nw_dist(*args, T=T, W=W, global_ends=global_ends)
    torch.cuda.synchronize()
    assert K3.banded_launches == n0 + 1
    assert torch.equal(got, K3.banded_nw_dist_reference(*args, T, W, global_ends))


def _steep_pairs(seed, V, N, T, RL):
    """Pairs whose band moves by more than 32 cells a row (templates of 1
    to 12 chars against reads of up to RL chars repeating them, rl >>
    t_len), beside t_len 0, T and more than T, rl 0 and random reads."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (V, T)).astype(np.uint8)
    t_lens = np.array([(0, 1, 2, 3, 5, 8, 12, T, T + 4, T // 2)[v % 10]
                       for v in range(V)], np.int32)
    reads = rng.integers(0, 4, (V, N, RL)).astype(np.uint8)
    r_lens = rng.integers(0, RL + 1, (V, N)).astype(np.int32)
    for v in range(V):
        t = tpl[v, : min(t_lens[v], T)]
        for n in range(N):
            if n % 4 == 3 or not len(t):
                continue
            r = np.resize(t, r_lens[v, n] if n % 4 else min(RL, 2 * len(t)))
            flip = rng.random(len(r)) < 0.1
            r[flip] = rng.integers(0, 4, int(flip.sum()))
            reads[v, n, : len(r)], r_lens[v, n] = r, len(r)
    r_lens[::7, 0] = 0
    return tpl, t_lens, reads, r_lens


@pytest.mark.parametrize("W", _K3B_WIDTHS)
@pytest.mark.parametrize("global_ends", [False, True])
def test_banded_nw_dist_kernel_steep_and_short(cuda, W, global_ends):
    """K3b where the band moves by more than a register a row (a
    register move as well as a lane rotation), and on reads of RL = 1
    (one char or none; the band's left clip puts cells at negative
    columns), against its plain version."""
    for T, RL, seed in ((24, 1200, 20 + W), (16, 1, 40 + W)):
        arrays = _steep_pairs(seed, 40, 8, T, RL)
        args = [torch.from_numpy(a).to(cuda) for a in arrays]
        n0 = K3.banded_launches
        got = K3.banded_nw_dist(*args, T=T, W=W, global_ends=global_ends)
        torch.cuda.synchronize()
        assert K3.banded_launches == n0 + 1
        want = K3.banded_nw_dist_reference(*args, T, W, global_ends)
        assert torch.equal(got, want), (T, RL)


#: K2's edges: band widths from 16 to 1024 (V = 4 cells a thread up to
#: 128, 32 above; none of 48, 100, 130 fills its warp), one lane, a few
#: and 129 (a ragged block of four lanes), one template row, and row
#: counts that are not multiples of the 32-row staging chunk
_K2_WIDTHS = (16, 48, 100, 128, 130, 1024)
_K2_SHAPES = ((1, 1), (5, 100), (129, 260))


def _k2_edge_lanes(seed, T, RL, N, jumps):
    """(tpl (T, N), t_lens, reads (N, RL), r_lens, centers (T+1, N)):
    mutated copies, homopolymers, empty reads, unrelated reads longer
    than the band can follow, reads of a template suffix, and an empty
    template; centers on the slope-1 clamp, with ``jumps`` also steps
    above 2 and below 0 on a third of the lanes."""
    rng = np.random.default_rng(seed)
    tpl = np.zeros((T, N), np.uint8)
    reads = np.zeros((N, RL), np.uint8)
    t_lens = np.zeros(N, np.int32)
    r_lens = np.zeros(N, np.int32)
    for n in range(N):
        L = int(rng.integers(max(T // 2, 1), T + 1))
        kind = n % 6
        t = rng.integers(0, 4, L).astype(np.uint8)
        if kind == 1:
            t[:] = n % 4
        keep = rng.random(L) > 0.08
        r = t[keep]
        ins = rng.random(len(r)) < 0.06
        r = np.insert(r, np.flatnonzero(ins), rng.integers(0, 4, int(ins.sum())))
        if kind == 2:
            r = r[:0]
        elif kind == 3:
            r = rng.integers(0, 4, RL)
        elif kind == 4:
            r = r[len(r) // 3 :]
        elif kind == 5 and n % 12 == 11:
            L = 0
        r = r[:RL].astype(np.uint8)
        tpl[:L, n] = t[:L]
        t_lens[n] = L
        reads[n, : len(r)] = r
        r_lens[n] = len(r)
    rows = np.arange(T + 1, dtype=np.int64)[:, None]
    cen = np.minimum(rows * r_lens[None, :] // np.maximum(t_lens, 1), r_lens)
    steps = np.clip(np.diff(cen, axis=0), 0, 2)
    if jumps:  # a few rows of each third lane move far, both ways
        for n in range(1, N, 3):
            at = rng.integers(0, T, 3)
            steps[at, n] += rng.integers(-300, 300, 3)
    cen = np.concatenate([cen[:1], cen[:1] + np.cumsum(steps, axis=0)])
    return tpl, t_lens, reads, r_lens, cen.astype(np.int32)


def _k2_equal(got, ref):
    names = ("sym", "ins", "jpath", "spans", "diffs", "win", "covered")
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r.cpu()), name


def _k2_steps(T, RL):
    """S: the whole walk, no walk, and a walk cut short."""
    return (T + RL, 0, 7)


@pytest.mark.parametrize("N,T", _K2_SHAPES)
@pytest.mark.parametrize("W", _K2_WIDTHS)
def test_nw_round_kernel_at_edges(cuda, W, N, T):
    RL = max(2 * T, 8)
    lanes = _k2_edge_lanes(10 + W, T, RL, N, jumps=True)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in lanes]
    for S in _k2_steps(T, RL):
        kw = dict(T=T, W=W, S=S, NWIN=-(-T // 126), lead_free=5 if N == 5 else -1)
        n0 = K2.launches
        got = K2.nw_round(*args, **kw)
        torch.cuda.synchronize()
        assert K2.launches == n0 + 1
        _k2_equal(got, K2.nw_round_reference(*args, **kw))


@pytest.mark.parametrize("N,T", _K2_SHAPES)
@pytest.mark.parametrize("W", _K2_WIDTHS)
def test_nw_round_packed_kernel_at_edges(cuda, W, N, T):
    T = -(-T // 4) * 4  # K2p's rows hold whole bytes
    RL = max(2 * T, 8)
    tpl, t_lens, reads, r_lens, centers = _k2_edge_lanes(20 + W, T, RL, N,
                                                         jumps=False)
    steps = np.diff(centers, axis=0).astype(np.uint8).T
    steps[1::4, ::7] = 3  # the 2-bit steps reach 3: a shift the host never makes
    chars = np.concatenate([pack2bit(np.ascontiguousarray(tpl.T)),
                            pack2bit(reads), pack2bit(steps)], 1)
    meta = np.stack([t_lens, r_lens, centers[0]]).astype(np.int32)
    c, m = torch.from_numpy(chars).to(cuda), torch.from_numpy(meta).to(cuda)
    for S in _k2_steps(T, RL):
        kw = dict(T=T, RL=RL, W=W, S=S, NWIN=-(-T // 126), lead_free=-1)
        cen = torch.empty((N, T + 1), dtype=torch.int32, device=cuda)
        cen_ref = torch.empty_like(cen)
        n0 = K2.packed_launches
        got = K2.nw_round_packed(c, m, centers_out=cen, **kw)
        torch.cuda.synchronize()
        assert K2.packed_launches == n0 + 1
        _k2_equal(got, K2.nw_round_packed_reference(c, m, centers_out=cen_ref,
                                                    **kw))
        assert torch.equal(cen, cen_ref)


@pytest.mark.parametrize("N,T", _K2_SHAPES)
@pytest.mark.parametrize("W", _K2_WIDTHS)
def test_nw_round_resident_kernel_at_edges(cuda, W, N, T):
    RL = max(2 * T, 8)
    tpl, t_lens, reads, r_lens, _ = _k2_edge_lanes(30 + W, T, RL, N,
                                                   jumps=False)
    rng = np.random.default_rng(W)
    size = 2 * N * (T + RL) + 64
    store = rng.integers(0, 4, size).astype(np.uint8)
    meta = np.zeros((5, N), np.int32)
    for n in range(N):
        t0, s0 = n * (T + RL), n * (T + RL) + T
        store[t0 : t0 + T] = tpl[:, n]
        store[s0 : s0 + RL] = reads[n]
        meta[:, n] = (t_lens[n], r_lens[n], 0, t0, s0)
    meta[3, -1] = size - 3  # starts the store clamps
    meta[4, 0] = -5
    s, m = torch.from_numpy(store).to(cuda), torch.from_numpy(meta).to(cuda)
    for S in _k2_steps(T, RL):
        kw = dict(T=T, RL=RL, W=W, S=S, NWIN=-(-T // 126), lead_free=16)
        cen = torch.empty((N, T + 1), dtype=torch.int32, device=cuda)
        cen_ref = torch.empty((N, T + 1), dtype=torch.int32)
        n0 = K2.resident_launches
        got = K2.nw_round_resident(s, m, centers_out=cen, **kw)
        torch.cuda.synchronize()
        assert K2.resident_launches == n0 + 1
        _k2_equal(got, K2.nw_round_resident(s.cpu(), m.cpu(),
                                            centers_out=cen_ref, **kw))
        assert torch.equal(cen.cpu(), cen_ref)


#: K3's edges: read widths of one word (1, 48, 63, 64) and two (65,
#: 127); one slot per candidate, a few, 33 (a ragged warp) and 128; one
#: candidate and 257
_K3_RWS = (1, 48, 63, 64, 65, 127)
_K3_NBS = (1, 8, 33, 128)
_K3_VS = (1, 257)
#: read lengths on the kernel's word and 16-code edges (kept below RW)
_K3_RLS = (0, 1, 15, 16, 17, 47, 48, 63, 64, 65, 126, 127)


def _k3_rows(seed, TW, TWp, RW, NB, V, live=1.0, filled=1.0):
    """[base window | edited window | NB segments] rows and their meta:
    window lengths 0, 1, TW, TW + 1 and -1 among ordinary ones; read
    lengths on the word edges, RW, RW + 1 and -1 among noisy copies
    (13 %) of the window, homopolymers and tandem repeats; random codes
    past every length.  ``live`` of the candidates have windows and
    ``filled`` of their slots reads; the rest are padding (length 0)."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, (V, 2 * TWp + NB * RW)).astype(np.uint8)
    meta = np.zeros((V, 2 + NB), np.int32)
    tls = (0, 1, TW, TW + 1, -1)
    rls = [r for r in _K3_RLS if r < RW] + [RW, RW + 1, -1]
    for v in range(int(V * live)):
        w = rng.integers(0, 4, TW).astype(np.uint8)
        if v % 3 == 1:
            w[:] = v % 4
        elif v % 3 == 2:
            w = np.resize(w[: int(rng.integers(2, 5))], TW)
        buf[v, :TW] = w
        buf[v, TWp + TW // 2] = (w[TW // 2] + 1) % 4
        meta[v, :2] = ([tls[v % 5], tls[(v + 2) % 5]] if v % 4 == 3
                       else rng.integers(max(TW - 3, 1), TW + 1, 2))
        for nb in range(int(NB * filled)):
            r = np.resize(w, RW + 8)
            flip = rng.random(len(r)) < 0.13
            r[flip] = rng.integers(0, 4, int(flip.sum()))
            r = np.delete(r, np.flatnonzero(rng.random(len(r)) < 0.03))
            if nb % 5 == 3:
                r[:] = nb % 4
            rl = (rls[(v + nb) % len(rls)] if (v + nb) % 3 == 2
                  else min(int(rng.integers(TW - 4, TW + 5)), RW))
            n = min(max(rl, 0), RW, len(r))
            buf[v, 2 * TWp + nb * RW : 2 * TWp + nb * RW + n] = r[:n]
            meta[v, 2 + nb] = rl
    return buf, meta


def _hold_k3(cuda, buf, meta, TW, TWp, RW, NB):
    """K3 and (where the row packs into whole bytes) K3p against their
    plain versions; one launch each."""
    b, m = torch.from_numpy(buf).to(cuda), torch.from_numpy(meta).to(cuda)
    n0 = (K3.launches, K3.packed_launches)
    got = K3.nw_dist_pairs(b, m, TW=TW, TWp=TWp, RW=RW, NB=NB)
    ref = K3.nw_dist_pairs_reference(b, m, TW, TWp, RW, NB)
    packs = buf.shape[1] % 4 == 0
    if packs:
        c = torch.from_numpy(pack2bit(buf)).to(cuda)
        got_p = K3.nw_dist_pairs_packed(c, m, TW=TW, TWp=TWp, RW=RW, NB=NB)
        assert torch.equal(got_p, ref)
    torch.cuda.synchronize()
    assert (K3.launches, K3.packed_launches) == (n0[0] + 1, n0[1] + packs)
    assert torch.equal(got, ref)
    return ref


@pytest.mark.parametrize("V", _K3_VS)
@pytest.mark.parametrize("NB", _K3_NBS)
@pytest.mark.parametrize("RW", _K3_RWS)
def test_nw_dist_kernels_at_edges(cuda, RW, NB, V):
    """K3 and K3p at the length edges, padded slots and empty candidates;
    TWp = 36 where NB * RW packs into whole bytes, 37 (windows and
    segments starting inside a byte) where 2 * TWp + NB * RW can still,
    35 (K3 alone) where it cannot."""
    TW = 34
    TWp = {0: 36, 2: 37}.get(NB * RW % 4, 35)
    buf, meta = _k3_rows(RW * 1000 + NB * 10 + V, TW, TWp, RW, NB, V,
                         live=0.8 if V > 1 else 1.0, filled=0.75 if NB > 1 else 1.0)
    ref = _hold_k3(cuda, buf, meta, TW, TWp, RW, NB)
    assert (ref < K3.INF).any()


def test_nw_dist_kernels_main_path_shape(cuda):
    """The main path's largest launch: V = 4096 candidates, NB = 128."""
    TW, TWp, RW, NB, V = 34, 36, 48, 128, 4096
    buf, meta = _k3_rows(11, TW, TWp, RW, NB, V, live=0.6, filled=0.4)
    ref = _hold_k3(cuda, buf, meta, TW, TWp, RW, NB)
    assert (ref < K3.INF).sum() > V * NB // 5


# K4 and K4w at the main path's buckets: (T, N) of the full rounds' K4
# launches (phase 5 of chip_smoke.py, 3 Mb; the sparse K4 spreads (6144,
# 32) and (8192, 32) over clusters of 3 and 4 CTAs), T = 256, T = 12288
# (a cluster of 6), T = 16384, whose dense row (74 KB) is past the 48 KB
# of shared memory a block gets without an opt-in (a cluster of 8), and T
# = 32768 in a cluster of 8 and, at N = 32, in one CTA of 8 tiles; the
# windowed rows at the lane ladder's N
_K4_BUCKETS = [(256, 32), (2048, 32), (2048, 128), (3072, 128), (4096, 128),
               (6144, 32), (6144, 128), (8192, 32), (12288, 16), (16384, 8),
               (32768, 4), (32768, 32)]
_K4W_NS = [32, 128, 512, 2048]


def _k4_fields(seed, T, N, live):
    """Crafted round fields on the card.  ``live`` "all": every lane a
    covered lane at ~13 % events, and lanes 1, 2, 3 (mod 4) over the
    divergence, insertion and escape caps; "one": lane 0 alone, the rest
    padding as the round leaves it (sym 5, jpath -1, uncovered); and
    "uncovered": every lane's span set, none covered, with insertions
    (which are not masked by coverage)."""
    rng = np.random.default_rng(seed)
    NWIN = -(-T // 126)
    tpl = rng.integers(0, 4, (N, T)).astype(np.int8)
    p = np.full((N, 1), 0.13)
    if live == "all":
        p[1::4] = 0.5
    sym = np.where(rng.random((N, T)) < p, rng.integers(0, 5, (N, T)),
                   tpl).astype(np.int8)
    pi = np.full((N, 1, 1), 0.05)
    if live == "all":
        pi[2::4] = 0.35
    ins = np.where(rng.random((N, T + 1, 1)) < pi,
                   rng.integers(0, 5, (N, T + 1, 4)), 0).astype(np.int8)
    steps = rng.choice([0, 1, 2, 3], (N, T), p=[0.05, 0.8, 0.1, 0.05])
    if live == "all":
        steps[3::4, :: T // 40] = 40
    steps[0, :17] = [15, 14] * 8 + [15]  # deltas 15 (escapes) and 14
    jpath = np.concatenate([rng.integers(0, 99, (N, 1)), steps], 1).cumsum(1)
    s0 = rng.integers(0, T // 8, N)
    s1 = T - rng.integers(0, T // 8, N)
    s0[0], s1[0] = 0, T
    covered = np.full(N, live != "uncovered")
    if live == "one":
        covered[1:] = False
    col = np.arange(T + 1)[None, :]
    in_span = (col >= s0[:, None]) & (col <= s1[:, None]) & covered[:, None]
    sym = np.where(in_span[:, :T], sym, 5).astype(np.int8)
    jpath = np.where(in_span, jpath, -1).astype(np.int32)
    if live == "one":
        ins[1:] = 0
    spans = np.stack([s0, s1], 1).astype(np.int32)
    spans[~covered] = 0 if live == "one" else spans[~covered]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    chars = np.concatenate([pack2bit(tpl.astype(np.uint8)),
                            rng.integers(0, 256, (N, 3 * T // 4)).astype(np.uint8)], 1)
    fields = tuple(t(a) for a in (sym, ins, jpath, spans,
                                  rng.integers(0, 999, N).astype(np.int32),
                                  rng.integers(0, 9, (N, NWIN)).astype(np.int32),
                                  covered))
    cen = t((jpath + rng.integers(-60, 60, jpath.shape)).astype(np.int32))
    return t(chars), fields, cen, NWIN


@pytest.mark.parametrize("live", ["all", "one", "uncovered"])
@pytest.mark.parametrize("T,N", _K4_BUCKETS)
def test_round_pack_kernel_at_buckets(cuda, T, N, live):
    """K4, sparse and dense, equal to its plain version at every main-path
    bucket; in the "all" case every lane of 1, 2, 3 (mod 4) is over its
    cap and flagged."""
    chars, fields, cen, NWIN = _k4_fields(T * 7 + N, T, N, live)
    for sparse in (True, False):
        n0 = (K4.sparse_launches, K4.dense_launches)
        got = K4.round_pack(chars, fields, cen, T, 2 * T, NWIN, sparse)
        torch.cuda.synchronize()
        assert (K4.sparse_launches, K4.dense_launches) == (
            n0[0] + sparse, n0[1] + (not sparse))
        want = K4.round_pack_reference(chars, fields, cen, T, 2 * T, NWIN, sparse)
        assert torch.equal(got, want), (T, N, live, sparse)
        if sparse:
            ovf = want[:, -NWIN - 1].cpu().numpy().astype(bool)
            n = np.arange(N)
            assert ovf[n % 4 != 0].all() if live == "all" else not ovf.any()


def _window_case(seed, N, resident):
    """Windowed lanes' fields on the card: interiors at every loc0 from 0
    to 66 (odd ones included); lanes 1, 2, 3 (mod 8) over the divergence,
    insertion and escape caps; every fourth lane padding (t_len 1, sym 5,
    jpath -1); in resident mode templates starting at the store's end and
    before its start (both clamped), the store's tail filled."""
    rng = np.random.default_rng(seed)
    T, RL = 192, 384
    tpl = rng.integers(0, 4, (N, T)).astype(np.int8)
    n = np.arange(N)
    p = np.where(n % 8 == 1, 0.7, 0.1)[:, None]
    sym = np.where(rng.random((N, T)) < p, rng.integers(0, 5, (N, T)), tpl)
    pi = np.where(n % 8 == 2, 0.3, 0.04)[:, None, None]
    ins = np.where(rng.random((N, T + 1, 1)) < pi,
                   rng.integers(0, 5, (N, T + 1, 4)), 0).astype(np.int8)
    steps = rng.choice([0, 1, 2], (N, T), p=[0.05, 0.85, 0.1])
    steps[n % 8 == 3, ::10] = 17
    jpath = np.concatenate([rng.integers(0, 9, (N, 1)), steps], 1).cumsum(1)
    a = rng.integers(0, 40, N)
    b = T - rng.integers(0, 40, N)
    col = np.arange(T + 1)[None, :]
    ok = (col >= a[:, None]) & (col <= b[:, None]) & (n % 4 != 0)[:, None]
    sym = np.where(ok[:, :T], sym, 5).astype(np.int8)
    jpath = np.where(ok, jpath, -1).astype(np.int32)
    loc0 = (n * 7) % 67
    t_lens = np.where(n % 4 == 0, 1, rng.integers(130, T + 1, N))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    fields = (t(sym), t(ins), t(jpath))
    cen = t((jpath + rng.integers(-80, 80, jpath.shape)).astype(np.int32))
    if resident:
        store = rng.integers(0, 4, N * T + 4096).astype(np.uint8)
        meta = np.stack([t_lens, rng.integers(0, RL, N), loc0, n * T + 512,
                         np.zeros(N)]).astype(np.int32)
        meta[3, 1] = len(store) - 7       # past the end: clamped to len - T
        meta[3, 2 % N] = -3               # before the start: clamped to 0
        return t(store), t(meta), fields, cen
    chars = np.concatenate([pack2bit(tpl.astype(np.uint8)),
                            rng.integers(0, 256, (N, 144)).astype(np.uint8)], 1)
    meta = np.stack([t_lens, rng.integers(0, RL, N), np.zeros(N), loc0]).astype(np.int32)
    return t(chars), t(meta), fields, cen


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("N", _K4W_NS)
def test_window_pack_kernel_at_buckets(cuda, N, resident):
    """K4w, sparse and dense, equal to its plain version at the lane
    ladder's N, odd loc0s, clamped template starts and every cap."""
    tsrc, meta, fields, cen = _window_case(N + resident, N, resident)
    for sparse in (True, False):
        n0 = (K4.window_sparse_launches, K4.window_dense_launches)
        got = K4.window_pack(tsrc, meta, fields, cen, sparse, resident)
        torch.cuda.synchronize()
        assert (K4.window_sparse_launches, K4.window_dense_launches) == (
            n0[0] + sparse, n0[1] + (not sparse))
        want = K4.window_pack_reference(tsrc, meta, fields, cen, sparse, resident)
        assert torch.equal(got, want), (N, resident, sparse)
        if sparse:
            ovf = want.cpu().numpy().view(np.uint8).reshape(N, -1)[:, 166]
            n = np.arange(N)
            assert ovf[np.isin(n % 8, (1, 2, 3))].all()
