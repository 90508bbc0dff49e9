"""K3, K3f and K3b (``dentist_tpu_torch.ops.nw_dist``) against the JAX
scorers.

Seeded numpy (template, read) pairs go through ``_nw_dist_full`` (both
end modes), ``_banded_nw_dist`` and ``_nw_dist_pair_packed`` (``jax.jit``
on the CPU backend) and through the port's functions on CPU tensors (the
plain PyTorch versions).  Integer DP: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dentist_tpu.ops import consensus as C
from dentist_tpu.ops.banded import _pack2bit
from dentist_tpu.sim.reads import _mutate
from dentist_tpu_torch.errors import KernelError
from dentist_tpu_torch.ops import nw_dist as K3
from k3f_pairs import k3f_pairs


def _pairs(seed, V, N, T, RL):
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (V, T)).astype(np.uint8)
    tpl[::7] = 2  # homopolymer windows: ties everywhere
    t_lens = rng.integers(0, T + 1, V).astype(np.int32)
    t_lens[::9] = 0  # empty windows score INF
    reads = np.zeros((V, N, RL), np.uint8)
    r_lens = np.zeros((V, N), np.int32)
    for v in range(V):
        for n in range(N):
            r = _mutate(tpl[v, : t_lens[v]], rng, 0.15)[:RL]
            if n % 5 == 4:
                r = rng.integers(0, 4, int(rng.integers(0, RL + 1))).astype(np.uint8)
            reads[v, n, : len(r)] = r
            r_lens[v, n] = len(r)
    return tpl, t_lens, reads, r_lens


def test_nw_dist_full_global_equals_jax():
    V, N, T, RL = 24, 8, 34, 48
    tpl, t_lens, reads, r_lens = _pairs(1, V, N, T, RL)
    ref = np.asarray(C._nw_dist_full(jnp.asarray(tpl), jnp.asarray(t_lens),
                                     jnp.asarray(reads), jnp.asarray(r_lens),
                                     T=T, global_ends=True))
    got = K3.nw_dist_full_reference(torch.from_numpy(tpl),
                                    torch.from_numpy(t_lens),
                                    torch.from_numpy(reads),
                                    torch.from_numpy(r_lens), T).numpy()
    assert (ref < C._INF).any() and (ref == C._INF).any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("NB,seed", [(8, 2), (32, 3)])
def test_nw_dist_pairs_equal_jax_packed(NB, seed):
    """The pairing (base and edited window against shared segments)
    against ``_nw_dist_pair_packed`` fed the 2-bit packing of the same
    bytes."""
    TW, TWp, RW, V = 34, 36, 48, 16
    rng = np.random.default_rng(seed)
    buf = np.zeros((V, 2 * TWp + NB * RW), np.uint8)
    meta = np.zeros((V, 2 + NB), np.int32)
    for v in range(V):
        wl = int(rng.integers(1, TW + 1))
        w = rng.integers(0, 4, wl).astype(np.uint8)
        e = w.copy()
        e[wl // 2] = (e[wl // 2] + 1) % 4
        buf[v, :wl] = w
        buf[v, TWp : TWp + wl] = e
        meta[v, :2] = wl
        for nb in range(int(rng.integers(0, NB + 1))):
            r = _mutate(w, rng, 0.13)[:RW]
            buf[v, 2 * TWp + nb * RW : 2 * TWp + nb * RW + len(r)] = r
            meta[v, 2 + nb] = len(r)
    ref = np.asarray(C._nw_dist_pair_packed(
        jnp.asarray(_pack2bit(buf)), jnp.asarray(meta), TW=TW, TWp=TWp, RW=RW,
        NB=NB))
    launches = K3.launches
    got = K3.nw_dist_pairs(torch.from_numpy(buf), torch.from_numpy(meta),
                           TW=TW, TWp=TWp, RW=RW, NB=NB).numpy()
    assert K3.launches == launches, "a CPU tensor must not launch the kernel"
    assert got.shape == (2, V, NB)
    np.testing.assert_array_equal(got, ref)


def test_nw_dist_pairs_rejects_long_reads():
    with pytest.raises(KernelError):
        K3.nw_dist_pairs(torch.zeros((2, 72 + 128), dtype=torch.uint8),
                         torch.zeros((2, 3), dtype=torch.int32),
                         TW=34, TWp=36, RW=128, NB=1)


def _edge_pairs(seed, V, N, T, RL, over_slope=False):
    """Pairs with the scorers' edge cases: empty templates, templates of
    exactly T and of more than T chars (truncated), homopolymer
    templates, empty reads, reads longer than their template, and
    (``over_slope``) reads many times longer than their template."""
    rng = np.random.default_rng(seed)
    tpl = rng.integers(0, 4, (V, T)).astype(np.uint8)
    tpl[::5] = 1  # homopolymers
    t_lens = rng.integers(1, T + 1, V).astype(np.int32)
    t_lens[::6] = 0
    t_lens[1::6] = T
    t_lens[2::6] = T + 1 + rng.integers(0, 5, len(t_lens[2::6]))
    reads = rng.integers(0, 4, (V, N, RL)).astype(np.uint8)
    r_lens = np.zeros((V, N), np.int32)
    for v in range(V):
        for n in range(N):
            kind = n % 4
            if kind == 0:
                r = _mutate(tpl[v, : min(t_lens[v], T)], rng, 0.15)
            elif kind == 1:
                r = np.zeros(0, np.uint8)
            elif kind == 2 and over_slope:
                r = np.concatenate([tpl[v, : min(t_lens[v], T)]] * 8)
            else:
                r = rng.integers(0, 4, int(rng.integers(1, RL + 1)))
            r = r[:RL]
            reads[v, n, : len(r)] = r
            r_lens[v, n] = len(r)
    return tpl, t_lens, reads, r_lens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("global_ends", [False, True])
def test_nw_dist_full_edge_cases_equal_jax(global_ends):
    """K3f's plain version against ``_nw_dist_full`` in both end modes:
    t_len 0 (INF), t_len = T, t_len > T (no row ends the template), rl
    0, homopolymers; a CPU tensor does not launch the kernel."""
    V, N, T, RL = 30, 8, 20, 40
    arrays = _edge_pairs(4, V, N, T, RL)
    ref = np.asarray(C._nw_dist_full(*map(jnp.asarray, arrays), T=T,
                                     global_ends=global_ends))
    n0 = K3.full_launches
    got = K3.nw_dist_full(*_torch(*arrays), T=T, global_ends=global_ends)
    assert K3.full_launches == n0, "a CPU tensor must not launch the kernel"
    assert got.dtype == torch.int32 and got.shape == (V, N)
    assert (ref < C._INF).any() and (ref == C._INF).any()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("W", [16, 17, 64, 65])
@pytest.mark.parametrize("global_ends", [False, True])
def test_banded_nw_dist_equals_jax(W, global_ends):
    """K3b's plain version against ``_banded_nw_dist``: W even and odd
    (``-W // 2`` is floor division), reads longer than the band, reads
    many times longer than their template (the band offset clips), rl 0,
    t_len 0 and t_len > T; a CPU tensor does not launch the kernel."""
    V, N, T, RL = 24, 8, 24, 160
    arrays = _edge_pairs(10 + W, V, N, T, RL, over_slope=True)
    ref = np.asarray(C._banded_nw_dist(*map(jnp.asarray, arrays), T=T, W=W,
                                       global_ends=global_ends))
    n0 = K3.banded_launches
    got = K3.banded_nw_dist(*_torch(*arrays), T=T, W=W,
                            global_ends=global_ends)
    assert K3.banded_launches == n0, "a CPU tensor must not launch the kernel"
    assert got.dtype == torch.int32 and got.shape == (V, N)
    assert (ref < C._INF).any() and (ref == C._INF).any()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_general_scorers_reject_unsupported_shapes():
    V, N, T = 2, 3, 8
    tpl = torch.zeros((V, T), dtype=torch.uint8)
    tl = torch.full((V,), T, dtype=torch.int32)
    rls = torch.ones((V, N), dtype=torch.int32)
    with pytest.raises(KernelError):  # reads longer than 127 chars
        K3.nw_dist_full(tpl, tl, torch.zeros((V, N, 128), dtype=torch.uint8),
                        rls, T=T, global_ends=False)
    with pytest.raises(KernelError):  # a band wider than 256 cells
        K3.banded_nw_dist(tpl, tl, torch.zeros((V, N, 16), dtype=torch.uint8),
                          rls, T=T, W=257, global_ends=False)
    with pytest.raises(KernelError):  # int64 lengths
        K3.nw_dist_full(tpl, tl.long(), torch.zeros((V, N, 16), dtype=torch.uint8),
                        rls, T=T, global_ends=True)


# ----------------------------------------------------------------------
# K3/K3p's bit-vector design, modelled in numpy: the read as bit planes,
# each template row one word step of Myers's algorithm (Hyyrö's
# formulation with the top row anchored, D[i][0] = i) on ⌈RW/64⌉ uint64
# words.  The model follows ``csrc/nw_dist.cu`` step by step, decode
# included, and lies on no path of the package.

_M32 = np.uint64(0xFFFFFFFF)


def _codes16(packed, v, k):
    """16 codes of packed rows ``v`` from code ``k`` on, code k in bits
    31..30; codes past the row read as 0 (``codes16<true>``)."""
    n_bytes = packed.shape[1]
    b = k >> 2
    x = np.zeros(k.shape, np.uint64)
    for q in range(5):
        idx = b + q
        byte = np.where(idx < n_bytes, packed[v, np.minimum(idx, n_bytes - 1)], 0)
        x = (x << np.uint64(8)) | byte.astype(np.uint64)
    return (x >> (8 - 2 * (k & 3)).astype(np.uint64)) & _M32


def _planes16(w):
    """``planes16``: bit-reverse, then unshuffle, so bit j of the low half
    is code j's high bit and bit j of the high half its low bit."""
    x = np.zeros_like(w)
    for j in range(32):  # __brev
        x |= ((w >> np.uint64(j)) & np.uint64(1)) << np.uint64(31 - j)
    for s, m in ((1, 0x22222222), (2, 0x0C0C0C0C), (4, 0x00F000F0),
                 (8, 0x0000FF00)):
        s, m = np.uint64(s), np.uint64(m)
        t = (x ^ (x >> s)) & m
        x = x ^ t ^ (t << s)
    return x


def _k3_model(packed, meta, TW, TWp, RW, NB):
    """(2, V, NB) distances as K3p computes them, one slot per (v, nb)."""
    V = meta.shape[0]
    words = 1 if RW <= 64 else 2
    u = lambda a: np.uint64(a)
    v = np.repeat(np.arange(V), NB)
    nb = np.tile(np.arange(NB), V)
    rl = meta[v, 2 + nb].astype(np.int64)
    hi = [np.zeros(V * NB, np.uint64) for _ in range(words)]
    lo = [np.zeros(V * NB, np.uint64) for _ in range(words)]
    for c in range(4 * words):  # only groups that start inside the read
        x = np.where(16 * c < rl, _planes16(_codes16(packed, v, 2 * TWp + nb * RW
                                                     + 16 * c)), u(0))
        hi[c // 4] |= (x & u(0xFFFF)) << u(16 * (c % 4))
        lo[c // 4] |= (x >> u(16)) << u(16 * (c % 4))
    ones = u(0xFFFFFFFFFFFFFFFF)
    out = np.full((2, V * NB), C._INF, np.int64)
    for half in (0, 1):
        tl = meta[v, half].astype(np.int64)
        pv = [np.full(V * NB, ones) for _ in range(words)]
        mv = [np.zeros(V * NB, np.uint64) for _ in range(words)]
        for i in range(min(TW, max(int(tl.max()), 0))):
            if i % 16 == 0:
                w = _codes16(packed, v, half * TWp + i + 0 * v)
            k = i % 16  # the code's bits, each spread over a word
            b1 = np.where((w >> u(31 - 2 * k)) & u(1), ones, u(0))
            b0 = np.where((w >> u(30 - 2 * k)) & u(1), ones, u(0))
            live = i < tl
            carry = np.zeros(V * NB, np.uint64)
            ph_in, mh_in = np.ones(V * NB, np.uint64), np.zeros(V * NB, np.uint64)
            for q in range(words):
                eq = ~(hi[q] ^ b1) & ~(lo[q] ^ b0)
                xv = eq | mv[q]
                a = eq & pv[q]
                s = a + pv[q]
                c1 = (s < a).astype(np.uint64)
                s2 = s + carry
                carry = c1 | (s2 < s).astype(np.uint64)
                xh = (s2 ^ pv[q]) | eq
                ph = mv[q] | ~(xh | pv[q])
                mh = pv[q] & xh
                ph_s, ph_in = (ph << u(1)) | ph_in, ph >> u(63)
                mh_s, mh_in = (mh << u(1)) | mh_in, mh >> u(63)
                pv[q] = np.where(live, mh_s | ~(xv | ph_s), pv[q])
                mv[q] = np.where(live, ph_s & xv, mv[q])
        d = tl.copy()
        for q in range(words):  # D[tl][rl] = tl + the read's vertical deltas
            n = np.clip(rl - 64 * q, 0, 64)
            mask = np.where(n >= 64, ones, (u(1) << n.astype(np.uint64)) - u(1))
            d += (np.bitwise_count(pv[q] & mask).astype(np.int64)
                  - np.bitwise_count(mv[q] & mask).astype(np.int64))
        ok = (tl >= 1) & (tl <= TW) & (rl >= 0) & (rl <= RW)
        out[half] = np.where(ok, np.where(rl == 0, tl, d), C._INF)
    return out.reshape(2, V, NB).astype(np.int32)


#: read lengths at the kernel's word edges (kept where RW allows)
_EDGE_RLS = (0, 1, 47, 48, 63, 64, 65, 126, 127)


def _k3_edge_rows(seed, TW, TWp, RW, NB, V):
    """[base window | edited window | NB segments] rows and their meta at
    K3's edges: window lengths 0, 1, TW, TW + 1 and -1 among ordinary
    ones; read lengths on the word edges, RW, RW + 1 and -1; random,
    homopolymer and tandem windows; reads that are noisy copies of the
    window repeated to their length, homopolymers, tandem repeats or
    random; random codes past every length."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 4, (V, 2 * TWp + NB * RW)).astype(np.uint8)
    meta = np.zeros((V, 2 + NB), np.int32)
    tls = [0, 1, TW, TW + 1, -1]
    rls = [r for r in _EDGE_RLS if r < RW] + [RW, RW + 1, -1]
    for v in range(V):
        kind = v % 3
        if kind == 0:
            w = rng.integers(0, 4, TW).astype(np.uint8)
        elif kind == 1:
            w = np.full(TW, v % 4, np.uint8)
        else:
            w = np.resize(rng.integers(0, 4, int(rng.integers(2, 5))), TW).astype(np.uint8)
        e = w.copy()
        e[TW // 2] = (e[TW // 2] + 1) % 4
        buf[v, :TW], buf[v, TWp : TWp + TW] = w, e
        meta[v, :2] = [tls[(v + k) % 5] if v < 10 else int(rng.integers(1, TW + 1))
                       for k in (0, 2)]
        for nb in range(NB):
            rl = rls[(v + nb) % len(rls)] if (v + nb) % 4 else int(rng.integers(0, RW + 1))
            n = min(max(rl, 0), RW)
            rk = (v + nb) % 4
            if rk == 0:
                r = _mutate(np.resize(w, n + 8), rng, 0.13)
            elif rk == 1:
                r = np.full(n, nb % 4, np.uint8)
            elif rk == 2:
                r = np.resize(w[:3], n)
            else:
                r = rng.integers(0, 4, n)
            r = np.resize(np.asarray(r, np.uint8), n)
            buf[v, 2 * TWp + nb * RW : 2 * TWp + nb * RW + n] = r
            meta[v, 2 + nb] = rl
    return buf, meta


#: (TW, TWp, RW, NB): one word (RW ≤ 64) and two, the main path's shape,
#: windows of 1 and 100 chars, and odd TWp and RW (rows whose windows and
#: segments start inside a packed byte)
_K3_SHAPES = [(1, 4, 48, 12), (34, 36, 48, 12), (34, 37, 63, 14),
              (34, 36, 65, 12), (100, 101, 127, 14), (1, 1, 127, 2)]


@pytest.mark.parametrize("TW,TWp,RW,NB", _K3_SHAPES)
def test_k3_word_model_equals_jax(TW, TWp, RW, NB):
    """The numpy model of K3/K3p's word step against
    ``_nw_dist_pair_packed`` and ``_nw_dist_full(global_ends=True)`` on
    the same rows, at the length edges (tolerance 0)."""
    V = 15
    buf, meta = _k3_edge_rows(TW * 1000 + RW, TW, TWp, RW, NB, V)
    packed = _pack2bit(buf)
    ref = np.asarray(C._nw_dist_pair_packed(jnp.asarray(packed),
                                            jnp.asarray(meta), TW=TW, TWp=TWp,
                                            RW=RW, NB=NB))
    rw = buf[:, 2 * TWp :].reshape(V, NB, RW)
    full = np.asarray(C._nw_dist_full(
        jnp.asarray(np.concatenate([buf[:, :TW], buf[:, TWp : TWp + TW]])),
        jnp.asarray(np.concatenate([meta[:, 0], meta[:, 1]])),
        jnp.asarray(np.concatenate([rw, rw])),
        jnp.asarray(np.concatenate([meta[:, 2:], meta[:, 2:]])), T=TW,
        global_ends=True)).reshape(2, V, NB)
    np.testing.assert_array_equal(full, ref)
    assert (ref < C._INF).sum() > V * NB // 4 and (ref == C._INF).any()
    np.testing.assert_array_equal(_k3_model(packed, meta, TW, TWp, RW, NB), ref)


@pytest.mark.parametrize("TW,TWp,RW,NB", _K3_SHAPES)
def test_nw_dist_pairs_edges_equal_jax(TW, TWp, RW, NB):
    """The plain K3 and K3p against ``_nw_dist_pair_packed`` at windows
    longer than TW, negative lengths, reads longer than RW and the word
    edges; a CPU tensor launches neither kernel."""
    V = 15
    buf, meta = _k3_edge_rows(TW * 1000 + RW + 1, TW, TWp, RW, NB, V)
    packed = _pack2bit(buf)
    ref = np.asarray(C._nw_dist_pair_packed(jnp.asarray(packed),
                                            jnp.asarray(meta), TW=TW, TWp=TWp,
                                            RW=RW, NB=NB))
    n0 = (K3.launches, K3.packed_launches)
    got = K3.nw_dist_pairs(*_torch(buf, meta), TW=TW, TWp=TWp, RW=RW, NB=NB)
    got_p = K3.nw_dist_pairs_packed(*_torch(packed, meta), TW=TW, TWp=TWp,
                                    RW=RW, NB=NB)
    assert (K3.launches, K3.packed_launches) == n0
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got_p.numpy(), ref)


# ----------------------------------------------------------------------
# K3b's warp layout, modelled in numpy: one warp per (v, n) pair, band
# cell p in register k = p >> 5 of lane p & 31.  A row's shift s = off(i)
# - off(i-1) splits into a register move by s >> 5 and a lane rotation by
# s & 31; the closure is an inclusive min-scan of each register (five
# shuffles up) and the carry of the lower registers' totals.  The model
# follows ``banded_nw_dist_kernel`` in ``csrc/nw_dist.cu`` step by step
# and lies on no path of the package.

_INT_MAX = (1 << 31) - 1


def _band_off(i, tl, rl, W):
    """Read column of band cell 0 on row ``i`` (``band_off``)."""
    c = (i * rl) // np.maximum(tl, 1)
    return np.minimum(np.maximum(c - W // 2, -W // 2), np.maximum(rl - W // 2, 0))


def _k3b_model(tpl, t_lens, reads, r_lens, T, W, global_ends, carry=True):
    """(V, N) distances as K3b computes them, one warp per pair."""
    V, N, RL = reads.shape
    K, P, INF = -(-W // 32), V * N, C._INF
    lane = np.arange(32)
    p = np.arange(K)[:, None] * 32 + lane  # (K, 32): cell of (register, lane)
    v = np.repeat(np.arange(V), N)
    tl = t_lens[v].astype(np.int64)
    rl = r_lens.reshape(-1).astype(np.int64)
    rl3 = rl[:, None, None]
    rd = reads.reshape(P, RL).astype(np.int64)
    pairs = np.arange(P)[:, None, None]

    def cells_ok(j):
        return (p < W) & (j >= 0) & (j <= rl3)

    off = _band_off(0, tl, rl, W)
    j = off[:, None, None] + p
    D = np.where(cells_ok(j), j if global_ends else 0, INF)
    best = np.full(P, INF, np.int64)
    rows = np.minimum(tl, T)
    for i in range(1, int(rows.max(initial=0)) + 1):
        live = i <= rows
        off_i = _band_off(i, tl, rl, W)
        s = np.clip(off_i - off, -1024, 1024)
        a, b = s >> 5, s & 31
        # the lane rotation: X[k] = shfl(D[k], (lane + b) & 31)
        src = (lane + b[:, None]) & 31
        X = np.take_along_axis(D, np.broadcast_to(src[:, None, :], D.shape), 2)
        full = np.full((P, 1, 32), INF)
        Xp = np.concatenate([full, X, full], axis=1)  # X[-1 .. K]
        # Y[m] = D_prev[32 m + lane + b], m in [-1, K): the wrap lanes
        # take the next register's rotated value
        wrap = (lane + b[:, None] >= 32)[:, None, :]
        Y = np.where(wrap, Xp[:, 1:], Xp[:, :-1])
        # the register move: E[k] = Y[k + a] = D_prev[p + s], k in [-1, K)
        m = np.arange(K + 1) + a[:, None]
        E = np.where(((m >= 0) & (m <= K))[:, :, None],
                     np.take_along_axis(Y, np.clip(m, 0, K)[:, :, None]
                                        .repeat(32, 2), 1), INF)
        # E1[k] = D_prev[p + s - 1]: one shuffle from lane - 1, lane 0
        # taking lane 31 of the register below (E[-1] for k = 0)
        E1 = np.where(lane == 31, E[:, :-1], E[:, 1:])[:, :, (lane - 1) & 31]
        j = off_i[:, None, None] + p
        r_ch = rd[pairs, np.clip(j - 1, 0, RL - 1)]
        t_ch = tpl[v, i - 1].astype(np.int64)[:, None, None]
        diag = np.where(j >= 1, E1 + (r_ch != t_ch), INF)
        up = E[:, 1:] + 1
        if not global_ends:
            up = np.where(j == 0, np.minimum(up, 0), up)
        u = np.minimum(diag, up) - p
        for d in (1, 2, 4, 8, 16):  # shfl_up; lanes below d keep theirs
            u = np.where(lane >= d, np.minimum(u, np.roll(u, d, axis=2)), u)
        if carry:  # the minimum of the lower registers' totals (lane 31)
            tot = np.concatenate([np.full((P, 1), _INT_MAX), u[:, :-1, 31]], 1)
            u = np.minimum(u, np.minimum.accumulate(tot, axis=1)[:, :, None])
        Dn = np.where(cells_ok(j), np.minimum(u + p, INF), INF)
        if not global_ends:  # the read's end on any row
            at_end = np.where(j == rl3, Dn, INF).min(axis=(1, 2))
            best = np.where(live, np.minimum(best, at_end), best)
        D = np.where(live[:, None, None], Dn, D)
        off = np.where(live, off_i, off)
    # row t_len, where the loop ended on it: the read's end (global) or
    # the row's minimum (free-shift: the template's end anywhere)
    j = off[:, None, None] + p
    last = (np.where(j == rl3, D, INF) if global_ends else D).min(axis=(1, 2))
    best = np.where((rows == tl) & (tl >= 1), np.minimum(best, last), best)
    return best.reshape(V, N).astype(np.int32)


def _steep_pairs(seed, V, N, T, RL):
    """Pairs whose band moves by more than a warp's 32 cells a row:
    templates of 1 to 12 chars against reads of up to RL chars that
    repeat them with 10 % noise (rl >> t_len), among templates of T and
    more than T chars, t_len 0, rl 0 and random reads."""
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


@pytest.mark.parametrize("W", [1, 31, 32, 33, 64, 65, 256])
@pytest.mark.parametrize("global_ends", [False, True])
def test_k3b_warp_model_equals_jax(W, global_ends):
    """The numpy model of K3b's warp layout against ``_banded_nw_dist``
    (tolerance 0), on pairs whose band shifts by more than 32 cells in a
    row (a register move) and by less (a lane rotation alone)."""
    V, N, T, RL = 20, 8, 24, 700
    arrays = _steep_pairs(W + 100 * global_ends, V, N, T, RL)
    tpl, t_lens, reads, r_lens = arrays
    tl = t_lens[:, None].astype(np.int64)
    offs = np.stack([_band_off(i, tl, r_lens.astype(np.int64), W)
                     for i in range(T + 1)])
    live = np.arange(1, T + 1)[:, None, None] <= np.minimum(tl, T)
    s = np.diff(offs, axis=0)[np.broadcast_to(live, offs[1:].shape)]
    assert (s > 32).any() and ((s > 0) & (s < 32)).any()
    ref = np.asarray(C._banded_nw_dist(*map(jnp.asarray, arrays), T=T, W=W,
                                       global_ends=global_ends))
    # a one-cell band stays on the diagonal only where rl = t_len
    assert (ref < C._INF).sum() > (V * N // 4 if W > 1 else 4)
    assert (ref == C._INF).any()
    np.testing.assert_array_equal(
        _k3b_model(tpl, t_lens, reads, r_lens, T, W, global_ends), ref)


# ----------------------------------------------------------------------
# K3f's design, modelled in numpy: one thread per (v, n) pair, the read
# as eight bit planes of ⌈RL/32⌉ uint32 limbs, decoded from aligned
# 4-byte words by byte permutes and an 8 × 8 bit transpose; a warp whose
# read bytes are all < 4 compares two planes, any other eight; each
# template row one Myers/Hyyrö step with the add's carry and the shifts
# running across the limbs; global mode anchored, free-shift mode the
# search form with D[i][rl] kept from the horizontal deltas at column rl,
# and 0 wherever JAX's recurrence fixes it.  The model follows
# ``nw_dist_full_kernel`` in ``csrc/nw_dist.cu`` step by step and lies on
# no path of the package.

_U32 = np.uint64(0xFFFFFFFF)


def _byte_perm(x, y, sel):
    """``__byte_perm``: byte i of the result is byte ``sel``'s nibble i
    of the 8 bytes {y:x}."""
    out = np.zeros_like(x)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        src = x if k < 4 else y
        out |= ((src >> np.uint64(8 * (k & 3))) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out


def _planes32(flat, start, n_end):
    """``planes32``: the 8 planes of the 32 bytes at ``start`` in
    ``flat`` (one start per pair), bytes at and past ``n_end`` as 0."""
    a = start & ~3
    sh = ((start & 3) * 8).astype(np.uint64)
    x = []
    for m in range(9):  # aligned words holding a byte below n_end
        addr = a + 4 * m
        word = np.zeros(len(start), np.uint64)
        for q in range(4):
            word |= flat[addr + q].astype(np.uint64) << np.uint64(8 * q)
        x.append(np.where(addr < n_end, word, np.uint64(0)))
    b = [((x[m + 1] << np.uint64(32) | x[m]) >> sh) & _U32 for m in range(8)]
    pl = [None] * 8
    for h in (0, 1):
        for q in (0, 2):
            sel = q | (4 + q) << 4 | (q + 1) << 8 | (5 + q) << 12
            lo = _byte_perm(b[h], b[2 + h], sel)
            hi = _byte_perm(b[4 + h], b[6 + h], sel)
            pl[4 * h + q] = _byte_perm(lo, hi, 0x5410)
            pl[4 * h + q + 1] = _byte_perm(lo, hi, 0x7632)
    for d, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F)):
        d, m = np.uint64(d), np.uint64(m)
        for q in range(8):
            if q & int(d):
                continue
            t = ((pl[q] >> d) ^ pl[q + int(d)]) & m
            pl[q + int(d)] = pl[q + int(d)] ^ t
            pl[q] = (pl[q] ^ (t << d)) & _U32
    left = np.clip(n_end - start, 0, 32).astype(np.uint64)
    keep = (np.uint64(1) << left) - np.uint64(1)
    return [p & keep for p in pl]


def _k3f_model(tpl, t_lens, reads, r_lens, T, global_ends, align=0,
               carry=True):
    """(V, N) distances as K3f computes them, one thread per pair, and
    each pair's plane count (2, 8, or 0 where it walks no row).
    ``align``: the reads' first byte's offset from a 4-byte boundary;
    ``carry=False`` drops what crosses a limb boundary (the add's carry,
    the shifts' top bits)."""
    V, N, RL = reads.shape
    P, limbs = V * N, max(1, -(-RL // 32))
    u = np.uint64
    g = np.arange(P)
    v = g // N
    tl = t_lens[v].astype(np.int64)
    rl = r_lens.reshape(-1).astype(np.int64)
    # the reads at byte address align + g * RL, garbage around them
    flat = np.concatenate([np.full(align, 0xA5, np.uint8), reads.reshape(-1),
                           np.full(40, 0xA5, np.uint8)])
    d = np.full(P, C._INF, np.int64)
    if global_ends:
        ok = (tl >= 1) & (tl <= T) & (rl >= 0) & (rl <= RL)
        d = np.where(ok, tl, d)
        walk = ok & (rl > 0)
        rows = tl
    else:
        ok = (tl >= 1) & (rl >= 0)
        d = np.where(ok & (tl <= T), 0, d)
        past = ok & (tl > T) & (rl <= RL) & (T >= 1)
        d = np.where(past, 0, d)
        walk = past & (rl > 0)
        rows = np.full(P, T)
    pl = np.zeros((8, limbs, P), np.uint64)
    for l in range(limbs):
        x = _planes32(flat, align + g * RL + 32 * l, align + g * RL + rl)
        for b in range(8):
            pl[b, l] = np.where(walk & (32 * l < rl), x[b], u(0))
    # the warp's vote; lanes past the last pair vote yes
    high = np.bitwise_or.reduce(pl[2:].reshape(-1, P), axis=0)
    high = np.concatenate([high, np.zeros(-P % 32, np.uint64)])
    codes = np.repeat((high.reshape(-1, 32) == 0).all(1), 32)[:P]
    ones = u(0xFFFFFFFF)
    pv = np.full((limbs, P), ones if global_ends else u(0))
    mv = np.zeros((limbs, P), np.uint64)
    bit = rl - 1
    at = [np.where((bit >> 5) == l, u(1) << (bit & 31).clip(0).astype(np.uint64),
                   u(0)) for l in range(limbs)]
    score = np.zeros(P, np.int64)
    best = np.full(P, C._INF, np.int64)
    for i in range(int(rows[walk].max(initial=0))):
        live = walk & (i < rows)
        c = tpl[v, min(i, tpl.shape[1] - 1)].astype(np.uint64)
        s = [np.where((c >> u(b)) & u(1), ones, u(0)) for b in range(8)]
        small = np.where(c < 4, ones, u(0))
        eq = []
        for l in range(limbs):
            e2 = ~(pl[0, l] ^ s[0]) & ~(pl[1, l] ^ s[1]) & small & ones
            e8 = ones
            for b in range(8):
                e8 = e8 & ~(pl[b, l] ^ s[b])
            eq.append(np.where(codes, e2, e8 & ones))
        cy = np.zeros(P, np.uint64)
        ph_in = np.full(P, u(1 if global_ends else 0))
        mh_in = np.zeros(P, np.uint64)
        up = np.zeros(P, np.uint64)
        down = np.zeros(P, np.uint64)
        for l in range(limbs):
            if not carry:
                cy = np.zeros(P, np.uint64)
                if l:
                    ph_in = mh_in = np.zeros(P, np.uint64)
            tot = (eq[l] & pv[l]) + pv[l] + cy
            sl, cy = tot & ones, tot >> u(32)
            xh = (sl ^ pv[l]) | eq[l]
            ph = (mv[l] | ~(xh | pv[l])) & ones
            mh = pv[l] & xh
            up |= ph & at[l]
            down |= mh & at[l]
            ph_s = ((ph << u(1)) | ph_in) & ones
            mh_s = ((mh << u(1)) | mh_in) & ones
            ph_in, mh_in = ph >> u(31), mh >> u(31)
            xv = eq[l] | mv[l]
            pv[l] = np.where(live, (mh_s | ~(xv | ph_s)) & ones, pv[l])
            mv[l] = np.where(live, ph_s & xv, mv[l])
        score = np.where(live, score + (up != 0) - (down != 0), score)
        best = np.where(live, np.minimum(best, score), best)
    if global_ends:
        end = tl.copy()
        for l in range(limbs):
            n = np.clip(rl - 32 * l, 0, 32).astype(np.uint64)
            m = (u(1) << n) - u(1)
            end += (np.bitwise_count(pv[l] & m).astype(np.int64)
                    - np.bitwise_count(mv[l] & m).astype(np.int64))
    else:
        end = best
    d = np.where(walk, end, d)
    paths = np.where(walk, np.where(codes, 2, 8), 0)
    return d.reshape(V, N).astype(np.int32), paths.reshape(V, N)


def _jax_full(arrays, T, global_ends):
    return np.asarray(C._nw_dist_full(*map(jnp.asarray, arrays), T=T,
                                      global_ends=global_ends))


@pytest.mark.parametrize("RL", [1, 63, 64, 65, 127])
@pytest.mark.parametrize("global_ends", [False, True])
def test_k3f_word_model_equals_jax(RL, global_ends):
    """The numpy model of K3f's design against ``_nw_dist_full``
    (tolerance 0) in both end modes: one to four limbs, bytes 0..255
    and codes, reads at every alignment; warps of codes take the two
    planes (garbage bytes ≥ 4 past rl notwithstanding), the others
    eight; free-shift pairs walk rows only where t_len > T, and again
    with every t_len past T (the search form on every pair).  With the
    carry and shifts across limbs left out, the model is wrong."""
    V, N, T = 32, 8, 20
    arrays = k3f_pairs(RL * 10 + global_ends, V, N, T, RL)
    ref = _jax_full(arrays, T, global_ends)
    assert (ref < C._INF).sum() > V * N // 4 and (ref == C._INF).any()
    for align in (0, 1, 2, 3):
        got, paths = _k3f_model(*arrays, T, global_ends, align=align)
        np.testing.assert_array_equal(got, ref)
    walked = paths > 0
    assert (paths[:4][walked[:4]] == 2).all()  # the codes warp
    assert (paths[8:12][walked[8:12]] == 8).all()
    if RL > 1:
        assert (paths == 2).any() and (paths == 8).any()
    if not global_ends:
        assert (walked == (arrays[1] > T)[:, None] & (arrays[3] > 0)
                & (arrays[3] <= RL)).all()
        assert (ref[arrays[1] > T] > 0).any()
        # the search form on every pair: every template past T
        arrays = (arrays[0], arrays[1].clip(T + 1), *arrays[2:])
        ref = _jax_full(arrays, T, global_ends)
        got, paths = _k3f_model(*arrays, T, global_ends, align=RL % 4)
        np.testing.assert_array_equal(got, ref)
        assert (paths > 0).sum() > V * N // 3
    if RL > 32:  # the carry and shifts across limbs are needed
        bad, _ = _k3f_model(*arrays, T, global_ends, carry=False)
        assert (bad != ref).any()


def test_nw_dist_full_free_shift_premise():
    """JAX's free-shift ``_nw_dist_full`` is 0 for every pair with
    1 <= t_len <= T and rl >= 0 (rl up to RL + 5), whatever the bytes:
    row t_len's minimum takes D[t_len][0] = 0.  Past T it is not always
    0: the minimum over rows 1..T of D[i][rl]."""
    V, N, T, RL = 32, 8, 20, 65
    tpl, t_lens, reads, r_lens = k3f_pairs(7, V, N, T, RL)
    rng = np.random.default_rng(8)
    r_lens = rng.integers(0, RL + 6, (V, N)).astype(np.int32)
    ref = _jax_full((tpl, t_lens, reads, r_lens), T, False)
    inside = (t_lens >= 1) & (t_lens <= T)
    assert inside.sum() > V // 2 and (t_lens > T).any()
    assert (ref[inside] == 0).all()
    assert (ref[t_lens > T] > 0).any()
    assert (ref[t_lens < 1] == C._INF).all()


@pytest.mark.parametrize("global_ends", [False, True])
def test_nw_dist_full_bytes_equal_jax(global_ends):
    """K3f's plain version on bytes 0..255 (and bytes that differ from
    each other in high bits alone) against ``_nw_dist_full``, at K3f's
    length edges; a CPU tensor does not launch the kernel."""
    V, N, T, RL = 32, 8, 20, 65
    arrays = k3f_pairs(9 + global_ends, V, N, T, RL)
    assert (arrays[2] >= 4).any() and (arrays[0] >= 4).any()
    ref = _jax_full(arrays, T, global_ends)
    n0 = K3.full_launches
    got = K3.nw_dist_full(*_torch(*arrays), T=T, global_ends=global_ends)
    assert K3.full_launches == n0
    np.testing.assert_array_equal(got.numpy(), ref)
