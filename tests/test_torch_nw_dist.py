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
