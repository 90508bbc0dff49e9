"""K3 (``dentist_tpu_torch.ops.nw_dist``) against the JAX polish scorer.

Seeded numpy (template, read) pairs go through
``_nw_dist_full(global_ends=True)`` and ``_nw_dist_pair_packed``
(``jax.jit`` on the CPU backend) and through the port's functions on CPU
tensors (the plain PyTorch version).  Integer DP: tolerance 0.
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
