"""K2 (``dentist_tpu_torch.ops.nw_round``) against ``_nw_round_parts``.

Seeded numpy lanes — mutated copies of a template, homopolymer and
tandem-repeat lanes full of ties (first argmin over rows, diag > up >
left), reads longer than the band can follow, empty reads — go through
the JAX function (``jax.jit`` on the CPU backend) and through the port's
wrapper on CPU tensors, which runs the plain PyTorch version.  All seven
outputs must be bit-equal (integer DP: tolerance 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dentist_tpu.ops import consensus as C
from dentist_tpu.sim.reads import _mutate
from dentist_tpu_torch.errors import KernelError
from dentist_tpu_torch.ops import nw_round as K2

_jax_round = jax.jit(C._nw_round_parts,
                     static_argnames=("T", "W", "S", "NWIN", "lead_free"))


def _full_lanes(seed, T, N):
    """Full-round lanes: (template, read) pairs padded to T / 2T, band
    centers from the slope-1 clamp the host uses for first rounds."""
    rng = np.random.default_rng(seed)
    RL = 2 * T
    tpl = np.zeros((N, T), np.uint8)
    reads = np.zeros((N, RL), np.uint8)
    t_lens = np.ones(N, np.int32)
    r_lens = np.zeros(N, np.int32)
    for n in range(N):
        kind = n % 6
        L = int(rng.integers(T // 2, T + 1))
        if kind == 0:  # homopolymer template, homopolymer read
            t = np.zeros(L, np.uint8)
            r = np.zeros(int(L * rng.uniform(0.8, 1.1)), np.uint8)
        elif kind == 1:  # short tandem unit: many equal-cost paths
            unit = rng.integers(0, 4, 3).astype(np.uint8)
            t = np.tile(unit, L // 3 + 1)[:L]
            r = _mutate(t, rng, 0.15)
        elif kind == 2:  # read starting inside the template (free prefix)
            t = rng.integers(0, 4, L).astype(np.uint8)
            r = _mutate(t[L // 3 :], rng, 0.13)
        elif kind == 3:  # read far longer than the template: uncovered
            t = rng.integers(0, 4, L // 4).astype(np.uint8)
            r = rng.integers(0, 4, RL).astype(np.uint8)
        elif kind == 4:  # empty read
            t = rng.integers(0, 4, L).astype(np.uint8)
            r = np.zeros(0, np.uint8)
        else:
            t = rng.integers(0, 4, L).astype(np.uint8)
            r = _mutate(t, rng, 0.13)
        r = r[:RL]
        tpl[n, : len(t)] = t
        t_lens[n] = len(t)
        reads[n, : len(r)] = r
        r_lens[n] = len(r)
    centers = C._make_centers(T, r_lens.astype(np.int64), None)
    return tpl, t_lens, reads, r_lens, centers


def _window_lanes(seed, N):
    """Windowed-round lanes: 192-row windows, 384-char segments, the
    host's proportional centers (steps clipped to 0..2)."""
    rng = np.random.default_rng(seed)
    T, RL = C._WS, C._SEG
    tpl = np.zeros((N, T), np.uint8)
    reads = np.zeros((N, RL), np.uint8)
    t_lens = np.zeros(N, np.int32)
    s_lens = np.zeros(N, np.int32)
    for n in range(N):
        L = int(rng.integers(100, T + 1))
        t = (np.zeros(L, np.uint8) if n % 5 == 0
             else rng.integers(0, 4, L).astype(np.uint8))
        r = _mutate(t, rng, 0.13)
        lead = rng.integers(0, 4, int(rng.integers(0, 9))).astype(np.uint8)
        r = np.concatenate([lead, r])[:RL]
        tpl[n, :L] = t
        t_lens[n] = L
        reads[n, : len(r)] = r
        s_lens[n] = len(r)
    rows = np.arange(T + 1, dtype=np.int32)
    tl = np.maximum(t_lens[:, None], 1)
    cen = (np.minimum(rows[None, :], tl) * s_lens[:, None]) // tl
    steps = np.diff(cen, axis=1).clip(0, 2)
    centers = np.concatenate([np.zeros((N, 1), np.int64),
                              np.cumsum(steps, axis=1)], axis=1).T
    return tpl, t_lens, reads, s_lens, centers.astype(np.int32)


def _compare(tpl, t_lens, reads, r_lens, centers, T, W, S, NWIN, lead_free):
    ref = _jax_round(jnp.asarray(np.ascontiguousarray(tpl.T)),
                     jnp.asarray(t_lens), jnp.asarray(reads),
                     jnp.asarray(r_lens), jnp.asarray(centers), T=T, W=W, S=S,
                     NWIN=NWIN, lead_free=lead_free)
    launches = K2.launches
    got = K2.nw_round(torch.from_numpy(np.ascontiguousarray(tpl.T)),
                      torch.from_numpy(t_lens), torch.from_numpy(reads),
                      torch.from_numpy(r_lens), torch.from_numpy(centers),
                      T=T, W=W, S=S, NWIN=NWIN, lead_free=lead_free)
    assert K2.launches == launches, "a CPU tensor must not launch the kernel"
    names = ("sym", "ins", "jpath", "spans", "diffs", "win", "covered")
    for name, r, g in zip(names, ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert r.dtype == g.dtype, (name, r.dtype, g.dtype)
        np.testing.assert_array_equal(g, r, err_msg=name)
    return [np.asarray(r) for r in ref]


@pytest.mark.parametrize("seed", [1, 2])
def test_full_round_equals_jax(seed):
    T, N, W = 512, 12, 128
    lanes = _full_lanes(seed, T, N)
    ref = _compare(*lanes, T=T, W=W, S=3 * T, NWIN=C.TB_nwin(T),
                   lead_free=-1)
    cov = ref[6]
    assert cov.sum() >= N // 2 and not cov.all(), "need covered and uncovered lanes"


def test_window_round_equals_jax():
    N = 24
    lanes = _window_lanes(3, N)
    ref = _compare(*lanes, T=C._WS, W=128, S=C._WS + C._SEG,
                   NWIN=max(C.TB_nwin(C._WS), 1), lead_free=2 * C._LEAD_SLACK)
    assert ref[6].all()


def test_proportional_retry_centers_equal_jax():
    """The full round's proportional-center retry shape."""
    T, N = 512, 6
    tpl, t_lens, reads, r_lens, _ = _full_lanes(4, T, N)
    centers = C._prop_centers(T, r_lens.astype(np.int64))
    _compare(tpl, t_lens, reads, r_lens, centers, T=T, W=128, S=3 * T,
             NWIN=C.TB_nwin(T), lead_free=-1)


def test_nw_round_rejects_bad_shapes():
    tpl, t_lens, reads, r_lens, centers = _full_lanes(5, 64, 2)
    with pytest.raises(KernelError):
        K2.nw_round(torch.from_numpy(tpl), torch.from_numpy(t_lens),
                    torch.from_numpy(reads), torch.from_numpy(r_lens),
                    torch.from_numpy(centers), T=64, W=128, S=192, NWIN=1)
