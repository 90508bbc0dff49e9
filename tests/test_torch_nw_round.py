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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("seed,T,W", [
    pytest.param(1, 512, 128, id="1"), pytest.param(2, 512, 128, id="2"),
    # band widths below the consensus band's 128, none a multiple of 32
    # but 16: the card kernel pads them with unreachable cells
    *[pytest.param(3, 256, W, id=f"T256-W{W}") for W in (16, 48, 100)]])
def test_full_round_equals_jax(seed, T, W):
    N = 12
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


def _k2_modes(W, T=64, N=2):
    """Calls of K2, K2p and K2r at band width W on small CPU lanes."""
    tpl, t_lens, reads, r_lens, centers = _full_lanes(6, T, N)
    RL = reads.shape[1]
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (tpl.T, t_lens, reads, r_lens, centers)]
    chars = torch.zeros((N, (2 * T + RL) // 4), dtype=torch.uint8)
    meta3 = torch.stack([args[1], args[3], args[4][0]])
    store = torch.zeros(4 * (T + RL), dtype=torch.uint8)
    meta5 = torch.zeros((5, N), dtype=torch.int32)
    kw = dict(W=W, S=T + RL, NWIN=1)
    return {"K2": lambda: K2.nw_round(*args, T=T, **kw),
            "K2p": lambda: K2.nw_round_packed(chars, meta3, T=T, RL=RL, **kw),
            "K2r": lambda: K2.nw_round_resident(store, meta5, T=T, RL=RL, **kw)}


@pytest.mark.parametrize("W", [0, 1025])
@pytest.mark.parametrize("mode", ["K2", "K2p", "K2r"])
def test_nw_round_rejects_bad_widths(mode, W):
    """Every mode takes 1 <= W <= 1024 (the card kernel keeps the band
    in registers) and refuses the widths outside."""
    with pytest.raises(KernelError, match="unsupported shape"):
        _k2_modes(W)[mode]()


@pytest.mark.parametrize("mode", ["K2", "K2p", "K2r"])
def test_nw_round_takes_every_width_up_to_1024(mode):
    for W in (1, 33, 1024):
        out = _k2_modes(W)[mode]()
        assert len(out) == 7


def _route_job(seed=7):
    """One job of ``tests/test_sparse_transport.py``'s read sets (a
    700-char truth, 9 reads at 13 % error), with the previous round's
    path: the windowed route takes it unless told otherwise."""
    rng = np.random.default_rng(seed)
    truth = np.asarray(rng.integers(0, 4, 700), dtype=np.uint8)
    reads = [_mutate(truth, rng, 0.13) for _ in range(9)]
    template = reads[4]
    [base] = C._run_round([C._ConsJob(template, reads)], 128)
    return template, reads, base.jpath


def test_no_windowed_switch_takes_the_full_round_as_jax(monkeypatch):
    """``DENTIST_TPU_NO_WINDOWED`` sends a job that has a previous path
    through the full banded round, in the port as in JAX: the seven
    fields are equal and the port's windowed route is never entered."""
    from dentist_tpu_torch.device import set_device
    from dentist_tpu_torch.ops import consensus as PC

    set_device("cpu")
    template, reads, jpath = _route_job()
    taken = []

    def windowed(*args, **kwargs):
        taken.append("windowed")
        raise AssertionError("the windowed route was entered")

    full = PC._run_round_full

    def full_round(*args, **kwargs):
        taken.append("full")
        return full(*args, **kwargs)

    monkeypatch.setattr(PC, "_run_round_windowed", windowed)
    monkeypatch.setattr(PC, "_run_round_full", full_round)
    job = PC._ConsJob(template, reads, jpath)
    with pytest.raises(AssertionError, match="windowed route"):
        PC._run_round([job], 128)  # without the switch: windowed
    taken.clear()
    monkeypatch.setenv("DENTIST_TPU_NO_WINDOWED", "1")
    [want] = C._run_round([C._ConsJob(template, reads, jpath)], 128)
    [got] = PC._run_round([job], 128)
    assert taken == ["full"]
    for name in ("sym", "ins", "jpath", "spans", "diffs", "win", "covered"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)


def test_windowed_round_refuses_bands_above_128():
    """JAX asserts W <= 128 in its windowed rounds (byte-packed jpath
    offsets); the port refuses W = 129 there and takes W = 128."""
    from dentist_tpu_torch.device import set_device
    from dentist_tpu_torch.ops import consensus as PC

    set_device("cpu")
    template, reads, jpath = _route_job()
    with pytest.raises(AssertionError):
        C._run_round([C._ConsJob(template, reads, jpath)], 129)
    with pytest.raises(KernelError, match="W <= 128"):
        PC._run_round([PC._ConsJob(template, reads, jpath)], 129)
