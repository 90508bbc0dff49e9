"""K4's event slots as the CUDA kernel assigns them, held against the JAX
package's sparse blocks at the caps' edges.

``csrc/round_pack.cu`` gives a lane one CTA of T/4 threads (32 to 1024),
each holding 4 columns of a tile of 4 x threads columns, or, where a
launch leaves SMs idle, a cluster of up to 8 CTAs, each one tile of
T / CTAs columns; warp w of a tile owns its contiguous run of 128
columns from 128 w on.  An event's slot is the exclusive scan of the
warps' event counts across the block, carried from tile to tile (from
the lower ranks' totals in a cluster), plus its rank in its warp's run;
insertion boundary T comes after every tile; events at or past their cap
are dropped.  :func:`kernel_slots` models that assignment in numpy and
:func:`model_block` builds the whole sparse block with it.  The block
must equal the JAX package's (``_nw_round_packed_sparse``, its realign
round ``_nw_round_parts`` swapped for crafted fields while it is
traced), word for word, and so must the port's plain version
(``round_pack_reference``), on lanes with event counts at each cap and
one above it, events only in a lane's last warp run, an insertion at
boundary T, jpath deltas of 14 and 15, uncovered lanes and cut spans, at
T = 256 (the smallest bucket, two warps), 2048 (sixteen warps), 8192 and
12288 (four and three tiles, or clusters of four and six CTAs).  A model
whose scan is off by one must fail.  The windowed rows (caps 32 / 24 /
4) are held the same way: the plain ``window_pack_reference`` against
JAX's ``_window_sparse_pack``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dentist_tpu.ops import consensus as C
from dentist_tpu_torch.ops import round_pack as RP
from dentist_tpu_torch.ops.pack2 import pack2bit

COLS = 4            # columns a thread holds (kCols)
MAX_THREADS = 1024  # threads of a lane's CTA (kMaxThreads)
MAX_CLUSTER = 8     # CTAs of a lane's cluster (kMaxCluster)
SMS = 132           # an H100's SMs
TS = (256, 2048, 8192, 12288)


def cluster_ctas(T, N, sms=SMS):
    """The CTAs ``dentist_round_pack`` spreads a lane over: the most, up
    to 8, that split T into whole 256-column parts of 2048 to 4096
    columns, N clusters of them fitting the SMs; else 1."""
    for c in range(MAX_CLUSTER, 1, -1):
        if ((T // 256) % c == 0 and 2048 <= T // c <= COLS * MAX_THREADS
                and N * c <= sms):
            return c
    return 1


def kernel_slots(ev, payload, cap, T, ctas=1, inclusive=False):
    """The kernel's compaction of the events ``ev`` (N, T), or (N, T + 1)
    with boundary T last: ``(slots (N, cap), count (N,))`` as JAX's
    ``_scatter_events`` returns them.  ``ctas`` > 1: the lane spread over
    a cluster.  ``inclusive`` scans the warp counts inclusively: the
    off-by-one that must fail."""
    N, X = ev.shape
    run = 32 * COLS
    if ctas == 1:
        tile = min(max(T // COLS, 32), MAX_THREADS) * COLS
        tiles = [(t0, min(t0 + tile, T)) for t0 in range(0, T, tile)]
    else:
        tiles = [(r * T // ctas, (r + 1) * T // ctas) for r in range(ctas)]
    slots = np.zeros((N, cap + 1), np.int64)
    rows = np.arange(N)[:, None]
    carry = np.zeros(N, np.int64)
    for a0, a1 in tiles:
        runs = [(a, min(a + run, a1)) for a in range(a0, a1, run)]
        counts = np.stack([ev[:, a:b].sum(1) for a, b in runs], 1)
        prefix = np.cumsum(counts, 1) - (0 if inclusive else counts)
        for w, (a, b) in enumerate(runs):
            e = ev[:, a:b]
            slot = carry[:, None] + prefix[:, w : w + 1] + np.cumsum(e, 1) - 1
            dst = np.where(e & (slot < cap), slot, cap)
            np.maximum.at(slots, (np.broadcast_to(rows, dst.shape), dst),
                          np.where(e, payload[:, a:b], 0))
        carry += counts.sum(1)
    if X == T + 1:  # boundary T
        e = ev[:, T]
        ok = e & (carry < cap)
        slots[ok, carry[ok]] = payload[ok, T]
        carry += e
    return slots[:, :cap], carry


def _words(buf):
    return np.ascontiguousarray(buf.astype(np.uint8)).view(np.int32)


def _ins16(ins):
    u = ins.astype(np.int64) & 0xFFFF
    return (u[..., 0] | (u[..., 1] << 3) | (u[..., 2] << 6) | (u[..., 3] << 9)) & 0xFFFF


def model_block(tpl, fields, T, NWIN, ctas=1, inclusive=False):
    """The sparse block (``RP.sparse_words(T, NWIN)`` int32 words a lane)
    with every event placed by :func:`kernel_slots`."""
    sym, ins, jpath, spans, diffs, win, covered = (np.asarray(f) for f in fields)
    N = sym.shape[0]
    cap = 3 * T // 16
    s = sym.astype(np.int64)
    t = tpl.astype(np.int64)
    jp = jpath.astype(np.int64)
    colr = np.arange(T)[None, :]
    s0, s1 = spans[:, :1].astype(np.int64), spans[:, 1:].astype(np.int64)
    in_span = (colr >= s0) & (colr < s1) & covered[:, None]
    ev = in_span & (s != t)
    codes, n_s = kernel_slots(ev, (s - (s > t)) & 0xFF, cap, T, ctas, inclusive)
    c4 = codes.reshape(N, -1, 4)
    sym_codes = (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
                 | (c4[..., 3] << 6)) & 0xFF
    ins16 = _ins16(ins)
    iev = ins16 != 0
    ivals, n_i = kernel_slots(iev, ins16, cap, T, ctas, inclusive)
    ins_mask = np.packbits(np.concatenate([iev, np.zeros((N, 31), bool)], 1),
                           axis=1, bitorder="little")
    d = np.where(in_span, jp[:, 1:] - jp[:, :-1], 0)
    esc = d > 14
    nib = np.where(esc, 15, d)
    evals, n_e = kernel_slots(esc, np.clip(d, 0, 65535), RP._CAP_E, T, ctas,
                              inclusive)
    u16 = lambda v: np.stack([v & 0xFF, (v >> 8) & 0xFF], 2).reshape(N, -1)
    buf = np.concatenate([(nib[:, 0::2] | (nib[:, 1::2] << 4)) & 0xFF, u16(evals),
                          np.packbits(ev, axis=1, bitorder="little"), sym_codes,
                          ins_mask, u16(ivals)], 1)
    ovf = (n_s > cap) | (n_i > cap) | (n_e > RP._CAP_E)
    misc = np.stack([jp[np.arange(N), np.clip(spans[:, 0], 0, T)], spans[:, 0],
                     spans[:, 1], diffs, covered, ovf], 1).astype(np.int32)
    return np.concatenate([_words(buf), misc, win.astype(np.int32)], 1)


def _spread(rng, lo, hi, k):
    return np.sort(rng.choice(np.arange(lo, hi), k, replace=False))


def edge_lanes(T, seed=0):
    """Templates and crafted round fields, one edge a lane: sym events at
    the cap and one above it (lanes 0, 1), insertion boundaries at the cap
    with boundary T the last and one above it (2, 3), escapes at the cap
    and one above it (4, 5), events only in the last warp run (6), an
    insertion at boundary T alone (7), deltas of 14 and 15 (8), an
    uncovered lane with events (9), a cut span with events at and past
    its ends (10), a padded lane (11)."""
    rng = np.random.default_rng(seed)
    N, cap = 12, 3 * T // 16
    NWIN = RP.TB_nwin(T)
    tpl = rng.integers(0, 4, (N, T)).astype(np.int8)
    sym = tpl.copy()
    ins = np.zeros((N, T + 1, 4), np.int8)
    delta = np.ones((N, T), np.int64)
    spans = np.tile(np.array([0, T], np.int32), (N, 1))
    covered = np.ones(N, bool)

    def diverge(n, cols):
        sym[n, cols] = np.where(rng.random(len(cols)) < 0.2, 4,
                                (tpl[n, cols] + rng.integers(1, 4, len(cols))) % 4)

    def insert(n, bnds):
        ins[n, bnds, 0] = rng.integers(1, 5, len(bnds))
        ins[n, bnds, 1] = np.where(rng.random(len(bnds)) < 0.5,
                                   rng.integers(1, 5, len(bnds)), 0)

    diverge(0, _spread(rng, 0, T, cap))
    diverge(1, _spread(rng, 0, T, cap + 1))
    insert(2, np.append(_spread(rng, 0, T, cap - 1), T))
    insert(3, np.append(_spread(rng, 0, T, cap), T))
    delta[4, _spread(rng, 0, T, RP._CAP_E)] = rng.integers(15, 300, RP._CAP_E)
    delta[5, _spread(rng, 0, T, RP._CAP_E + 1)] = 15
    last = np.arange(T - 32 * COLS, T)
    diverge(6, _spread(rng, last[0], T, 20))
    insert(6, _spread(rng, last[0], T + 1, 20))
    delta[6, _spread(rng, last[0], T, 6)] = 40
    insert(7, [T])
    delta[8, 10:40] = np.tile([14, 15], 15)
    covered[9] = False
    diverge(9, _spread(rng, 0, T, 30))
    insert(9, _spread(rng, 0, T + 1, 30))
    delta[9, :20] = 50
    spans[10] = (37, T - 5)
    diverge(10, [0, 36, 37, 100, T - 6, T - 5, T - 1])
    insert(10, [0, 37, T - 5, T])
    delta[10, [36, 37, T - 6, T - 5]] = 99
    sym[11] = 5
    delta[11] = 0
    jpath = (100 + np.concatenate([np.zeros((N, 1), np.int64),
                                   np.cumsum(delta, 1)], 1)).astype(np.int32)
    col = np.arange(T)[None, :]
    sym = np.where((col >= spans[:, :1]) & (col < spans[:, 1:]) & covered[:, None],
                   sym, 5).astype(np.int8)
    bnd = np.arange(T + 1)[None, :]
    jpath = np.where((bnd >= spans[:, :1]) & (bnd <= spans[:, 1:]) & covered[:, None],
                     jpath, -1).astype(np.int32)
    jpath[11] = -1
    covered[11] = False
    spans[11] = 0
    diffs = rng.integers(0, 500, N).astype(np.int32)
    win = rng.integers(0, 9, (N, NWIN)).astype(np.int32)
    fields = (sym, ins, jpath, spans, diffs, win, covered)
    chars = np.concatenate([pack2bit(tpl.astype(np.uint8)),
                            np.zeros((N, 3 * T // 4), np.uint8)], 1)
    return tpl, chars, fields, NWIN


@contextlib.contextmanager
def round_fields(fields):
    """JAX's realign round (``_nw_round_parts``) returns ``fields`` while
    a packing is traced; restored on leaving."""
    parts = C._nw_round_parts
    C._nw_round_parts = lambda *a, **k: fields
    try:
        yield
    finally:
        C._nw_round_parts = parts


def _packed(c, m, f, T, NWIN):
    with round_fields(f):
        return C._nw_round_packed_sparse.__wrapped__(
            c, m, T=T, RL=2 * T, W=128, S=3 * T, NWIN=NWIN)


_jax_block = jax.jit(_packed, static_argnames=("T", "NWIN"))


def jax_block(chars, fields, T, NWIN):
    """JAX's ``_nw_round_packed_sparse`` on crafted round ``fields``."""
    return np.asarray(_jax_block(
        jnp.asarray(chars), jnp.zeros(3 * chars.shape[0], jnp.int32),
        tuple(jnp.asarray(f) for f in fields), T=T, NWIN=NWIN))


def _window_rows(t, lc, f):
    N = t.shape[1]
    z = jnp.zeros(N, jnp.int32)
    with round_fields(f):
        return C._window_sparse_pack(t, jnp.zeros((N, C._SEG), jnp.uint8), z, z,
                                     jnp.zeros((t.shape[0] + 1, N), jnp.int32),
                                     lc, 128)


@pytest.mark.parametrize("T", TS)
def test_kernel_slots_equal_jax_scatter(T):
    rng = np.random.default_rng(T)
    cap = 3 * T // 16
    ev = np.zeros((6, T + 1), bool)
    for n, k in enumerate((cap - 1, cap, cap + 1)):
        ev[n, _spread(rng, 0, T + 1, k)] = True
    ev[3, T - 32 * COLS : T + 1 : 3] = True  # the last warp run and T
    ev[4, T] = True
    payload = rng.integers(1, 1 << 16, ev.shape)
    for X, c in ((T + 1, cap), (T, cap), (T, RP._CAP_E)):
        want = jax.jit(C._scatter_events, static_argnums=(2, 3))(
            jnp.asarray(ev[:, :X]), jnp.asarray(payload[:, :X], jnp.int32), c,
            jnp.int32)
        for ctas in {1, cluster_ctas(T, 6)}:
            got = kernel_slots(ev[:, :X], payload[:, :X], c, T, ctas)
            np.testing.assert_array_equal(got[0], np.asarray(want[0]))
            np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("T", TS)
def test_model_blocks_equal_jax(T):
    tpl, chars, fields, NWIN = edge_lanes(T)
    want = jax_block(chars, fields, T, NWIN)
    assert want.shape == (12, RP.sparse_words(T, NWIN))
    for ctas in {1, cluster_ctas(T, 12)}:
        np.testing.assert_array_equal(model_block(tpl, fields, T, NWIN, ctas),
                                      want, err_msg=f"{ctas} CTAs")
    got = RP.round_pack_reference(
        torch.from_numpy(chars), tuple(torch.from_numpy(f) for f in fields),
        torch.zeros((12, T + 1), dtype=torch.int32), T, 2 * T, NWIN, True)
    np.testing.assert_array_equal(got.numpy(), want)
    ovf = want[:, -NWIN - 1].astype(bool)
    np.testing.assert_array_equal(np.flatnonzero(ovf), [1, 3, 5])


def test_scan_off_by_one_fails():
    assert [cluster_ctas(T, 12) for T in TS] == [1, 1, 4, 6]
    for T in (256, 2048):
        tpl, chars, fields, NWIN = edge_lanes(T, seed=1)
        want = jax_block(chars, fields, T, NWIN)
        bad = model_block(tpl, fields, T, NWIN, inclusive=True)
        assert (bad != want).any(axis=1).sum() >= 6, T


def test_window_rows_at_caps_equal_jax():
    """Windowed lanes with 32 / 24 / 4 interior events and one more each,
    and the same events just outside the 126 interior columns."""
    rng = np.random.default_rng(9)
    T, N, A = C._WS, 8, RP._ADV
    tpl = rng.integers(0, 4, (N, T)).astype(np.int8)
    loc0 = np.array([0, 33, 66, 10, 20, 0, 33, 5], np.int32)
    sym = tpl.copy()
    ins = np.zeros((N, T + 1, 4), np.int8)
    delta = np.ones((N, T), np.int64)
    for n, (s, i, e) in enumerate(((32, 0, 0), (33, 0, 0), (0, 24, 0), (0, 25, 0),
                                   (0, 0, 4), (0, 0, 5), (32, 24, 4), (5, 5, 2))):
        lo = loc0[n]
        c = _spread(rng, lo, lo + A, s)
        sym[n, c] = (tpl[n, c] + 1) % 4
        ins[n, _spread(rng, lo, lo + A + 1, i), 2] = 3
        delta[n, _spread(rng, lo, lo + A - 1, e)] = 15
    sym[7, 5:10] = 5  # an uncovered stretch at the interior's start
    sym[7, loc0[7] - 1] = 4
    ins[7, loc0[7] + A + 1, 0] = 1  # past the interior: not in the row
    jpath = (50 + np.concatenate([np.zeros((N, 1), np.int64),
                                  np.cumsum(delta, 1)], 1)).astype(np.int32)
    jpath[7, :8] = -1
    fields = (sym, ins, jpath, np.zeros((N, 2), np.int32), np.zeros(N, np.int32),
              np.zeros((N, 2), np.int32), np.ones(N, bool))
    want = np.asarray(jax.jit(_window_rows)(jnp.asarray(tpl.T.astype(np.uint8)),
                                    jnp.asarray(loc0),
                                    tuple(jnp.asarray(f) for f in fields)))
    meta = np.zeros((4, N), np.int32)
    meta[0], meta[3] = T, loc0
    packed = np.concatenate([pack2bit(tpl.astype(np.uint8)),
                             np.zeros((N, 3 * T // 4), np.uint8)], 1)
    got = RP.window_pack_reference(
        torch.from_numpy(packed), torch.from_numpy(meta),
        tuple(torch.from_numpy(f) for f in fields[:3]),
        torch.zeros((N, T + 1), dtype=torch.int32), True, False)
    np.testing.assert_array_equal(got.numpy(), want)
    ovf = want.view(np.uint8).reshape(N, -1)[:, 166]
    np.testing.assert_array_equal(np.flatnonzero(ovf), [1, 3, 5])
