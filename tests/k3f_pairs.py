"""K3f's (template, read) pairs at its edges, shared by its CPU tests
(``test_torch_nw_dist.py``, against the JAX package) and its card tests
(``test_torch_kernels_cuda.py``, which run where JAX is not installed):
numpy alone."""

import numpy as np

#: byte values that differ from each other and from the codes 0..3 in
#: one or a few high bits, so that matches are common but a compare of
#: fewer than eight planes would take some of them for equal
NEAR = np.array([0, 1, 2, 3, 4, 5, 7, 64, 65, 128, 129, 131, 254, 255], np.uint8)


def noisy(rng, t, alphabet, n):
    """A copy of ``t`` repeated to ``n`` chars with 12 % substitutions,
    deletions and insertions drawn from ``alphabet``."""
    out = []
    for ch in np.resize(t, n + n // 4 + 4) if len(t) else ():
        r = rng.random()
        if r < 0.04:
            continue
        out.append(rng.choice(alphabet) if r < 0.08 else ch)
        if r > 0.96:
            out.append(rng.choice(alphabet))
    return np.asarray(out[:n], np.uint8)


def k3f_pairs(seed, V, N, T, RL):
    """(template, read) pairs at K3f's edges, in runs of four templates
    (32 pairs, one warp at N = 8) by alphabet: codes 0..3; codes in the
    reads against templates holding bytes ≥ 4; bytes from ``NEAR`` in
    both; any byte 0..255.  t_len 0, 1, T and > T among ordinary ones;
    rl -1, 0, 1, on the limb edges, RL and RL + 1; noisy copies,
    homopolymers and random reads; garbage of any byte past every rl."""
    rng = np.random.default_rng(seed)
    codes = np.arange(4, dtype=np.uint8)
    full = np.arange(256, dtype=np.uint8)
    kinds = [(codes, codes), (NEAR, codes), (NEAR, NEAR), (full, full)]
    tpl = np.zeros((V, T), np.uint8)
    t_lens = rng.integers(1, T + 1, V).astype(np.int32)
    t_lens[::5] = T + 1 + rng.integers(0, 4, len(t_lens[::5]))
    t_lens[1::7], t_lens[2::7], t_lens[3::11] = 0, T, 1
    reads = rng.integers(0, 256, (V, N, RL)).astype(np.uint8)
    edge = [-1, 0, 1, 31, 32, 33, 63, 64, 65, 96, 97, RL, RL + 1]
    edge = [r for r in edge if r <= RL + 1]
    r_lens = np.zeros((V, N), np.int32)
    for v in range(V):
        t_ab, r_ab = kinds[(v // 4) % 4]
        t = rng.choice(t_ab, T)
        if v % 6 == 5:
            t[:] = t_ab[v % len(t_ab)]  # homopolymer
        tpl[v] = t
        for n in range(N):
            rl = (edge[(v + n) % len(edge)] if (v + n) % 3 else
                  int(rng.integers(0, RL + 1)))
            k = min(max(rl, 0), RL)
            if n % 4 == 3:
                r = rng.choice(r_ab, k)
            elif n % 4 == 2:
                r = np.full(k, t[0] if t[0] in r_ab else r_ab[-1], np.uint8)
            else:
                r = noisy(rng, np.where(np.isin(t, r_ab), t, r_ab[-1])
                          [: max(1, min(t_lens[v], T))], r_ab, k)
            reads[v, n, : len(r)] = r
            reads[v, n, len(r) : k] = rng.choice(r_ab, k - len(r))
            r_lens[v, n] = rl
    return tpl, t_lens, reads, r_lens
