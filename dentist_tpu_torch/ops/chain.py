"""Local-alignment chaining as DAG shortest paths.

Faithful re-expression of the reference chaining algorithm
(``source/dentist/common/alignments/chaining.d``):

- LAs grouped by (contigA id, contigB id); chainable iff same strand,
  both sequences advance, ``indel = |gapA − gapB| ≤ max_indel_bps``,
  ``max(|gapA|, |gapB|) ≤ max_chain_gap_bps`` and per-sequence overlap
  ≤ ``max_relative_overlap`` of the shorter LA (``areChainable``,
  ``chaining.d:434-457``).
- Node bonus = mean covered bp ``(lenA+lenB)/2`` (``alignmentScore``);
  edge weight = ``indel + maxAbsGap/10 − alignmentScore(y)``
  (``chainScore``); solved as SSSP from a virtual source over each
  connected component (``chaining.d:1-35``).
- Chains selected best-first; paths sharing a prefix with a better chain
  are flagged ``alternate``; final filter keeps chains with score ≥
  ``max(min_score, min_relative_score · best)`` per (A, B) group
  (``effectiveMinScore``).

Defaults mirror ``commandline.d``: max_indel_bps=1000,
max_chain_gap_bps=10000, max_relative_overlap=0.3, min_relative_score=1.0,
min_score=126 (trace spacing).

Group sizes are small (LAs of one sequence pair), so the O(n²) DP runs
vectorized on the host; the heavy per-base work stays on device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.alignments import TRACE_SPACING, LocalAlignmentSet

__all__ = ["ChainingOptions", "Chain", "chain_local_alignments"]


@dataclass
class ChainingOptions:
    max_indel_bps: int = 1000
    max_chain_gap_bps: int = 10_000
    max_relative_overlap: float = 0.3
    min_relative_score: float = 1.0
    min_score: int = TRACE_SPACING

    def effective_min_score(self, best_score: float) -> float:
        return max(self.min_score, self.min_relative_score * best_score)


@dataclass
class Chain:
    """One alignment chain: ordered indices into a LocalAlignmentSet."""

    indices: np.ndarray
    a_id: int
    b_id: int
    complement: bool
    score: int
    alternate: bool = False

    def __len__(self) -> int:
        return len(self.indices)

    def first_last(self, las: LocalAlignmentSet):
        f, l = self.indices[0], self.indices[-1]
        return (
            int(las.a_begin[f]), int(las.a_end[l]),
            int(las.b_begin[f]), int(las.b_end[l]),
        )

    def total_diffs(self, las: LocalAlignmentSet) -> int:
        return int(las.diffs[self.indices].sum())

    def is_proper(self, las: LocalAlignmentSet, a_len: int, b_len: int,
                  allowance: int = TRACE_SPACING) -> bool:
        """Reference ``AlignmentChain.isProper`` (``base.d:537``)."""
        ab, ae, bb, be = self.first_last(las)
        begins = ab <= allowance or bb <= allowance
        ends = ae >= a_len - allowance or be >= b_len - allowance
        return begins and ends


def _group_slices(keys: np.ndarray):
    """Slices of equal consecutive rows in a lexsorted 2-column key array."""
    n = len(keys)
    if n == 0:
        return
    brk = np.flatnonzero(np.any(keys[1:] != keys[:-1], axis=1)) + 1
    bounds = np.concatenate([[0], brk, [n]])
    for s, e in zip(bounds[:-1], bounds[1:]):
        yield slice(s, e)


def chain_local_alignments(
    las: LocalAlignmentSet, options: ChainingOptions | None = None,
    progress=None,
) -> tuple[list[Chain], LocalAlignmentSet]:
    """Chain a (sorted) LocalAlignmentSet.  Returns (chains, las).

    The returned ``las`` is the input re-sorted canonically; chain indices
    refer to it.  ``progress(done, total)``, if given, is called after
    each (A, B) group with the number of local alignments processed —
    the reference's ``chain-local-alignments --progress`` hook
    (``docs/list-of-commandline-options.md:171-178``).
    """
    opts = options or ChainingOptions()
    las = las.sort()
    chains: list[Chain] = []
    if len(las) == 0:
        return chains, las

    keys = np.stack([las.a_id, las.b_id], axis=1)
    total = len(las)
    for grp in _group_slices(keys):
        idx = np.arange(grp.start, grp.stop)
        chains.extend(_chain_group(las, idx, opts))
        if progress is not None:
            progress(grp.stop, total)
    return chains, las


def _chain_group(las: LocalAlignmentSet, idx: np.ndarray, opts: ChainingOptions) -> list[Chain]:
    n = len(idx)
    if n == 1:
        # singleton fast path (the dominant case at mapping scale —
        # most (contig, read) pairs carry exactly one LA): identical
        # outcome to the n×n machinery below at a fraction of its
        # fixed numpy overhead
        i = int(idx[0])
        if las.disabled[i]:
            return []
        score = (int(las.a_end[i]) - int(las.a_begin[i])
                 + int(las.b_end[i]) - int(las.b_begin[i])) // 2
        if score < opts.effective_min_score(score):
            return []
        return [Chain(indices=idx, a_id=int(las.a_id[i]),
                      b_id=int(las.b_id[i]),
                      complement=bool(las.complement[i]),
                      score=score, alternate=False)]
    ab = las.a_begin[idx].astype(np.int64)
    ae = las.a_end[idx].astype(np.int64)
    bb = las.b_begin[idx].astype(np.int64)
    be = las.b_end[idx].astype(np.int64)
    comp = las.complement[idx]
    disabled = las.disabled[idx]

    # pairwise chainability (x may precede y): vectorized n×n
    gap_a = ab[None, :] - ae[:, None]  # gap!'A'(x, y)
    gap_b = bb[None, :] - be[:, None]
    indel = np.abs(gap_a - gap_b)
    max_abs_gap = np.maximum(np.abs(gap_a), np.abs(gap_b))
    len_a = ae - ab
    len_b = be - bb
    min_len_a = np.minimum(len_a[:, None], len_a[None, :])
    min_len_b = np.minimum(len_b[:, None], len_b[None, :])
    ov_a = np.maximum(0, -gap_a)
    ov_b = np.maximum(0, -gap_b)
    chainable = (
        (comp[:, None] == comp[None, :])
        & (ab[:, None] < ab[None, :])
        & (bb[:, None] < bb[None, :])
        & (indel <= opts.max_indel_bps)
        & (max_abs_gap <= opts.max_chain_gap_bps)
        & (ov_a <= opts.max_relative_overlap * min_len_a)
        & (ov_b <= opts.max_relative_overlap * min_len_b)
        & ~disabled[:, None] & ~disabled[None, :]
    )
    np.fill_diagonal(chainable, False)

    node_score = (len_a + len_b) // 2
    edge_w = np.where(chainable, indel + max_abs_gap // 10 - node_score[None, :], 0)

    # connected components of the undirected chainability graph
    und = chainable | chainable.T
    comp_id = _components(und)

    # SSSP over each component; nodes processed in (a_begin, b_begin) order
    order = np.lexsort((bb, ab))
    dist = np.where(disabled, np.int64(1 << 60), -node_score)
    pred = np.full(n, -1, dtype=np.int64)
    for y in order:
        xs = np.flatnonzero(chainable[:, y])
        if len(xs) == 0:
            continue
        cand = dist[xs] + edge_w[xs, y]
        k = int(np.argmin(cand))
        if cand[k] < dist[y]:
            dist[y] = cand[k]
            pred[y] = xs[k]

    chains: list[Chain] = []
    all_scores: list[int] = []
    per_comp: dict[int, list[tuple[int, list[int], bool]]] = {}
    for c in np.unique(comp_id):
        members = np.flatnonzero((comp_id == c) & ~disabled)
        if len(members) == 0:
            continue
        d = dist[members]
        srt = members[np.argsort(d, kind="stable")]
        best = -dist[srt[0]]
        max_d = -opts.effective_min_score(best)
        forbidden = np.zeros(n, dtype=bool)
        sel = []
        for end in srt:
            if forbidden[end] or dist[end] > max_d:
                continue
            path = []
            node = end
            alternate = False
            while node >= 0:
                path.append(node)
                if forbidden[node]:
                    alternate = True
                forbidden[node] = True
                node = pred[node]
            path.reverse()
            sel.append((end, path, alternate))
        per_comp[c] = sel
        all_scores.extend(-dist[e] for e, _, _ in sel)

    if not all_scores:
        return []
    global_min = opts.effective_min_score(max(all_scores))
    for c, sel in per_comp.items():
        for end, path, alternate in sel:
            score = int(-dist[end])
            if score < global_min:
                continue
            chains.append(
                Chain(
                    indices=idx[np.array(path)],
                    a_id=int(las.a_id[idx[0]]),
                    b_id=int(las.b_id[idx[0]]),
                    complement=bool(comp[path[0]]),
                    score=score,
                    alternate=alternate,
                )
            )
    # canonical order: by first a_begin, then b_begin
    chains.sort(key=lambda ch: (int(las.a_begin[ch.indices[0]]),
                                int(las.b_begin[ch.indices[0]]),
                                bool(ch.complement)))
    return chains


def _components(adj: np.ndarray) -> np.ndarray:
    """Connected component labels of a boolean adjacency matrix.

    Union-find over the edge list (min-index roots, path halving):
    O(E·α) per group instead of the worst-case O(n³) of label
    propagation — repeat-dense LAS groups reach hundreds of members.
    Labels are each component's minimal member index, matching the
    propagation fixpoint exactly.
    """
    n = len(adj)
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ii, jj = np.nonzero(adj)
    for a, b in zip(ii.tolist(), jj.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)])
