"""Scaffold graph: the undirected 4-nodes-per-contig join graph.

Re-expression of ``source/dentist/common/scaffold.d``: every contig
contributes four nodes — ``pre`` (transcendent, front-extension target),
``begin``, ``end``, ``post`` — and edges ("joins") classify as

- *default*: (c.begin, c.end) — the contig itself,
- *gap*: real parts of two different contigs (a spanned gap candidate),
- *extension*: (c.pre, c.begin) front / (c.end, c.post) back,
- *unknown*: transcendent parts of two contigs — an existing scaffold
  gap of unspecified content (``n``s in the input assembly).

Edges carry a generic payload; multi-edges are merged with a caller
supplied function (``buildScaffold`` + ``mergeJoins``,
``scaffold.d:237``).  Linear scaffolds are read off by walking from
degree-≤1 ends (``scaffoldStarts``/``LinearWalk``, ``scaffold.d:1022-1210``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

__all__ = ["ContigPart", "Node", "Join", "ScaffoldGraph"]


class ContigPart(IntEnum):
    PRE = 0
    BEGIN = 1
    END = 2
    POST = 3

    @property
    def is_real(self) -> bool:
        return self in (ContigPart.BEGIN, ContigPart.END)

    @property
    def is_transcendent(self) -> bool:
        return self in (ContigPart.PRE, ContigPart.POST)


#: Node = (contig_id 1-based, part)
Node = tuple[int, ContigPart]


@dataclass
class Join:
    start: Node
    end: Node
    payload: object = None

    def __post_init__(self):
        if self.end < self.start:
            self.start, self.end = self.end, self.start

    @property
    def key(self) -> tuple[Node, Node]:
        return (self.start, self.end)

    # -- classification (scaffold.d:160-228) ---------------------------
    @property
    def is_default(self) -> bool:
        return (
            self.start[1] == ContigPart.BEGIN
            and self.end[1] == ContigPart.END
            and self.start[0] == self.end[0]
        )

    @property
    def is_gap(self) -> bool:
        return (
            self.start[0] != self.end[0]
            and self.start[1].is_real
            and self.end[1].is_real
        )

    @property
    def is_unknown(self) -> bool:
        return (
            self.start[0] != self.end[0]
            and self.start[1] != self.end[1]
            and self.start[1].is_transcendent
            and self.end[1].is_transcendent
        )

    @property
    def is_parallel(self) -> bool:
        return self.is_gap and self.start[1] != self.end[1]

    @property
    def is_anti_parallel(self) -> bool:
        return self.is_gap and self.start[1] == self.end[1]

    @property
    def is_front_extension(self) -> bool:
        return (
            self.start[0] == self.end[0]
            and self.start[1] == ContigPart.PRE
            and self.end[1] == ContigPart.BEGIN
        )

    @property
    def is_back_extension(self) -> bool:
        return (
            self.start[0] == self.end[0]
            and self.start[1] == ContigPart.END
            and self.end[1] == ContigPart.POST
        )

    @property
    def is_extension(self) -> bool:
        return self.is_front_extension ^ self.is_back_extension

    def other(self, node: Node) -> Node:
        return self.end if node == self.start else self.start


class ScaffoldGraph:
    """Undirected multi-merged join graph keyed by canonical node pairs."""

    def __init__(self):
        self.edges: dict[tuple[Node, Node], Join] = {}

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, num_contigs: int, joins, merge) -> "ScaffoldGraph":
        """Create default edges for contigs 1..num_contigs and add joins.

        `merge(existing_join, new_join) -> join` resolves multi-edges.
        """
        g = cls()
        for cid in range(1, num_contigs + 1):
            j = Join((cid, ContigPart.BEGIN), (cid, ContigPart.END))
            g.edges[j.key] = j
        for j in joins:
            g.add(j, merge)
        return g

    def add(self, join: Join, merge) -> None:
        existing = self.edges.get(join.key)
        if existing is None:
            self.edges[join.key] = join
        else:
            self.edges[join.key] = merge(existing, join)

    def remove(self, key: tuple[Node, Node]) -> None:
        self.edges.pop(key, None)

    def __len__(self) -> int:
        return len(self.edges)

    def joins(self) -> list[Join]:
        return list(self.edges.values())

    def incident(self, node: Node) -> list[Join]:
        return [j for j in self.edges.values() if node in (j.start, j.end)]

    def incidence_map(self) -> dict[Node, list[Join]]:
        """All incident edges per node (IncidentEdgesCache equivalent)."""
        out: dict[Node, list[Join]] = {}
        for j in self.edges.values():
            out.setdefault(j.start, []).append(j)
            if j.end != j.start:
                out.setdefault(j.end, []).append(j)
        return out

    def degree(self, node: Node) -> int:
        return len(self.incident(node))

    # ------------------------------------------------------------------
    def scaffold_starts(self) -> list[Node]:
        """Start nodes for linear walks: one endpoint per linear scaffold
        and a canonical entry node per cyclic scaffold
        (``scaffoldStarts``, ``scaffold.d:1210``)."""
        inc = self.incidence_map()
        visited: set[Node] = set()
        starts: list[Node] = []
        # endpoints: degree-1 nodes (walk once from the smaller endpoint)
        for node in sorted(inc):
            if node in visited or len(inc[node]) != 1:
                continue
            component = self._walk_component(node, inc)
            ends = sorted(n for n in component if len(inc[n]) == 1)
            starts.append(ends[0])
            visited.update(component)
        # remaining components are cyclic: pick smallest node
        for node in sorted(inc):
            if node not in visited:
                component = self._walk_component(node, inc)
                starts.append(min(component))
                visited.update(component)
        return starts

    def _walk_component(self, node: Node, inc) -> set[Node]:
        seen = {node}
        stack = [node]
        while stack:
            n = stack.pop()
            for j in inc.get(n, []):
                m = j.other(n)
                if m not in seen:
                    seen.add(m)
                    stack.append(m)
        return seen

    def linear_walk(self, start: Node):
        """Yield joins along a linear scaffold from `start`
        (``LinearWalk``, ``scaffold.d:1022``).

        At each node the walk takes the unvisited incident edge; ends when
        none remains or the start node is reached again (cycle).
        """
        inc = self.incidence_map()
        used: set[tuple[Node, Node]] = set()
        node = start
        while True:
            nxt = [j for j in inc.get(node, []) if j.key not in used]
            if not nxt:
                return
            join = nxt[0]
            if len(nxt) > 1:
                # deterministic choice: prefer non-default continuation order
                nxt.sort(key=lambda j: (j.other(node), j.key))
                join = nxt[0]
            used.add(join.key)
            yield join
            node = join.other(node)
            if node == start:
                return
