"""Logical interconnect topologies (paper §4.3 / §5.1).

A copy of ``repro.core.topology`` (numpy only), kept so that the PyTorch
port imports nothing from the JAX package.

The paper describes FPGA clusters whose QSFP ports are wired point-to-point
(8 FPGAs in a 2D torus for the evaluation; a linear bus variant is obtained by
*reconfiguring the routing tables only*).  Here a :class:`Topology` is the
logical connection graph used by the route generator.  In the port all
ranks live on one card as the leading dimension of every tensor, so a link
is an index copy along that dimension; the topology still decides which
copies a schedule makes, as the paper's QSFP wiring does.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class Topology:
    """An undirected connection graph over ``n_ranks`` endpoints.

    ``links[r]`` is the ordered tuple of neighbours of rank ``r`` — the order
    is meaningful: position ``i`` is rank ``r``'s *port i* (the paper's QSFP
    port index), used by the routing tables to name output links.
    """

    n_ranks: int
    links: tuple[tuple[int, ...], ...]
    name: str = "custom"
    dims: tuple[int, ...] | None = None  # set for tori; enables DOR routing

    def __post_init__(self):
        assert len(self.links) == self.n_ranks, "links must cover every rank"
        for r, nbrs in enumerate(self.links):
            for n in nbrs:
                assert 0 <= n < self.n_ranks, f"bad neighbour {n} of {r}"
                assert n != r, f"self-link at {r}"
                assert r in self.links[n], f"link {r}->{n} not symmetric"

    # -- constructors -----------------------------------------------------

    @staticmethod
    def torus(dims: Sequence[int]) -> "Topology":
        """K-ary n-cube.  Rank layout is row-major (last dim fastest), the
        order of the leading rank dimension of a rank-stacked tensor."""
        dims = tuple(int(d) for d in dims)
        n = 1
        for d in dims:
            n *= d
        strides = []
        s = 1
        for d in reversed(dims):
            strides.append(s)
            s *= d
        strides = list(reversed(strides))

        def coords(r):
            return tuple((r // strides[i]) % dims[i] for i in range(len(dims)))

        def rank_of(c):
            return sum(ci * strides[i] for i, ci in enumerate(c))

        links = []
        for r in range(n):
            c = coords(r)
            nbrs = []
            for i, d in enumerate(dims):
                if d == 1:
                    continue
                for step in (+1, -1):
                    cc = list(c)
                    cc[i] = (cc[i] + step) % d
                    nb = rank_of(tuple(cc))
                    if nb != r and nb not in nbrs:
                        nbrs.append(nb)
            links.append(tuple(nbrs))
        return Topology(n, tuple(links), name=f"torus{dims}", dims=dims)

    @staticmethod
    def ring(n: int) -> "Topology":
        return Topology.torus((n,))._replace_name(f"ring{n}")

    @staticmethod
    def bus(n: int) -> "Topology":
        """Linear bus (no wrap-around) — the paper's reduced-connectivity
        benchmark topology."""
        links = []
        for r in range(n):
            nbrs = []
            if r + 1 < n:
                nbrs.append(r + 1)
            if r - 1 >= 0:
                nbrs.append(r - 1)
            links.append(tuple(nbrs))
        return Topology(n, tuple(links), name=f"bus{n}")

    @staticmethod
    def from_edges(n: int, edges: Sequence[tuple[int, int]], name="custom") -> "Topology":
        nbrs: list[list[int]] = [[] for _ in range(n)]
        for a, b in edges:
            if b not in nbrs[a]:
                nbrs[a].append(b)
            if a not in nbrs[b]:
                nbrs[b].append(a)
        return Topology(n, tuple(tuple(x) for x in nbrs), name=name)

    @staticmethod
    def from_json(path_or_str: str) -> "Topology":
        """The paper's route generator consumes a JSON topology description;
        we accept ``{"n_ranks": N, "edges": [[a, b], ...], "name": ...}``."""
        try:
            spec = json.loads(path_or_str)
        except json.JSONDecodeError:
            with open(path_or_str) as f:
                spec = json.load(f)
        return Topology.from_edges(
            int(spec["n_ranks"]),
            [tuple(e) for e in spec["edges"]],
            name=spec.get("name", "json"),
        )

    def to_json(self) -> str:
        edges = sorted({(min(a, b), max(a, b)) for a in range(self.n_ranks) for b in self.links[a]})
        return json.dumps(
            {"n_ranks": self.n_ranks, "edges": [list(e) for e in edges], "name": self.name}
        )

    # -- queries ----------------------------------------------------------

    def _replace_name(self, name: str) -> "Topology":
        return Topology(self.n_ranks, self.links, name=name, dims=self.dims)

    def neighbors(self, r: int) -> tuple[int, ...]:
        return self.links[r]

    def port_of(self, r: int, neighbor: int) -> int:
        """Output-link ("QSFP port") index of the edge r -> neighbor."""
        return self.links[r].index(neighbor)

    def degree(self, r: int) -> int:
        return len(self.links[r])

    def is_connected(self) -> bool:
        if self.n_ranks == 0:
            return True
        seen = {0}
        stack = [0]
        while stack:
            r = stack.pop()
            for n in self.links[r]:
                if n not in seen:
                    seen.add(n)
                    stack.append(n)
        return len(seen) == self.n_ranks

    def diameter(self) -> int:
        from .routing import bfs_dists

        return max(int(bfs_dists(self, s).max()) for s in range(self.n_ranks))
