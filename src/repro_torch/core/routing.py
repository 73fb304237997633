"""Deadlock-free static routing (paper §4.3).

A copy of ``repro.core.routing`` (numpy only); tests hold its tables equal
to the reference's.

The paper computes routes offline with a deadlock-free scheme (citing Domke
et al.) and uploads routing tables to each rank at runtime, *without
rebuilding the bitstream*.  We reproduce the split exactly:

* :func:`compute_route_table` — the "route generator".  Dimension-order
  routing (DOR) on tori (provably deadlock-free on a fixed-direction link
  schedule), breadth-first shortest paths with deterministic tie-breaking on
  arbitrary graphs.
* :class:`RouteTable` — ``next_hop[src, dst]`` and ``out_port[src, dst]``
  numpy tables.  The *static* streaming engine consumes them when it builds a schedule.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .topology import Topology


def bfs_dists(topo: Topology, src: int) -> np.ndarray:
    dist = np.full(topo.n_ranks, -1, dtype=np.int32)
    dist[src] = 0
    frontier = [src]
    while frontier:
        nxt = []
        for r in frontier:
            for n in topo.links[r]:
                if dist[n] < 0:
                    dist[n] = dist[r] + 1
                    nxt.append(n)
        frontier = nxt
    return dist


def _dor_next_hop(topo: Topology, src: int, dst: int) -> int:
    """Dimension-order next hop on a torus: correct dimension 0 first, then 1,
    ..., choosing the shorter wrap direction (ties go +)."""
    dims = topo.dims
    assert dims is not None
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    strides = list(reversed(strides))
    cs = [(src // strides[i]) % dims[i] for i in range(len(dims))]
    cd = [(dst // strides[i]) % dims[i] for i in range(len(dims))]
    for i in range(len(dims)):
        if cs[i] == cd[i]:
            continue
        d = dims[i]
        fwd = (cd[i] - cs[i]) % d
        bwd = (cs[i] - cd[i]) % d
        step = +1 if fwd <= bwd else -1
        cc = list(cs)
        cc[i] = (cs[i] + step) % d
        return sum(cc[j] * strides[j] for j in range(len(dims)))
    return dst


@dataclass(frozen=True)
class RouteTable:
    """Static routing tables for one topology.

    next_hop[s, d] = neighbour of s on the route to d (s itself when s == d).
    out_port[s, d] = index of that neighbour in topo.links[s] (-1 when s == d).
    """

    topo: Topology
    next_hop: np.ndarray
    out_port: np.ndarray

    def path(self, src: int, dst: int) -> list[int]:
        """Full route src -> dst as a rank list (inclusive)."""
        p = [src]
        guard = 0
        while p[-1] != dst:
            p.append(int(self.next_hop[p[-1], dst]))
            guard += 1
            assert guard <= self.topo.n_ranks, f"routing loop {src}->{dst}"
        return p

    def n_hops(self, src: int, dst: int) -> int:
        return len(self.path(src, dst)) - 1


def compute_route_table(topo: Topology, scheme: str = "auto") -> RouteTable:
    """The paper's "route generator": topology in, per-rank tables out."""
    n = topo.n_ranks
    next_hop = np.zeros((n, n), dtype=np.int32)
    if scheme == "auto":
        scheme = "dor" if topo.dims is not None else "bfs"

    if scheme == "dor":
        assert topo.dims is not None, "DOR needs torus coordinates"
        for s in range(n):
            for d in range(n):
                next_hop[s, d] = s if s == d else _dor_next_hop(topo, s, d)
    elif scheme == "bfs":
        # Shortest paths; tie-break by smallest-index predecessor so tables
        # are deterministic (the paper requires static, reproducible routes).
        for d in range(n):
            dist = bfs_dists(topo, d)
            assert (dist >= 0).all(), f"topology {topo.name} is disconnected"
            for s in range(n):
                if s == d:
                    next_hop[s, d] = s
                    continue
                best = min(
                    (x for x in topo.links[s] if dist[x] == dist[s] - 1),
                )
                next_hop[s, d] = best
    else:
        raise ValueError(f"unknown routing scheme {scheme!r}")

    out_port = np.full((n, n), -1, dtype=np.int32)
    for s in range(n):
        for d in range(n):
            if s != d:
                out_port[s, d] = topo.port_of(s, int(next_hop[s, d]))
    return RouteTable(topo, next_hop, out_port)


def channel_dependency_acyclic(rt: RouteTable) -> bool:
    """Deadlock-freedom check: build the channel-dependency graph (CDG) over
    directed links induced by all (src, dst) routes and test acyclicity.
    Dally & Seitz: wormhole/credit routing is deadlock-free iff the CDG is
    acyclic.  Used by property tests on DOR tables."""
    edges: set[tuple[tuple[int, int], tuple[int, int]]] = set()
    n = rt.topo.n_ranks
    for s in range(n):
        for d in range(n):
            if s == d:
                continue
            p = rt.path(s, d)
            chans = list(zip(p[:-1], p[1:]))
            for a, b in zip(chans[:-1], chans[1:]):
                edges.add((a, b))
    # Kahn toposort over channel nodes.
    nodes = {c for e in edges for c in e}
    indeg = {c: 0 for c in nodes}
    for _, b in edges:
        indeg[b] += 1
    from collections import deque

    q = deque([c for c in nodes if indeg[c] == 0])
    seen = 0
    adj: dict[tuple[int, int], list[tuple[int, int]]] = {c: [] for c in nodes}
    for a, b in edges:
        adj[a].append(b)
    while q:
        c = q.popleft()
        seen += 1
        for b in adj[c]:
            indeg[b] -= 1
            if indeg[b] == 0:
                q.append(b)
    return seen == len(nodes)


def physical_link_map(dims: tuple[int, ...]) -> dict[tuple[int, int], int]:
    """Map each directed torus edge to its physical link id.

    Link ids: 2*i   = +1 step in dim i,
              2*i+1 = -1 step in dim i.
    The rendering of the paper's fixed QSFP wiring that the packet router
    keys its per-link schedule on.
    """
    topo = Topology.torus(dims)
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    strides = list(reversed(strides))
    out: dict[tuple[int, int], int] = {}
    n = topo.n_ranks
    for r in range(n):
        c = [(r // strides[i]) % dims[i] for i in range(len(dims))]
        for i, d in enumerate(dims):
            if d == 1:
                continue
            for sidx, step in ((0, +1), (1, -1)):
                cc = list(c)
                cc[i] = (cc[i] + step) % d
                nb = sum(cc[j] * strides[j] for j in range(len(dims)))
                if nb != r:
                    out[(r, nb)] = 2 * i + sidx
    return out
