"""Packet transport: collectives over the dynamic router.

The flexibility path, a port of ``repro.transport.packet``.  Every logical
step — ring shift, explicit permutation, routed p2p — runs end to end
through the store-and-forward packet router of :mod:`repro_torch.core.router`:
each rank's row is packetised (``pkt_elems`` float32 per packet + a dst
header), staged into an input FIFO, and the router runs enough ticks over
the fixed physical link schedule to deliver everything; arrivals are
reassembled into the tensor the static backend would have produced.  The
route table is runtime data, so swapping the communicator's logical
topology (torus → snake bus) re-routes the same kernel (paper §5.3.1).
With ranks run as processes (:mod:`repro_torch.core.spmd`) each process
stages, routes and reassembles only the ranks it holds, the link rows
crossing between processes after every router tick; the counters and the
overflow are each process's own, the overflow of the ranks it holds.

Delivery guarantees relied on for reassembly:

* each ``permute`` is a partial permutation (unique sources and unique
  destinations), so a receiver drains exactly one stream;
* packets of one stream follow one fixed route through FIFO queues, so
  they arrive in order;
* ``n_steps`` is a static worst-case bound (max hops + serialisation on
  the most contended link), so a lossless run delivers everything — the
  router's overflow counter *plus any delivery shortfall at the schedule's
  end* is accumulated into ``stats.overflow`` and is 0 for every
  in-capacity run.  The bound is the reference's and is no true worst case
  everywhere: on the snake bus a ring shift of distance 2 or more with a
  few packets per rank runs out of ticks, in the reference as here, and
  the shortfall shows in ``stats.overflow``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..obs import trace as obs
from .base import Transport, rank_bytes, straight_through
from .registry import register_transport

# ------------------------------------------------------------------ wire

_BITCAST = (torch.int32, torch.uint32)


def _encode(x: torch.Tensor) -> torch.Tensor:
    """Rank-stacked ``x`` -> ``(P, T)`` float32 wire rows, bit-exactly
    invertible for types of at most 32 bits (floats widen exactly; 32-bit
    ints ride as raw bits)."""
    if x.element_size() > 4:
        raise TypeError(
            f"packet wire format carries <=32-bit elements; got {x.dtype} "
            "(a 64-bit payload would silently truncate through the float32 wire)"
        )
    flat = x.reshape(x.shape[0], -1)
    if x.dtype == torch.float32:
        return flat
    if x.dtype in _BITCAST:
        return flat.contiguous().view(torch.float32)
    return flat.to(torch.float32)


def _decode(vec: torch.Tensor, shape, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return vec.reshape(shape)
    if dtype in _BITCAST:
        return vec.contiguous().view(dtype).reshape(shape)
    return vec.to(dtype).reshape(shape)


# ------------------------------------------------------------- transport

#: router-table cache bound: the key includes the route table's bytes, so a
#: long-lived transport sweeping topologies would otherwise grow without
#: limit.  8 comfortably covers a working set of fabrics in flight.
TBL_CACHE_MAX = 8


def lru_get(cache: dict, key, make, cap: int = TBL_CACHE_MAX):
    """Tiny LRU on a plain (insertion-ordered) dict: a hit moves the entry
    to the back; a miss past ``cap`` evicts the front (least recent)."""
    if key in cache:
        cache[key] = cache.pop(key)  # refresh recency
        return cache[key]
    while len(cache) >= max(int(cap), 1):
        cache.pop(next(iter(cache)))
    val = cache[key] = make()
    return val


@functools.lru_cache(maxsize=512)
def _roles(pairs: tuple, n: int, K: int, device: torch.device):
    """Per-rank staging of one permutation, made once on ``device`` (a copy
    from host memory to the card would synchronise every step):
    ``(inq_dst (n, 1, K), inq_len (n, 1), is_recv (n,), keeps (n,))``."""
    dst_arr = np.full(n, -1, np.int32)
    keep_arr = np.zeros(n, bool)  # (r, r) self-pairs: local delivery
    recv_arr = np.zeros(n, bool)
    for s, d in pairs:
        if s == d:
            keep_arr[s] = True
        else:
            dst_arr[s] = d
            recv_arr[d] = True
    inq_dst = np.broadcast_to(np.clip(dst_arr, 0, n - 1)[:, None, None], (n, 1, K))
    inq_len = np.where(dst_arr >= 0, K, 0).astype(np.int32)[:, None]
    return tuple(torch.from_numpy(np.array(a)).to(device)
                 for a in (inq_dst, inq_len, recv_arr, keep_arr))


@register_transport("packet")
@dataclass
class PacketTransport(Transport):
    """Store-and-forward packet router as a Transport backend.

    ``pkt_elems`` scales the paper's 28 B network packet; ``slack_steps``
    pads the static delivery-time bound; ``transit_cap`` overrides the
    computed worst-case transit depth (tests undersize it to prove the
    overflow counter fires).  ``router_impl`` picks the router datapath
    (``core/router.py``: "scalar" | "vector" | "kernel"; None takes the
    kernel on the card and the vector path on the CPU).
    """

    #: the router's loss counter is a value of the run (the pipeline's
    #: stage hop takes the static wire instead, as the reference's does)
    runtime_stats = True

    pkt_elems: int = 32
    slack_steps: int = 4
    transit_cap: int | None = None
    router_impl: str | None = None
    _tbl_cache: dict = field(default_factory=dict, repr=False)

    # -- routing-table + schedule bounds (static, per communicator) ------

    def _phys_dims(self, comm) -> tuple[int, ...]:
        # The physical fabric is the torus implied by the mesh axes.
        return tuple(comm.axis_sizes)

    def _route_table(self, comm) -> torch.Tensor:
        from ..core.router import make_router_tables

        # key on the actual connection lists AND the route-table bytes — two
        # `from_edges` topologies share name="custom", and one link set
        # admits different route tables (DOR vs BFS tie-breaks); the table
        # follows the communicator's own routes, the ones _bounds analyses
        key = (comm.axis_sizes, comm.topology.links, comm.route_table.next_hop.tobytes())
        return lru_get(self._tbl_cache, key, lambda: torch.from_numpy(make_router_tables(
            comm.topology, self._phys_dims(comm), rt=comm.route_table)).to(self.device))

    def _bounds(self, comm, active_pairs, n_packets: int):
        """(n_steps, transit_cap): static worst-case delivery bounds.

        n_steps: longest route + full serialisation of the most contended
        directed link (each link moves one packet per tick).
        transit_cap: most packets that can ever be parked at one rank.
        """
        edge_load: dict[tuple[int, int], int] = {}
        transit_load = np.zeros(comm.size, np.int64)
        max_hops = 1
        for s, d in active_pairs:
            path = comm.route_table.path(s, d)
            max_hops = max(max_hops, len(path) - 1)
            for a, b in zip(path[:-1], path[1:]):
                edge_load[(a, b)] = edge_load.get((a, b), 0) + 1
            for mid in path[1:-1]:
                transit_load[mid] += 1
        max_edge = max(edge_load.values(), default=1)
        n_steps = max_hops + n_packets * max_edge + self.slack_steps
        transit_cap = self.transit_cap
        if transit_cap is None:
            transit_cap = max(4, n_packets * int(transit_load.max()) + 2)
        return n_steps, transit_cap

    # ------------------------------------------------------------- steps

    def router_job(self, vec, comm, pairs):
        """The router run that moves the ``(P, T)`` float32 wire rows
        ``vec`` along ``pairs`` (a partial permutation without self-pairs):
        ``(cfg, route_tbl, inq_pay, inq_dst, inq_len, n_steps)``, the
        arguments of :func:`~repro_torch.core.router.run_router`.  With
        ranks run as processes ``vec`` and the staged input are the rows
        this process holds; the route table and the bounds are the whole
        communicator's."""
        from ..core.router import RouterConfig

        n, T = comm.size, vec.shape[1]
        E = self.pkt_elems
        K = -(-T // E)  # packets per sender
        held = slice(comm.lo, comm.lo + comm.n_local)  # every rank unless ranks are processes
        inq_dst, inq_len = (a[held] for a in _roles(tuple(pairs), n, K, vec.device)[:2])
        pay = F.pad(vec, (0, K * E - T)).reshape(vec.shape[0], 1, K, E)
        n_steps, transit_cap = self._bounds(comm, pairs, K)
        cfg = RouterConfig(dims=self._phys_dims(comm), n_ports=1, fifo_cap=K,
                           transit_cap=transit_cap, out_cap=K, pkt_elems=E)
        return cfg, self._route_table(comm), pay, inq_dst, inq_len, n_steps

    def permute(self, x, comm, pairs):
        """One router run moving every rank row of ``x`` (the members of a
        tuple ``x`` concatenated into one packet train a rank).  Under
        autograd the gradient is the exact move's, handed back along the
        transposed pairs: kernel C's output is off the graph, so the card
        and the CPU's plain router give the same gradient."""
        self._check(x)
        pairs = tuple((int(s), int(d)) for s, d in pairs)
        active = [(s, d) for s, d in pairs if s != d]
        if not active:
            return x
        srcs = [s for s, _ in active]
        dsts = [d for _, d in active]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError("packet transport moves partial permutations: unique "
                             f"srcs/dsts required, got {list(pairs)}")
        return straight_through(x, lambda: self._permute(x, comm, pairs, active), comm, pairs)

    def _permute(self, x, comm, pairs, active):
        leaves = x if isinstance(x, tuple) else (x,)
        parts = [_encode(v) for v in leaves]                 # (P, T_i) each
        vec = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        T = vec.shape[1]
        if T == 0:
            return x
        # a row that carries ``lanes`` devices' shares (an FSDP block stacked
        # over the model ranks) routes as that many router jobs of one
        # share each, as each device rings its own; a step tallies one's
        runs = [self._route(v, comm, active, pairs) for v in vec.chunk(self.lanes, dim=1)]
        self.tally(runs[0][1], rank_bytes(x) // self.lanes)
        wire = torch.cat([rows for rows, _ in runs], dim=1) if len(runs) > 1 else runs[0][0]
        if not isinstance(x, tuple):
            return _decode(wire, x.shape, x.dtype)
        out = wire.split([p.shape[1] for p in parts], dim=1)
        return tuple(_decode(w, v.shape, v.dtype) for w, v in zip(out, leaves))

    def _route(self, vec, comm, active, pairs):
        """One router run moving the ``(P, T)`` wire rows ``vec`` along
        ``active`` (``pairs`` with its self-pairs): ``(rows, n_steps)``, the
        rows every rank holds after the step and the run's tick bound."""
        from ..core.router import run_router

        cfg, tbl, pay, inq_dst, inq_len, n_steps = self.router_job(vec, comm, active)
        out_pay, out_cnt, ovf, _ = run_router(cfg, comm, tbl, pay, inq_dst, inq_len, n_steps,
                                              impl=self.router_impl)
        # Undelivered packets (an under-provisioned n_steps bound) would
        # silently back-fill zeros below — fold the delivery shortfall into
        # the loss counter so the "overflow == 0" oracle catches it.
        K = cfg.fifo_cap
        held = slice(comm.lo, comm.lo + comm.n_local)
        is_recv, keeps = (a[held] for a in _roles(pairs, comm.size, K, vec.device)[2:])
        shortfall = torch.where(is_recv, K - out_cnt[:, 0], torch.zeros_like(out_cnt[:, 0]))
        self.stats.add_overflow(ovf + shortfall)
        if obs.TRACING:
            # the counter stays on the device; the event marks where it
            # accrues and carries the schedule's static bounds
            obs.emit("router.overflow", tag=self._tag, n_steps=int(n_steps), packets=int(K),
                     transit_cap=int(cfg.transit_cap), counter="stats.overflow")

        got = out_pay[:, 0].reshape(vec.shape[0], K * cfg.pkt_elems)[:, :vec.shape[1]]
        rows = torch.where(is_recv.view(-1, 1), got,
                           torch.where(keeps.view(-1, 1), vec, torch.zeros_like(vec)))
        return rows, n_steps

    def p2p(self, x, *, src, dst, comm, n_chunks: int = 1):
        """Whole message as one packet train src -> dst through the router
        (``n_chunks`` is a scheduling hint other backends use; the router's
        chunking is its packet size)."""
        del n_chunks
        if src == dst:
            return x
        return self.permute(x, comm, [(src, dst)])


@register_transport("packet:pallas")
@dataclass
class PallasPacketTransport(PacketTransport):
    """The packet backend pinned to kernel C (``router_impl="kernel"``):
    every router run is one launch of ``csrc/router.cu`` (one a tick with
    ranks as processes), on the card only.
    The key keeps the reference's name, ``"packet:pallas"``, where it pins
    the Pallas tick kernel, so comm-mode strings carry over unchanged."""

    router_impl: str | None = "kernel"
