"""Communicators on the rank-stacked runtime (paper §3.1: ranks, communicators).

``repro`` runs SPMD inside ``jax.shard_map``: each device holds one rank's
shard, the rank is ``lax.axis_index`` and a link step is ``lax.ppermute``.
The port runs all P ranks on one card instead.  Every distributed tensor
carries a leading rank dimension ``(P, ...)``; row ``r`` is what rank ``r``
would hold.  Then:

* :meth:`Communicator.rank` is ``torch.arange(P)``, shaped to broadcast
  against a rank-stacked tensor, so a per-rank predicate
  (``jnp.where(r == root, ...)`` in the reference) is one broadcast
  ``torch.where``;
* :func:`ppermute` is an index copy along dim 0; ranks that receive
  nothing get zeros, exactly as ``lax.ppermute`` gives them.

A multi-card ``torch.distributed`` rendering of the same interface is later
work; the schedules written against it do not change.
"""

from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass, field, replace

import torch

from .routing import RouteTable, compute_route_table
from .topology import Topology


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for and there is no card — the port
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@functools.lru_cache(maxsize=1024)
def _pair_index(pairs: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) index tensors of a permutation on ``device``, made once:
    a copy from pageable host memory to the card synchronises the stream,
    so a schedule that rebuilt them every step would stall the host."""
    src = torch.tensor([s for s, _ in pairs], device=device)
    dst = torch.tensor([d for _, d in pairs], device=device)
    return src, dst


@functools.lru_cache(maxsize=1024)
def _full_gather(pairs: tuple, n: int, device: torch.device):
    """How a permutation that delivers to every rank ``0..n-1`` exactly once
    is one gather: ``("roll", k)`` when it is the ring rotation ``out[d] =
    x[(d - k) % n]``, else ``("index", the source of each rank)``; ``None``
    for a permutation that leaves a rank without data."""
    srcs = dict((d, s) for s, d in pairs)
    if len(pairs) != n or sorted(srcs) != list(range(n)):
        return None
    order = [srcs[d] for d in range(n)]
    k = -order[0] % n
    if all(order[d] == (d - k) % n for d in range(n)):
        return "roll", k
    return "index", torch.tensor(order, device=device)


def ppermute(x: torch.Tensor, pairs) -> torch.Tensor:
    """Move rank rows of ``x`` along (src, dst) pairs: ``out[dst] = x[src]``,
    zeros on every rank that is no destination (``lax.ppermute``'s
    semantics).  A permutation that reaches every rank is one copy (a ring
    shift copies two contiguous slices); any other fills zeros and copies
    the rows that move.  ``x`` is not modified."""
    pairs = tuple(pairs)
    full = _full_gather(pairs, x.shape[0], x.device) if pairs else None
    if full is not None:
        kind, arg = full
        if kind == "index":
            return x.index_select(0, arg)
        return torch.cat((x[x.shape[0] - arg:], x[:x.shape[0] - arg])) if arg else x.clone()
    out = torch.zeros_like(x)
    if pairs:
        src, dst = _pair_index(pairs, x.device)
        out.index_copy_(0, dst, x.index_select(0, src))
    return out


@dataclass(frozen=True)
class Communicator:
    """SMI_Comm: ``size`` ranks stacked on ``device`` with a routed topology.

    ``axis_names``/``axis_sizes`` name the rank grid as the reference's mesh
    axes do (row-major linearisation); ``transport`` names the default
    message-moving backend (see :mod:`repro_torch.transport`).
    """

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    topology: Topology
    route_table: RouteTable
    name: str = "world"
    transport: str = "static"
    device: torch.device = torch.device("cuda")

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(
        axis_names,
        axis_sizes,
        topology: Topology | None = None,
        routing_scheme: str = "auto",
        name: str = "world",
        transport: str = "static",
        device=None,
    ) -> "Communicator":
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        axis_sizes = tuple(int(s) for s in axis_sizes)
        n = 1
        for s in axis_sizes:
            n *= s
        if topology is None:
            topology = Topology.torus(axis_sizes)
        if topology.n_ranks != n:
            raise ValueError(
                f"topology has {topology.n_ranks} ranks but axes "
                f"{axis_names} give {n}"
            )
        rt = compute_route_table(topology, scheme=routing_scheme)
        return Communicator(
            axis_names, axis_sizes, topology, rt, name=name,
            transport=transport, device=resolve_device(device),
        )

    def with_topology(self, topology: Topology, routing_scheme: str = "auto") -> "Communicator":
        """Re-route over a new logical topology without changing the program
        structure — the paper's 'recompute routes, keep the bitstream'."""
        rt = compute_route_table(topology, scheme=routing_scheme)
        return replace(self, topology=topology, route_table=rt)

    def with_transport(self, transport: str) -> "Communicator":
        """Same ranks/routes, different message-moving backend."""
        return replace(self, transport=transport)

    def plan(self, op: str, nbytes: int):
        """The netsim tuner's decision in the reference; not ported yet."""
        raise NotImplementedError(
            "Communicator.plan (the netsim tuner, plan='auto') comes with "
            "the tuner slice of the port; pass plan=None or a Plan"
        )

    # -- rank queries --------------------------------------------------------

    @property
    def size(self) -> int:
        return self.topology.n_ranks

    def rank(self, ndim: int = 1) -> torch.Tensor:
        """SMI_Comm_rank of every stacked rank: ``arange(P)`` shaped
        ``(P, 1, ..., 1)`` with ``ndim`` dims, to broadcast against a
        rank-stacked tensor of that many dims."""
        r = torch.arange(self.size, device=self.device)
        return r.view((self.size,) + (1,) * (ndim - 1))

    # ring helpers over the linearised rank order -----------------------------

    def ring_perm(self, step: int = 1) -> list[tuple[int, int]]:
        """Ring permutation (+step along linearised ranks, wrap-around)."""
        n = self.size
        return [(i, (i + step) % n) for i in range(n)]

    def path_perm(self, path: list[int]) -> list[tuple[int, int]]:
        """Pipeline permutation along a routed path (each hop advances)."""
        return list(zip(path[:-1], path[1:]))


@dataclass
class PortAllocator:
    """Ports name distinct hardware endpoints (paper §2.2); this allocator
    hands out unique port ids per communicator and raises on reuse, the
    software analogue of two kernels contending for one hardware FIFO.

    :func:`repro_torch.channels.open_channel` claims through the package's
    default allocator (``repro_torch.channels.PORTS``): opening a channel
    claims its port, closing it (or leaving its ``with`` scope) releases
    it.  A claim may carry an *owner*, the opening
    :class:`~repro_torch.channels.ChannelSpec`, held by weak reference: in
    the reference a claim lapses when the trace that opened it is
    collected; here it lapses when the last channel object holding the spec
    is, so a loop that opens channels without closing them does not poison
    the allocator.  Ownerless claims (the bare ``claim(comm, port)``) last
    until released.

    A *persistent* claim (``claim(..., persistent=True)``, the
    ``ChannelSpec(persistent=True)`` lifecycle of a
    :class:`~repro_torch.channels.ChannelPool`) holds its owner strongly:
    it outlives every channel that used it and goes only by an explicit
    owner release or ``release_all``.

    Claims are keyed per communicator *instance*: two communicators may both
    use port 0 (different route fabrics), but one communicator's port 0 is
    one endpoint.
    """

    #: id(comm) -> {port: owner weakref (transient) | owner (persistent) |
    #: None (ownerless)}
    used: dict = field(default_factory=dict)
    #: id(comm) -> [weakrefs to anonymous (port=None) channel specs]: no
    #: claim, but :meth:`claims` reports them while they live
    anonymous: dict = field(default_factory=dict)

    def _ports(self, comm: Communicator) -> dict:
        key = id(comm)
        if key not in self.used:
            self.used[key] = {}
            # drop the bucket when the communicator itself is collected
            weakref.finalize(comm, self.used.pop, key, None)
        return self.used[key]

    @staticmethod
    def _owner_of(entry):
        """(live, owner) of a claim entry: ownerless entries are live with
        no owner; weakref entries live while their referent does; strong
        (persistent) entries always."""
        if entry is None:
            return True, None
        if isinstance(entry, weakref.ref):
            cur = entry()
            return cur is not None, cur
        return True, entry

    def claim(self, comm: Communicator, port: int, owner=None,
              persistent: bool = False) -> int:
        ports = self._ports(comm)
        if port in ports and self._owner_of(ports[port])[0]:
            raise ValueError(
                f"port {port} already claimed on communicator {comm.name!r}; SMI "
                "ports identify distinct hardware endpoints and cannot be shared — "
                "close the other channel (or pick another port) first")
        if owner is None:
            ports[port] = None
        else:
            ports[port] = owner if persistent else weakref.ref(owner)
        return port

    def release(self, comm: Communicator, port: int, owner=None) -> None:
        """Release ``port``: only the claim ``owner`` holds (or, with
        ``owner=None``, an ownerless or lapsed claim).  A stale release — a
        second ``close()`` after another channel claimed the port — never
        frees another owner's claim."""
        ports = self.used.get(id(comm), {})
        if port not in ports:
            return
        entry = ports[port]
        _, cur = self._owner_of(entry)
        if owner is not None:
            if entry is None or (cur is not None and cur is not owner):
                return  # ownerless, or another live owner holds the port now
        elif cur is not None:
            return  # a bare release frees only ownerless or lapsed claims
        ports.pop(port, None)

    def release_all(self, comm: Communicator) -> None:
        self.used.pop(id(comm), None)

    def in_use(self, comm: Communicator) -> tuple[int, ...]:
        """Ports currently claimed (live owners or ownerless) on ``comm``."""
        ports = self.used.get(id(comm), {})
        return tuple(sorted(p for p, e in ports.items() if self._owner_of(e)[0]))

    def note_anonymous(self, comm: Communicator, owner) -> None:
        """Register an anonymous (``port=None``) channel's spec, weakly: it
        holds no claim, but :meth:`claims` lists it while it lives."""
        key = id(comm)
        refs = self.anonymous.get(key)
        if refs is None:
            refs = self.anonymous[key] = []
            weakref.finalize(comm, self.anonymous.pop, key, None)
        refs[:] = [r for r in refs if r() is not None]  # prune the dead
        refs.append(weakref.ref(owner))

    def claims(self, comm: Communicator) -> tuple[dict, ...]:
        """Every live claim on ``comm``, port-ordered, then one row per live
        anonymous channel: ``{"port", "persistent", "anonymous", "tag",
        "kind", "owner"}`` (``tag``/``kind`` from the owning spec; an
        ownerless claim has ``owner=None``)."""

        def row(port, persistent, anonymous, owner):
            return {"port": port, "persistent": persistent, "anonymous": anonymous,
                    "tag": getattr(owner, "stats_tag", getattr(owner, "tag", None)),
                    "kind": getattr(owner, "kind", None), "owner": owner}

        rows = []
        for port, entry in sorted(self.used.get(id(comm), {}).items()):
            live, owner = self._owner_of(entry)
            if live:
                persistent = entry is not None and not isinstance(entry, weakref.ref)
                rows.append(row(port, persistent, False, owner))
        for ref in self.anonymous.get(id(comm), []):
            owner = ref()
            if owner is not None:
                rows.append(row(None, False, True, owner))
        return tuple(rows)
