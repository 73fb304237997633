"""ChannelSpec: the single carrier of communication configuration.

The paper configures every transfer at channel-open time: peer, port,
communicator (§2.2–§2.4).  :class:`ChannelSpec` folds the port's
equivalents into that open-time descriptor, so a channel *is* its
communication config:

* ``port`` — the hardware-endpoint id, claimed through a
  :class:`~repro_torch.core.comm.PortAllocator` when a channel opens
  (``None``: anonymous, no claim);
* ``transport`` — a registry key, a live Transport instance, or ``None``
  (the communicator's default backend);
* ``wire`` — ``"raw"`` | ``"int8"``: an int8 wire composes the transport
  with the compressed link, as a tuned Plan's wire does;
* ``tag`` — the TransportStats bucket every step of the channel is
  accounted under (default ``"port<N>"`` for a numbered port);
* ``plan`` — ``None`` | ``"auto"`` | a Plan: defers backend and chunk
  count (a collective channel's schedule too) to the plan, ``"auto"`` to
  the netsim tuning table under the channel kind's op.

Under :func:`repro_torch.analysis.capture` every resolution yields the
abstract accounting backend instead (:meth:`ChannelSpec.resolve`,
:meth:`ChannelSpec.step_transport`, and ``transport.get_transport``).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field, replace

from ..core.comm import Communicator

#: channel kinds (the reference's set)
KINDS = ("p2p", "bcast", "reduce", "scatter", "gather", "allreduce", "exchange")


@dataclass(frozen=True)
class ChannelSpec:
    """Static descriptor: the SMI_Open_*_channel arguments."""

    comm: Communicator
    kind: str = "p2p"
    #: elements the channel carries (``None``: unbounded); validity gates on
    #: ``min(count, pushed)``
    count: int | None = None
    src: int = 0
    dst: int = 0
    root: int = 0
    #: claimed hardware endpoint id; ``None``: anonymous (no claim)
    port: int | None = 0
    #: persistent lifecycle: the allocator holds the claim strongly, and
    #: only an explicit close (a pool's) releases it
    persistent: bool = False
    transport: object = field(default=None, compare=False)
    wire: str = "raw"
    tag: str | None = None
    plan: object = field(default=None, compare=False)
    #: the reduction a reducing channel folds with (``None``: a plain add)
    op: object = field(default=None, compare=False)
    #: chunks a message is pipelined in
    n_chunks: int = 1
    #: the allocator holding this spec's port claim (set when it opens)
    allocator: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown channel kind {self.kind!r}; one of {KINDS}")
        if self.wire not in ("raw", "int8"):
            raise ValueError(f"unknown wire format {self.wire!r}; 'raw' or 'int8'")

    # -- route queries (p2p) ------------------------------------------------

    @property
    def path(self) -> list[int]:
        return self.comm.route_table.path(self.src, self.dst)

    @property
    def hops(self) -> int:
        return len(self.path) - 1

    # -- stats tagging -------------------------------------------------------

    @property
    def stats_tag(self) -> str | None:
        """The TransportStats bucket this channel accounts under: an
        explicit ``tag``, else ``"port<N>"`` for a numbered port, else
        ``None`` (untagged)."""
        if self.tag is not None:
            return self.tag
        if self.port is not None:
            return f"port{self.port}"
        return None

    # -- transport resolution ------------------------------------------------

    @property
    def transport_key(self) -> str:
        """Registry key realising this spec's backend and wire (a live
        instance's key is rebuilt from its chain)."""
        t = self.transport
        if t is None:
            t = self.comm.transport
        if not isinstance(t, str):
            t = _instance_key(t)
        return _compose_wire(t, self.wire)

    def resolve(self):
        """A Transport instance realising this spec's backend and wire: a
        string key (or ``None``, the communicator's default) resolves to a
        fresh instance on the communicator's device; a live instance passes
        through, wrapped in the compressed link when ``wire="int8"``.

        Under :func:`repro_torch.analysis.capture` every resolution — string
        key, ``None`` *and* live instance — yields the abstract accounting
        backend instead: the seam that lets capture mode run whole programs
        without moving a byte."""
        cap = sys.modules.get("repro_torch.analysis.capture")
        if cap is not None and cap.ACTIVE:
            return cap.AbstractTransport(device=self.comm.device)
        from ..transport.base import Transport
        from ..transport.registry import get_transport

        t = self.transport
        if isinstance(t, Transport):
            if self.wire == "int8" and not getattr(t, "lossy_wire", False):
                from ..transport.compressed import CompressedTransport

                return CompressedTransport(inner=t)
            return t
        key = t if t is not None else self.comm.transport
        return get_transport(_compose_wire(key, self.wire), device=self.comm.device)

    def step_transport(self):
        """The instance the element-level push/pop pipeline drives: resolved
        once per spec, so a channel's counters accumulate in one place.
        Capture mode uses a cache slot of its own, so a spec resolved both
        inside and outside a capture block never hands the wrong backend to
        either."""
        cap = sys.modules.get("repro_torch.analysis.capture")
        slot = ("_abstract_step_transport" if cap is not None and cap.ACTIVE
                else "_step_transport")
        cached = self.__dict__.get(slot)
        if cached is None:
            cached = self.resolve()
            object.__setattr__(self, slot, cached)
        return cached

    # -- lifecycle -----------------------------------------------------------

    def release_port(self):
        """Release this spec's port claim (idempotent; a stale double release
        never frees a later claimant's port)."""
        if self.allocator is not None and self.port is not None:
            self.allocator.release(self.comm, self.port, owner=self)

    def replace(self, **kw) -> "ChannelSpec":
        return replace(self, **kw)


def _instance_key(t) -> str:
    """The registry key of a live Transport chain
    (``CompressedTransport(inner=PacketTransport)`` -> ``"compressed:packet"``)."""
    name = getattr(t, "name", "") or type(t).__name__
    inner = getattr(t, "inner", None)
    if inner is not None and getattr(t, "wraps_inner", False):
        return f"{name}:{_instance_key(inner)}"
    return name


def _compose_wire(key: str, wire: str) -> str:
    """A backend key composed with a wire format, spelt as a tuned Plan
    spells it: an int8 wire wraps the backend in the compressed link."""
    if wire == "raw" or key.partition(":")[0] == "compressed":
        return key
    return f"compressed:{key}"


def default_channel_spec(comm: Communicator, comm_mode: str | None = None,
                         **overrides) -> ChannelSpec:
    """The ChannelSpec a ``comm_mode`` string denotes: ``"smi:<backend>"``
    maps onto a spec carrying that transport key (``"smi"`` = the default
    backend)."""
    if comm_mode is not None:
        from ..transport.registry import resolve_comm_mode

        base, backend = resolve_comm_mode(comm_mode)
        if base != "smi":
            raise ValueError(f"only smi comm_modes map onto channels; got {comm_mode!r}")
        overrides.setdefault("transport", backend)
    return ChannelSpec(comm=comm, **overrides)
