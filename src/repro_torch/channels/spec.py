"""ChannelSpec: the single carrier of communication configuration.

The paper configures every transfer at channel-open time: peer, port,
communicator (§2.2–§2.4).  :class:`ChannelSpec` folds the port's
equivalents — transport backend, wire format, message tag, tuning plan —
into that open-time descriptor.  This slice ports the descriptor and its
transport resolution, which the halo exchange and the tensor-parallel
layers ride on; the element-level push/pop channels, port claims and
channel pools come with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..core.comm import Communicator

#: channel kinds (the reference's set)
KINDS = ("p2p", "bcast", "reduce", "scatter", "gather", "allreduce", "exchange")


@dataclass(frozen=True)
class ChannelSpec:
    """Static descriptor: the SMI_Open_*_channel arguments."""

    comm: Communicator
    kind: str = "p2p"
    #: hardware-endpoint id; ``None`` = anonymous.  Claims are not enforced
    #: until the channel slice ports the port allocator.
    port: int | None = 0
    transport: object = field(default=None, compare=False)
    wire: str = "raw"
    tag: str | None = None
    plan: object = field(default=None, compare=False)
    #: the reduction a reducing channel folds with (``None``: a plain add)
    op: object = field(default=None, compare=False)
    #: chunks a message is pipelined in
    n_chunks: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown channel kind {self.kind!r}; one of {KINDS}")
        if self.wire == "int8":
            raise NotImplementedError(
                "wire='int8' (the compressed link) comes with the "
                "compressed-wire slice of the port"
            )
        if self.wire != "raw":
            raise ValueError(f"unknown wire format {self.wire!r}; 'raw' or 'int8'")

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

    def resolve(self):
        """A Transport instance realising this spec's backend: a string
        key (or ``None``, the communicator's default) resolves to a fresh
        instance on the communicator's device; a live Transport passes
        through."""
        from ..transport.registry import resolve_transport

        return resolve_transport(self.transport, self.comm)

    def replace(self, **kw) -> "ChannelSpec":
        return replace(self, **kw)


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
