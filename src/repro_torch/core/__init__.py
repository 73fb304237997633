"""SMI core on the rank-stacked runtime: topology, routing, communicators,
ranks as processes (``run_spmd``), streamed collectives, the halo exchange
and the packet router.  The channel
API (``open_channel``, ``push``, ``pop``, the collective channels) is served
from :mod:`repro_torch.channels`, as ``repro.core`` serves it."""

from .comm import Communicator, PortAllocator, ppermute, resolve_device
from .router import (
    LOCAL,
    RouterConfig,
    make_links,
    make_router_tables,
    run_router,
    snake_bus,
)
from .routing import (
    RouteTable,
    channel_dependency_acyclic,
    compute_route_table,
    physical_link_map,
)
from .spmd import SpmdGroup, run_spmd
from .streaming import stream_exchange, stream_p2p
from .topology import Topology

#: channel API names served lazily from repro_torch.channels (PEP 562): the
#: channels package imports core.comm, so an eager import here would cycle
_CHANNEL_EXPORTS = (
    "Channel",
    "ChannelSpec",
    "open_channel",
    "push",
    "pop",
    "channel_transfer",
    "open_bcast_channel",
    "open_reduce_channel",
    "open_scatter_channel",
    "open_gather_channel",
    "open_allreduce_channel",
)


def __getattr__(name):
    if name in _CHANNEL_EXPORTS:
        from .. import channels

        return getattr(channels, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    *_CHANNEL_EXPORTS,
    "LOCAL",
    "Communicator",
    "PortAllocator",
    "RouteTable",
    "RouterConfig",
    "SpmdGroup",
    "Topology",
    "channel_dependency_acyclic",
    "compute_route_table",
    "make_links",
    "make_router_tables",
    "physical_link_map",
    "ppermute",
    "resolve_device",
    "run_router",
    "run_spmd",
    "snake_bus",
    "stream_exchange",
    "stream_p2p",
]
