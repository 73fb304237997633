"""SMI core on the rank-stacked runtime: topology, routing, communicators,
streamed collectives, the halo exchange and the packet router."""

from .comm import Communicator, ppermute, resolve_device
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
from .streaming import stream_exchange
from .topology import Topology

__all__ = [
    "LOCAL",
    "Communicator",
    "RouteTable",
    "RouterConfig",
    "Topology",
    "channel_dependency_acyclic",
    "compute_route_table",
    "make_links",
    "make_router_tables",
    "physical_link_map",
    "ppermute",
    "resolve_device",
    "run_router",
    "snake_bus",
    "stream_exchange",
]
