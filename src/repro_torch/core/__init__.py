"""SMI core on the rank-stacked runtime: topology, routing, communicators,
streamed collectives and the halo exchange."""

from .comm import Communicator, ppermute, resolve_device
from .routing import (
    RouteTable,
    channel_dependency_acyclic,
    compute_route_table,
    physical_link_map,
)
from .streaming import stream_exchange
from .topology import Topology

__all__ = [
    "Communicator",
    "RouteTable",
    "Topology",
    "channel_dependency_acyclic",
    "compute_route_table",
    "physical_link_map",
    "ppermute",
    "resolve_device",
    "stream_exchange",
]
