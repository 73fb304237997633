"""First-class SMI channels: the user-facing communication API (paper
§2.2–§2.4), on the rank-stacked runtime.

* :class:`ChannelSpec` — the single carrier of communication config
  (peer or root, port, transport backend, wire format, stats tag, plan);
* :func:`open_channel` — p2p channels with :meth:`~Channel.push` /
  :meth:`~Channel.pop` element pipelining (an element arrives after as many
  pops as the route has hops) and a whole-message
  :meth:`~Channel.transfer`, all through the channel's transport backend;
* :func:`open_bcast_channel` / :func:`open_reduce_channel` /
  :func:`open_scatter_channel` / :func:`open_gather_channel` /
  :func:`open_allreduce_channel` — transient collective channels whose
  ``transfer`` runs the streamed collective schedules, bit-identical to the
  direct calls on every backend;
* :data:`PORTS` — the default :class:`~repro_torch.core.comm.PortAllocator`
  every ``open_*`` claims its port from; channels are context managers and
  release the port on close or scope exit;
* :class:`ChannelPool` — the persistent lifecycle
  (``ChannelSpec(persistent=True)``): one strongly held port claim per
  layer tag, released only by an explicit close;
* :func:`default_channel_spec` — ``comm_mode="smi:<backend>"`` strings
  mapped onto their channel spec.

The deprecated ``stream_*`` entry points of :mod:`repro_torch.core` are thin
shims that open a transient anonymous-port channel.
"""

from .spec import KINDS, ChannelSpec, default_channel_spec
from .channel import (
    PORTS,
    Channel,
    channel_transfer,
    open_channel,
    pop,
    push,
)
from .collective import (
    CollectiveChannel,
    open_allreduce_channel,
    open_bcast_channel,
    open_gather_channel,
    open_reduce_channel,
    open_scatter_channel,
)
from .persistent import ChannelPool

__all__ = [
    "KINDS",
    "ChannelSpec",
    "default_channel_spec",
    "PORTS",
    "ChannelPool",
    "Channel",
    "channel_transfer",
    "open_channel",
    "pop",
    "push",
    "CollectiveChannel",
    "open_allreduce_channel",
    "open_bcast_channel",
    "open_gather_channel",
    "open_reduce_channel",
    "open_scatter_channel",
]
