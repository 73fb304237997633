"""Pluggable transport backends.

* :class:`~repro_torch.transport.base.Transport` — the protocol every
  backend implements: ring ``shift``, explicit-pairs ``permute``, the
  ``accumulate``/``shift_accumulate`` fold hooks, routed ``p2p``, and
  per-step cost counters.
* :func:`~repro_torch.transport.registry.get_transport` — the string-keyed
  registry: ``"static"`` (index-copy schedules), ``"fused"`` (static
  schedules whose folds run on a CUDA add kernel), ``"packet"`` /
  ``"packet:pallas"`` (every step through the packet router, kernel C) and
  ``"compressed"`` / ``"compressed:<inner>"`` (an int8 wire over any of
  them).
* :func:`~repro_torch.transport.registry.resolve_comm_mode` — parses
  ``comm_mode`` strings (``"smi:fused"``).
"""

from .base import Transport, TransportStats
from .registry import (
    available_transports,
    get_transport,
    is_transport_key,
    register_transport,
    resolve_comm_mode,
    resolve_transport,
)

__all__ = [
    "Transport",
    "TransportStats",
    "available_transports",
    "get_transport",
    "is_transport_key",
    "register_transport",
    "resolve_comm_mode",
    "resolve_transport",
]
