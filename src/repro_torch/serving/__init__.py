"""Serving (``repro.serving``): the wave engine and the continuous-batching
engine, at any tensor-parallel degree; the continuous engine's TP runtime
runs on a persistent ChannelPool with streamed slot migration."""

from .continuous import (
    MIGRATE_TAG,
    ContinuousEngine,
    copy_slot,
    migrate_gather,
    migrate_scatter,
    open_migration,
    pack_slot,
    reset_slot,
    unpack_slot,
)
from .engine import Request, ServeEngine

__all__ = ["MIGRATE_TAG", "ContinuousEngine", "Request", "ServeEngine", "copy_slot",
           "migrate_gather", "migrate_scatter", "open_migration", "pack_slot", "reset_slot",
           "unpack_slot"]
