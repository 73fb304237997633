"""Serving at tensor-parallel degree 1 (``repro.serving``): the wave engine
and the continuous-batching engine."""

from .continuous import ContinuousEngine, copy_slot, pack_slot, reset_slot, unpack_slot
from .engine import Request, ServeEngine

__all__ = ["ContinuousEngine", "Request", "ServeEngine", "copy_slot", "pack_slot", "reset_slot",
           "unpack_slot"]
