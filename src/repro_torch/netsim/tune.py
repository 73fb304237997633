"""Copy of the ``Plan`` record of ``repro.netsim.tune``.

A Plan names which backend moves the bytes, how many chunks ride the
pipeline, which schedule shape a collective uses and the wire format.  The
port's dispatchers take ``plan=None`` (the static default) or a Plan; the
tuner that picks one (``plan="auto"``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Plan:
    """One tuned decision (see ``repro.netsim.tune.Plan``)."""

    transport: str = "static"
    n_chunks: int = 1
    algo: str = "ring"
    wire: str = "raw"

    @property
    def transport_key(self) -> str:
        """Registry key realising this plan's wire format: an ``"int8"``
        wire wraps the inner backend in the compressed-link transport."""
        if self.wire == "raw":
            return self.transport
        return f"compressed:{self.transport}"

    def clamp_chunks(self, leading_dim: int) -> int:
        """Largest divisor of ``leading_dim`` <= the tuned chunk count."""
        from .model import clamp_chunks

        return clamp_chunks(self.n_chunks, leading_dim)


DEFAULT_PLAN = Plan("static", 1, "ring")
