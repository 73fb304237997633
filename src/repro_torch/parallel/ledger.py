"""CommLedger: per-tag communication accounting across one whole step
(``repro.parallel.ledger``).

The parallel layers (:mod:`repro_torch.parallel.layers`) resolve a *fresh*
transport instance per call, so no single ``TransportStats`` object
survives a prefill.  The ledger is the aggregation point that does: while a
:func:`capture` block is active, every transport the layers open mirrors its
tallies (steps, bytes, under the message tag active at the time) into one
process-level :class:`CommLedger`, and sites that communicate without a
transport (the tagged psums) tally into it directly.

The reference fills its ledger while it traces: a layer period under
``lax.scan`` traces once, so its capture holds one layer's traffic for
every per-layer tag.  The port runs every layer, so its capture of a
prefill holds every layer's traffic.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

from ..transport.base import Transport

#: the ledger (if any) currently mirroring transport tallies
_ACTIVE: "CommLedger | None" = None

#: bucket for tallies arriving outside any message tag
UNTAGGED = "untagged"


@dataclass
class CommLedger:
    """Per-tag (steps, bytes) totals across one step; bytes are one rank's."""

    steps: int = 0
    bytes_moved: int = 0
    #: tag -> {"steps": int, "bytes": int}
    by_tag: dict = field(default_factory=dict)
    #: tag -> the tuner's transport key for a planned layer (the last call's)
    plans: dict = field(default_factory=dict)
    #: id -> instance of every transport mirrored; holding the instance
    #: keeps its id from being reused by a later, fresh transport (whose
    #: tallies would then go unmirrored)
    _attached: dict = field(default_factory=dict, repr=False)

    def tally(self, tag: str | None, steps: int, nbytes: int):
        self.steps += steps
        self.bytes_moved += nbytes
        e = self.by_tag.setdefault(tag or UNTAGGED, {"steps": 0, "bytes": 0})
        e["steps"] += steps
        e["bytes"] += nbytes

    def record_plan(self, tag: str, transport_key: str):
        self.plans[tag] = transport_key

    def tag_counts(self, tag: str) -> tuple[int, int]:
        e = self.by_tag.get(tag, {"steps": 0, "bytes": 0})
        return e["steps"], e["bytes"]

    def tag_bytes(self) -> dict:
        """{tag: bytes}, sorted by tag."""
        return {tag: e["bytes"] for tag, e in sorted(self.by_tag.items())}

    def attach(self, t: Transport) -> Transport:
        """Mirror every future ``tally`` of ``t`` (and of its ``inner``
        chain) into this ledger, each under the transport's tag active at
        tally time.  Idempotent per instance; returns ``t``."""
        x = t
        while isinstance(x, Transport):
            if id(x) not in self._attached:
                self._attached[id(x)] = x
                orig = x.tally  # bound method (the class funnel)

                def mirrored(steps, nbytes, _x=x, _orig=orig):
                    _orig(steps, nbytes)
                    self.tally(_x._tag, steps, nbytes)

                x.tally = mirrored
            x = getattr(x, "inner", None)
        return t


def active() -> CommLedger | None:
    return _ACTIVE


def attach(t: Transport) -> Transport:
    """Attach ``t`` to the active ledger (no-op outside a capture)."""
    if _ACTIVE is not None:
        _ACTIVE.attach(t)
    return t


def tally(tag: str | None, steps: int, nbytes: int):
    """Direct tally for comm sites without a transport (the tagged psums);
    no-op outside a capture."""
    if _ACTIVE is not None:
        _ACTIVE.tally(tag, steps, nbytes)


def record_plan(tag: str, transport_key: str):
    """Record the tuner's backend choice for a planned layer tag; no-op
    outside a capture."""
    if _ACTIVE is not None:
        _ACTIVE.record_plan(tag, transport_key)


@contextmanager
def capture():
    """Activate a fresh ledger for the block; run the step inside it and
    read the per-tag totals off the yielded :class:`CommLedger`."""
    global _ACTIVE
    prev = _ACTIVE
    led = CommLedger()
    _ACTIVE = led
    try:
        yield led
    finally:
        _ACTIVE = prev


@contextmanager
def paused():
    """No ledger for the block: what runs in it tallies only into its own
    transports (the data groups after the first, which repeat its traffic)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = None
    try:
        yield
    finally:
        _ACTIVE = prev
