"""Per-process ring-buffer event tracer (``repro.obs.trace``).

One process holds at most one active :class:`Tracer`; producers all over the
port — channel open/close/push/pop/transfer, the halo exchange, the packet
router's schedule facts, the netsim autotuner's chosen plans, the
fault-tolerance watchdog — emit through the module-level :func:`emit`
behind the :data:`TRACING` flag.

The disabled path is the design constraint: tracing is off by default and
the port's channel ``push``/``pop`` run eagerly on every call, so a
disabled call site must cost one module-attribute load plus a bool test and
allocate *nothing*.  That is why call sites are written

    if trace.TRACING:
        trace.emit("channel.push", tag=..., port=...)

— the kwargs dict is only ever built when a tracer is live (asserted by
``tests/test_torch_obs.py`` with tracemalloc).

Event schema (the reference's, unchanged; the exporter embeds it verbatim):

    {"ts": float seconds since the tracer epoch,
     "rank": int | None          # None = host event,
     "kind": str                 # dotted producer.verb, e.g. "channel.push",
     "tag":  str | None          # the ChannelSpec / TransportStats tag,
     "port": int | None          # the channel's claimed port,
     "attrs": dict}              # producer-specific payload (JSON-safe)

Timestamps are host ``perf_counter`` times.  How the port differs from the
reference: the reference's producers run while JAX traces a program and
emit once per *python trace* (a rolled loop's body once, whatever its trip
count); the port's producers are eager and emit once per *call*, so a
32-step stencil emits 32 ``halo.start`` events where the reference's
rolled loop emits one.  An event still marks where the schedule staged
work on the host, not when the card ran it (the card's step times are the
launcher's ``run.step`` events; byte counters live in ``TransportStats``
and the metrics snapshot).
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

#: the stable event schema's keys, in canonical order
EVENT_KEYS = ("ts", "rank", "kind", "tag", "port", "attrs")

#: fast-path flag mirroring ``_TRACER is not None``; call sites test this
#: before building any kwargs so the disabled path allocates nothing
TRACING = False

_TRACER: "Tracer | None" = None


class Tracer:
    """Bounded event recorder: a deque ring buffer of schema events.

    ``capacity`` bounds memory on long runs (oldest events fall off);
    ``clock`` is injectable for deterministic tests.  All timestamps are
    relative to the tracer's construction (``t0``), so exported traces
    start near zero.
    """

    __slots__ = ("capacity", "clock", "t0", "_events")

    def __init__(self, capacity: int = 65536, clock=time.perf_counter):
        self.capacity = int(capacity)
        self.clock = clock
        self.t0 = clock()
        self._events = deque(maxlen=self.capacity)

    def now(self) -> float:
        """Seconds since the tracer epoch (the event ``ts`` base)."""
        return self.clock() - self.t0

    def event(self, kind: str, *, rank=None, tag=None, port=None,
              ts=None, **attrs):
        """Record one schema event.  ``ts=None`` stamps :meth:`now`;
        extra keyword arguments become the event's ``attrs`` payload."""
        self._events.append({
            "ts": self.now() if ts is None else float(ts),
            "rank": rank,
            "kind": kind,
            "tag": tag,
            "port": port,
            "attrs": attrs,
        })

    def events(self) -> list:
        """Snapshot of the buffer, oldest first."""
        return list(self._events)

    def kinds(self) -> set:
        return {e["kind"] for e in self._events}

    def clear(self):
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)


def enable(capacity: int = 65536, clock=time.perf_counter) -> Tracer:
    """Install (and return) a fresh process-wide tracer."""
    global _TRACER, TRACING
    _TRACER = Tracer(capacity, clock)
    TRACING = True
    return _TRACER


def disable() -> "Tracer | None":
    """Remove the active tracer (returns it, with its events intact)."""
    global _TRACER, TRACING
    t, _TRACER, TRACING = _TRACER, None, False
    return t


def get() -> "Tracer | None":
    return _TRACER


def emit(kind: str, **kw):
    """Record an event on the active tracer; no-op when tracing is off.

    Hot call sites must still guard with ``if trace.TRACING:`` *before*
    building ``kw`` — this function is the slow-path funnel, the flag test
    is the fast path."""
    t = _TRACER
    if t is not None:
        t.event(kind, **kw)


@contextmanager
def enabled(capacity: int = 65536, clock=time.perf_counter):
    """Scoped tracing: install a fresh tracer, restore the previous one
    (usually none) on exit.  Yields the tracer — its events stay readable
    after the block."""
    global _TRACER, TRACING
    prev = _TRACER
    t = enable(capacity, clock)
    try:
        yield t
    finally:
        _TRACER = prev
        TRACING = prev is not None
