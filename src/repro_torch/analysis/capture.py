"""Capture mode: record channel programs without moving a byte
(``repro.analysis.capture``).

Inside :func:`capture`, the channel API becomes an abstract interpreter of
itself:

* every ``ChannelSpec.resolve()`` / ``step_transport()`` /
  ``get_transport()`` hands back an :class:`AbstractTransport` — a backend
  whose steps account into the capture ledger and return zeros of the
  port's rank-stacked shapes, so the program runs (channel opens, pushes,
  pops, transfers, pool claims) while **no message moves**;
* every channel op records a :class:`~repro_torch.analysis.ops.ChannelOp`
  into the active :class:`~repro_torch.analysis.ops.CaptureLedger` (the
  ``if _capture.ACTIVE:`` guards in ``repro_torch/channels`` beside the
  ``if obs.TRACING:`` tracing hooks);
* ``Transport.tally`` — the single accounting funnel every *real* backend
  reports through — is class-patched to count into ``ledger.real_steps``,
  which must stay 0: the assertable no-comm-executed contract.

The reference traces a program (``jit(...).lower``) inside the block, so
nothing executes and a rolled loop's body records once.  The port has no
tracer: a captured program runs eagerly, its compute on its own device (a
kernel launches where the program launches it), and every channel op is
recorded each time it runs — a k-step loop records k times the one-step
pattern.  The tagged psums of ``parallel/layers.py`` stay sums over the
rank dimension (they move through no transport; the comm ledger counts
them).

The guards make capture strictly opt-in: while ``ACTIVE`` is False (always,
unless a :func:`capture` block is running) the channel layer pays one
module-attribute check an op and nothing else.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from ..transport.base import Transport, rank_bytes
from .ops import CaptureLedger, ChannelOp

#: True while a :func:`capture` block is running (the channel layer's guard)
ACTIVE = False

#: the ledger the running capture records into (None outside capture)
LEDGER: CaptureLedger | None = None

#: the unpatched accounting funnel (bound at import, before any patching)
_REAL_TALLY = Transport.tally

#: directories whose frames are skipped when attributing a source location
#: (the channel machinery itself is never the interesting line)
_SKIP_DIRS = (
    os.sep + os.path.join("repro_torch", "analysis") + os.sep,
    os.sep + os.path.join("repro_torch", "channels") + os.sep,
)


def dtype_name(dtype) -> str:
    """A dtype spelt as the reference's ledger spells it (``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def source_location(skip: int = 1) -> str | None:
    """``file.py:line`` of the nearest caller outside the channel machinery
    (repo-relative when under the working tree)."""
    f = sys._getframe(skip)
    while f is not None:
        fn = f.f_code.co_filename
        if not any(d in fn for d in _SKIP_DIRS):
            rel = os.path.relpath(fn)
            if not rel.startswith(".."):
                fn = rel
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


def _comm_name(comm) -> str:
    """Cross-rank channel identity needs the communicator's identity; the
    name plus the instance id separates two comms that share a name."""
    return f"{getattr(comm, 'name', 'world')}#{id(comm):x}"


def record(op: str, spec=None, **over):
    """Record one channel op against the active ledger (no-op when no
    capture is running — callers guard on ``ACTIVE`` anyway)."""
    led = LEDGER
    if led is None:
        return
    kw: dict = {}
    if spec is not None:
        comm = spec.comm
        try:
            tkey = spec.transport_key
        except Exception:
            tkey = None
        kw = dict(chan=led.chan_id(spec), kind=spec.kind, port=spec.port, tag=spec.stats_tag,
                  comm=_comm_name(comm), size=comm.size, src=spec.src, dst=spec.dst,
                  root=spec.root, count=spec.count, wire=spec.wire, transport=tkey,
                  persistent=spec.persistent)
    kw.update(over)
    kw.setdefault("location", source_location(skip=2))
    led.add(ChannelOp(op=op, **kw))


def _zeros(x):
    return tuple(torch.zeros_like(v) for v in x) if isinstance(x, tuple) else torch.zeros_like(x)


@dataclass
class AbstractTransport(Transport):
    """The no-op backend capture substitutes for every real one.

    Schedule-shaped: ``permute`` accounts one link step carrying one rank's
    row, ``p2p`` the chunk-pipelined ``n_chunks + hops - 1`` steps of the
    routed pipe — the real backends' cost formulae — but every step
    returns zeros of the rank-stacked input's shape instead of moving it.
    Tallies land in ``ledger.transport_steps`` (per tag), never in
    ``real_steps``.
    """

    name = "abstract"

    def permute(self, x, comm, pairs):
        self.account(x)
        return _zeros(x)

    def p2p(self, x, *, src, dst, comm, n_chunks: int = 1):
        if src == dst:
            return x
        hops = len(comm.route_table.path(src, dst)) - 1
        self.tally(n_chunks + hops - 1, rank_bytes(x))
        return _zeros(x)

    def tally(self, steps: int, nbytes: int):
        led = LEDGER
        if led is not None:
            led.tally_abstract(self._tag, steps, nbytes)
        _REAL_TALLY(self, steps, nbytes)  # per-instance stats stay coherent


def _counting_tally(self, steps: int, nbytes: int):
    """The :func:`capture`-time ``Transport.tally``: any *real* backend
    stepping during capture is exactly what capture exists to prevent, so
    it is counted (and asserted zero by the acceptance tests)."""
    led = LEDGER
    if led is not None and not isinstance(self, AbstractTransport):
        led.real_steps += steps
    _REAL_TALLY(self, steps, nbytes)


@contextmanager
def capture(size: int | None = None):
    """Record every channel op under the block into a fresh ledger.

    Run the program inside the block; no message moves.  Not reentrant —
    the ledger is process-global, like the obs tracer beside it.

    >>> with capture() as led:
    ...     art["step"](state, batch)
    >>> assert led.real_steps == 0
    >>> diags = verify_ledger(led)
    """
    global ACTIVE, LEDGER
    if ACTIVE:
        raise RuntimeError("capture() blocks do not nest")
    led = CaptureLedger()
    if size is not None:
        led.size = int(size)
    prev_tally = Transport.tally
    Transport.tally = _counting_tally
    ACTIVE, LEDGER = True, led
    try:
        yield led
    finally:
        ACTIVE = False
        LEDGER = None
        Transport.tally = prev_tally
