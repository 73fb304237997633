"""Persistent channel pool: open-once, serve-forever SMI channels.

The transient lifecycle (open, claim, transfer, close, once a call) renders
the paper's listings, but a decode loop running millions of steps would pay
a port claim a step.  A :class:`ChannelPool` is the pre-established
context: one ``ChannelSpec(persistent=True)`` a layer tag, its port claim
held strongly by the allocator (``claim(persistent=True)``), so it outlives
every channel and call that used it, and each layer re-tagged under the
pool's prefix (default ``"serve."``), so serving traffic keeps its own stats
buckets.  Transport instances still resolve fresh from the spec a call:
persistence is the claim and the spec, not a live backend.

A serving runtime creates one pool, passes it as ``ParallelCtx(channels=
pool)`` so every ``layer_spec`` resolves to the pool's spec for its tag,
and releases every claim with :meth:`ChannelPool.close` (or a ``with``
scope) at shutdown.
"""

from __future__ import annotations

from ..core.comm import Communicator, PortAllocator
from .channel import PORTS, _claim
from .spec import ChannelSpec


class ChannelPool:
    """Per-tag registry of persistent channel specs on one communicator.

    Ports are assigned sequentially from ``base_port`` in first-request
    order, so a fixed architecture claims the same ports on every start.
    """

    def __init__(self, comm: Communicator, *, prefix: str = "serve.", base_port: int = 100,
                 transport=None, wire: str = "raw", plan=None,
                 allocator: PortAllocator | None = None):
        self.comm = comm
        self.prefix = prefix
        self.transport = transport
        self.wire = wire
        self.plan = plan
        self.allocator = allocator if allocator is not None else PORTS
        self._specs: dict[str, ChannelSpec] = {}
        self._next_port = base_port
        self.closed = False

    # -- tag namespace -------------------------------------------------------

    def retag(self, tag: str) -> str:
        """The pool's stats bucket for a layer tag (idempotent)."""
        return tag if tag.startswith(self.prefix) else self.prefix + tag

    # -- spec registry -------------------------------------------------------

    def spec(self, tag: str, *, kind: str = "allreduce", wire: str | None = None, plan=None,
             transport=None, n_chunks: int = 1, op=None, key: str | None = None) -> ChannelSpec:
        """The persistent spec for ``tag``: created, and its port claimed
        strongly, on the first request, returned as it is afterwards.
        ``key`` overrides the registry key (default: the retagged tag) so
        two channels of different kinds can share one stats tag."""
        if self.closed:
            raise RuntimeError("ChannelPool is closed")
        full = self.retag(tag)
        k = key if key is not None else full
        s = self._specs.get(k)
        if s is None:
            port = self._next_port
            self._next_port += 1
            s = _claim(ChannelSpec(
                comm=self.comm, kind=kind, tag=full, port=port, persistent=True,
                wire=wire if wire is not None else self.wire,
                plan=plan if plan is not None else self.plan,
                transport=transport if transport is not None else self.transport,
                n_chunks=n_chunks, op=op), self.allocator)
            self._specs[k] = s
        return s

    def specs(self) -> dict[str, ChannelSpec]:
        """{retagged tag: persistent spec} opened so far."""
        return dict(self._specs)

    def ports(self) -> dict[str, int]:
        return {tag: s.port for tag, s in self._specs.items()}

    def claims(self) -> tuple[dict, ...]:
        """The pool's live claims as the allocator sees them: the
        :meth:`~repro_torch.core.comm.PortAllocator.claims` rows owned by
        this pool's specs (port-ordered); empty after close."""
        own = {id(s) for s in self._specs.values()}
        return tuple(r for r in self.allocator.claims(self.comm) if id(r["owner"]) in own)

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, tag: str) -> bool:
        return self.retag(tag) in self._specs

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Release every persistent claim (idempotent: a second close never
        releases a later claimant's ports).  The only way a persistent port
        comes back."""
        if self.closed:
            return
        self.closed = True
        for s in self._specs.values():
            s.release_port()
        self._specs.clear()

    def __enter__(self) -> "ChannelPool":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        # a pool collected with live claims would leak its persistent ports
        # for good: release them (the reference also emits an ``ft.leak``
        # event, which comes with the port of its event stream)
        try:
            if getattr(self, "closed", True) or not self._specs:
                return
            self.close()
        except Exception:
            pass  # interpreter teardown: modules may already be gone
