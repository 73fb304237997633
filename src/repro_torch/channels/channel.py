"""Point-to-point transient channels (paper Listing 1, §2.2–§2.3).

A :class:`Channel` is rank-stacked state — a 1-deep pipe register on every
rank of the route plus progress counters — described by a static
:class:`~repro_torch.channels.spec.ChannelSpec`.  Element-level
:meth:`~Channel.push` / :meth:`~Channel.pop` advance the pipeline one hop a
pop, so an element arrives after as many pops as the route has hops (paper
Tab. 3) and a consumer loop gates its tail on the returned ``valid`` bits.
Whole-message :meth:`~Channel.transfer` hands the payload to the
transport's chunk-pipelined ``p2p``.

Both paths move bytes through the channel's transport backend — the spec's
key or instance, or the communicator's default — so packet-routed and
int8-compressed channels exist: a pop over ``transport="packet"`` is one
router run, and every step is accounted under the channel's stats tag.

Opening claims the spec's port through a
:class:`~repro_torch.core.comm.PortAllocator` (``port=None``: anonymous, no
claim); closing it, explicitly or by leaving its ``with`` scope, releases
it.  ``push`` and ``pop`` return a new channel and leave the old one as it
was, as the reference's do, so a loop carries the channel.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

from ..core.comm import Communicator, PortAllocator
from .spec import ChannelSpec

#: the package-level default allocator open_* claims ports from
PORTS = PortAllocator()


@contextmanager
def _tagged(t, tag: str | None):
    """Account the block under ``tag`` (no-op for untagged channels)."""
    if tag is None:
        yield t
    else:
        with t.tagged(tag):
            yield t


def _claim(spec: ChannelSpec, allocator) -> ChannelSpec:
    """Claim the spec's port, owned by the spec (held weakly, so the claim
    lapses with the last channel object holding the spec, unless the spec
    is ``persistent``), and remember the allocator."""
    alloc = allocator if allocator is not None else PORTS
    spec = spec.replace(allocator=alloc)
    if spec.port is None:
        # no claim to hold, but claims() can report the channel
        alloc.note_anonymous(spec.comm, spec)
        return spec
    alloc.claim(spec.comm, spec.port, owner=spec, persistent=spec.persistent)
    return spec


def _rank_mask(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``(P,)`` predicate shaped to broadcast against rank-stacked ``like``."""
    return pred.view((-1,) + (1,) * (like.dim() - 1))


def _mask_sel(pred, a, b):
    """``where(pred, a, b)`` with a ``(P,)`` rank predicate."""
    return torch.where(_rank_mask(pred, b), a, b)


def _stacked(elem, like: torch.Tensor) -> torch.Tensor:
    """``elem`` as a rank-stacked tensor like ``like``: an element of the
    channel's shape goes to every rank; a rank-stacked one stays as it is."""
    e = torch.as_tensor(elem, dtype=like.dtype, device=like.device)
    return e.expand_as(like) if e.dim() < like.dim() else e


class _ChannelBase:
    """close / context-manager plumbing shared by every channel kind."""

    def close(self):
        """Release the channel's port claim (idempotent)."""
        self.spec.release_port()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _resolve_transfer(self, x, n_chunks):
        """(transport, n_chunks) for one whole-message transfer: the spec's
        plan, when it has one, picks backend and chunk count (a tuned int8
        wire moves integer payloads raw); an explicit spec transport wins
        over the plan's backend.  ``plan="auto"`` raises until the tuner is
        ported."""
        spec = self.spec
        nc = n_chunks if n_chunks is not None else spec.n_chunks
        if spec.plan is None:
            return spec.resolve(), nc
        from ..core.collectives import _resolve_plan

        plan = _resolve_plan(spec.plan, x)
        if spec.transport is None and spec.wire == "raw":
            t = spec.replace(transport=plan.transport_key).resolve()
        else:
            t = spec.resolve()
        return t, plan.clamp_chunks(x.shape[1])


@dataclass
class Channel(_ChannelBase):
    """Rank-stacked p2p channel state: ``pipe`` ``(P, *elem_shape)`` holds
    each rank's in-flight element; ``valid`` float32 ``(P,)`` (0/1, so it
    rides every wire, the int8 one included, exactly) marks a live element;
    ``pushed``/``popped`` int32 ``(P,)`` count accepted pushes at the source
    and valid deliveries at the destination."""

    spec: ChannelSpec
    pipe: torch.Tensor
    valid: torch.Tensor
    pushed: torch.Tensor
    popped: torch.Tensor

    # -- element level -------------------------------------------------------

    def push(self, elem) -> "Channel":
        """SMI_Push: stage ``elem`` into the pipe at the source rank.

        ``elem`` is one element of the channel's shape (the source's) or a
        rank-stacked ``(P, *elem_shape)`` tensor of which the source's row
        counts.  The element starts moving on the next :meth:`pop`."""
        at_src = self.spec.comm.rank() == self.spec.src
        return Channel(
            self.spec,
            _mask_sel(at_src, _stacked(elem, self.pipe), self.pipe),
            torch.where(at_src, 1.0, self.valid).to(self.valid.dtype),
            self.pushed + at_src.to(torch.int32),
            self.popped,
        )

    def pop(self):
        """SMI_Pop: advance the pipeline one hop and extract.

        Returns ``(chan', value, valid)``, ``value`` rank-stacked and
        ``valid`` a ``(P,)`` bool: the first element pushed arrives after
        ``hops`` pops, so a consumer loop runs ``count + hops - 1`` pops and
        gates on ``valid`` (true at the destination only).  The hop moves
        the pipe and valid registers as one step of the channel's transport,
        accounted under its stats tag.  A bounded channel (``count`` set)
        delivers at most ``count`` valid elements."""
        spec = self.spec
        pairs = spec.comm.path_perm(spec.path)
        t = spec.step_transport()
        with _tagged(t, spec.stats_tag):
            moved, moved_valid = t.permute((self.pipe, self.valid), spec.comm, pairs)
        valid = (spec.comm.rank() == spec.dst) & (moved_valid > 0.5)
        if spec.count is not None:
            valid = valid & (self.popped < spec.count)
        new = Channel(spec, moved, moved_valid, self.pushed,
                      self.popped + valid.to(torch.int32))
        return new, moved, valid

    # -- transfer level ------------------------------------------------------

    def transfer(self, x: torch.Tensor, n_chunks: int | None = None) -> torch.Tensor:
        """Whole-message streamed transfer: row ``src`` of the rank-stacked
        ``x`` delivered to row ``dst`` along the routed path through the
        channel's transport (``n_chunks`` chunks along dim 1 in flight; the
        spec's plan may pick backend and chunk count); zeros elsewhere."""
        spec = self.spec
        t, nc = self._resolve_transfer(x, n_chunks)
        with _tagged(t, spec.stats_tag):
            return t.p2p(x, src=spec.src, dst=spec.dst, comm=spec.comm, n_chunks=nc)


def open_channel(comm: Communicator, *, count: int | None = None, src: int = 0, dst: int = 0,
                 port: int | None = 0, elem_shape=(), dtype=torch.float32, transport=None,
                 wire: str = "raw", tag: str | None = None, plan=None, n_chunks: int = 1,
                 allocator: PortAllocator | None = None) -> Channel:
    """SMI_Open_send_channel / SMI_Open_recv_channel.

    Claims ``port`` on the allocator (two open channels cannot share a port;
    ``port=None`` claims nothing) and creates the descriptor and zeroed
    rank-stacked registers on the communicator's device; nothing moves until
    elements flow.  The spec carries the channel's whole comm config:
    transport backend, wire format, stats tag and plan."""
    spec = _claim(ChannelSpec(comm=comm, kind="p2p", count=count, src=src, dst=dst, port=port,
                              transport=transport, wire=wire, tag=tag, plan=plan,
                              n_chunks=n_chunks), allocator)
    P, dev = comm.size, comm.device
    return Channel(
        spec=spec,
        pipe=torch.zeros((P,) + tuple(elem_shape), dtype=dtype, device=dev),
        valid=torch.zeros(P, dtype=torch.float32, device=dev),
        pushed=torch.zeros(P, dtype=torch.int32, device=dev),
        popped=torch.zeros(P, dtype=torch.int32, device=dev),
    )


# -- the functional forms (the paper's C-style API) ------------------------------


def push(chan: Channel, elem) -> Channel:
    """SMI_Push (functional form): see :meth:`Channel.push`."""
    return chan.push(elem)


def pop(chan: Channel):
    """SMI_Pop (functional form): see :meth:`Channel.pop`."""
    return chan.pop()


def channel_transfer(chan, x: torch.Tensor, n_chunks: int | None = None):
    """Whole-message transfer (functional form): see
    :meth:`Channel.transfer`; it moves through the channel's own backend and
    stats tag."""
    return chan.transfer(x, n_chunks=n_chunks)
