"""The Transport protocol: what a message-moving backend must provide.

A backend turns *logical* communication steps — a ring shift, an explicit
permutation, a routed point-to-point transfer — into data movement between
the rows of a rank-stacked tensor.  The collectives and the halo exchange
are written once against this interface.

Every backend is *schedule-preserving*: for a fixed communicator and
arguments it moves exactly the same values to the same ranks, so collective
results are bit-identical across backends.

Cost accounting (:class:`TransportStats`) counts what ONE rank moves: a
step's bytes are those of ``x[0]``, never of the whole ``(P, ...)`` stack,
so the counters equal the reference's per-shard counts.  The packet backend
also accumulates the router's loss counter, so lossless runs are
assertable.
"""

from __future__ import annotations

import abc
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from ..core.comm import ppermute, resolve_device


@dataclass
class TransportStats:
    """Per-instance accounting, reset with :meth:`Transport.reset_stats`.

    ``steps``/``bytes_moved``: schedule cost per rank (one step = one
    link-schedule tick; bytes = payload one rank carries per tick, summed).
    ``by_tag`` splits the same counters per message *tag* (set with
    :meth:`Transport.tagged`), so the halo exchange keeps its own line when
    it shares a backend instance with other traffic.

    ``overflow`` is the packet router's loss counter, a ``(P,)`` int32
    tensor on the transport's device summed over router runs without a host
    sync (``None`` for backends that cannot drop traffic); reading it is
    the caller's sync.  The reference's ``trace_token`` and
    ``Transport._guard_runtime_reuse`` are not ported: they keep JAX tracers
    of one trace out of another, and eager PyTorch has no tracers.
    """

    steps: int = 0
    bytes_moved: int = 0
    overflow: torch.Tensor | None = None
    #: tag -> {"steps": int, "bytes": int} sub-accounting (see class doc)
    by_tag: dict = field(default_factory=dict)

    def tag_counts(self, tag: str) -> tuple[int, int]:
        """(steps, bytes) tallied under ``tag`` (0, 0 when never tagged)."""
        e = self.by_tag.get(tag, {"steps": 0, "bytes": 0})
        return e["steps"], e["bytes"]

    def add_overflow(self, ovf: torch.Tensor):
        """Add one router run's per-rank loss count (no host sync)."""
        self.overflow = ovf if self.overflow is None else self.overflow + ovf

    def record(self, seconds: float, name: str = "") -> dict:
        """One netsim calibration point: this schedule's cost paired with
        its measured seconds (read by :mod:`repro_torch.netsim.calibrate`;
        the fit reads only steps, bytes and seconds).  ``by_tag`` and the
        total ``overflow`` (a host sync when the router ran) ride along so
        saved calibration runs stay auditable per message tag."""
        return {
            "steps": int(self.steps),
            "bytes": float(self.bytes_moved),
            "seconds": float(seconds),
            "name": name,
            "overflow": None if self.overflow is None else int(self.overflow.sum()),
            "by_tag": {
                tag: {"steps": int(e["steps"]), "bytes": int(e["bytes"])}
                for tag, e in self.by_tag.items()
            },
        }


def rank_bytes(x) -> int:
    """Wire bytes one rank's row of the rank-stacked ``x`` holds; a tuple of
    rank-stacked tensors counts all its members (one step moving them
    together, as the reference's pytree steps do)."""
    if isinstance(x, tuple):
        return sum(rank_bytes(v) for v in x)
    return x[0].numel() * x.element_size()


class _StraightThrough(torch.autograd.Function):
    """A move whose rows come off the graph (the int8 wire's arrival, a
    router kernel's output) with the exact move's gradient: ``move()`` runs
    off the graph; the backward moves the cotangent along ``back``, the
    move's pairs transposed."""

    @staticmethod
    def forward(ctx, x, move, comm, back):
        ctx.comm, ctx.back, ctx.dtype = comm, back, x.dtype
        return move()

    @staticmethod
    def backward(ctx, g):
        return ppermute(g, ctx.back, ctx.comm).to(ctx.dtype), None, None, None


def straight_through(x, move, comm, pairs):
    """``move()``, which moves the rows of ``x`` along ``pairs`` (exactly, or
    within a lossy wire's codec), with the exact move's gradient where
    autograd records ``x``: the cotangent goes back along the transposed
    pairs, untallied as every backward is."""
    if isinstance(x, torch.Tensor) and x.requires_grad and torch.is_grad_enabled():
        return _StraightThrough.apply(x, move, comm, tuple((d, s) for s, d in pairs))
    return move()


@dataclass
class Transport(abc.ABC):
    """One message-moving backend on ``device`` (``cuda`` unless the caller
    names another).  Instances are cheap, stateful only in their counters;
    create one per logical phase when separate accounting is wanted."""

    stats: TransportStats = field(default_factory=TransportStats)
    device: object = None

    # registry key; a plain class attribute (NOT a dataclass field) so
    # @register_transport's assignment reaches every instance
    name = ""

    #: active message tag (see :meth:`tagged`)
    _tag: str | None = None

    #: devices a rank row carries: a ring over the data axis moves blocks
    #: that are stacked over the model axis's ranks too, one device's share
    #: each (:func:`~repro_torch.parallel.fsdp_allgather`); a step's bytes
    #: are one device's (on the packet wire its router job too)
    lanes = 1

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _check(self, x):
        if isinstance(x, tuple):
            for v in x:
                self._check(v)
            return
        if x.device.type != self.device.type:
            raise ValueError(
                f"{type(self).__name__} on {self.device} was given a tensor "
                f"on {x.device}"
            )

    # ------------------------------------------------------------- steps

    @abc.abstractmethod
    def permute(self, x, comm, pairs):
        """Move rank rows of ``x`` along explicit (src, dst) pairs — one
        link step of the schedule.  Ranks absent as a destination receive
        zeros (``lax.ppermute``'s semantics).  ``x`` may be a tuple of
        rank-stacked tensors, moved as one step (the channels' pipe and
        valid registers)."""

    def shift(self, x, comm, step: int = 1):
        """Ring shift of ``x`` by ``step`` along the linearised ranks."""
        return self.permute(x, comm, comm.ring_perm(step))

    def accumulate(self, a, b):
        """Elementwise ``a + b`` — the reduction-combine hook.  The fused
        backend routes it to its CUDA kernel; it must equal plain ``+`` bit
        for bit."""
        return a + b

    def shift_accumulate(self, x, addend, comm, step: int = 1):
        """Hot-path hook for the ring-reduce inner loop:
        ``shift(x) + addend``.  Must equal the unfused composition bit for
        bit."""
        return self.accumulate(self.shift(x, comm, step), addend)

    def send_contribution(self, c, comm, step: int = 1):
        """Ship one rank-local contribution a logical ring distance
        ``step``.  On exact wires this is just :meth:`shift`."""
        return self.shift(c, comm, step)

    @abc.abstractmethod
    def p2p(self, x, *, src, dst, comm, n_chunks: int = 1):
        """Routed whole-message transfer: row ``src`` of ``x`` delivered to
        row ``dst`` along the communicator's route table; zeros elsewhere."""

    # ---------------------------------------------------------- counters

    @contextmanager
    def tagged(self, tag: str):
        """Tag every step accounted inside the block (halo message
        tagging): the same counters are also bucketed into
        ``stats.by_tag[tag]``.  A wrapper backend (the compressed link)
        passes the tag down its ``inner`` chain, since the inner backend
        accounts the wire it moves."""
        chain = [self]
        while isinstance(getattr(chain[-1], "inner", None), Transport):
            chain.append(chain[-1].inner)
        prev = [t._tag for t in chain]
        for t in chain:
            t._tag = tag
        try:
            yield self
        finally:
            for t, p in zip(chain, prev):
                t._tag = p

    def tally(self, steps: int, nbytes: int):
        """Add raw (steps, bytes) to the counters, honouring the active tag
        (the single accounting funnel)."""
        self.stats.steps += steps
        self.stats.bytes_moved += nbytes
        if self._tag is not None:
            e = self.stats.by_tag.setdefault(
                self._tag, {"steps": 0, "bytes": 0}
            )
            e["steps"] += steps
            e["bytes"] += nbytes

    def account(self, x, steps: int = 1):
        """Tally ``steps`` steps that each carry one rank row of ``x`` (of
        each member of a tuple ``x``), one lane's share of it."""
        self.tally(steps, rank_bytes(x) // self.lanes * steps)

    def reset_stats(self):
        self.stats = TransportStats()
