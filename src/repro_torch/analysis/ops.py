"""The channel-op model `smilint` verifies over (``repro.analysis.ops``).

A *channel program* is, per rank, an ordered list of :class:`ChannelOp`
records — the abstract record of every ``open_*_channel`` / ``push`` /
``pop`` / ``transfer`` / ``close`` / :class:`~repro_torch.channels.
ChannelPool` claim the program performs.  Two producers exist:

* **capture mode** (:mod:`repro_torch.analysis.capture`): the real channel
  API records ops while a program runs with every transport replaced by an
  abstract backend — one SPMD op stream (the rank-stacked runtime runs
  every rank's op at once), expanded per rank by :func:`as_program`;
* **explicit MPMD programs** (:class:`ProgramBuilder`): per-rank op lists
  written directly, the paper's one-kernel-per-FPGA world — this is how
  the known-bad corpus seeds cross-rank defects (endpoint mismatches,
  deadlock cycles) an SPMD run cannot express.

The reference's module unchanged, bar these docstrings; it imports
nothing, so the verifier and the corpus run anywhere the AST lints do.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

#: ops a channel program is made of
OPS = ("open", "close", "push", "pop", "transfer", "pool.open", "pool.close")


@dataclass
class ChannelOp:
    """One abstract channel operation at one rank.

    ``rank=None`` marks an SPMD op (every rank performs it, with the roles
    its ``src``/``dst``/``root`` fields imply).  ``chan`` identifies the
    rank-local channel *instance* the op belongs to (capture assigns it
    from the opening spec); the cross-rank identity of a channel is its
    ``(comm, port)`` — SMI ports name hardware endpoints (paper §2.2), so
    anonymous (``port=None``) channels are rank-local only.
    """

    op: str
    rank: int | None = None
    chan: int | None = None
    kind: str = "p2p"
    port: int | None = None
    tag: str | None = None
    comm: str = "world"
    size: int = 0
    src: int = 0
    dst: int = 0
    root: int = 0
    count: int | None = None
    dtype: str | None = None
    wire: str = "raw"
    transport: str | None = None
    persistent: bool = False
    location: str | None = None

    def __post_init__(self):
        assert self.op in OPS, f"unknown channel op {self.op!r}; one of {OPS}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "ChannelOp":
        return dataclasses.replace(self, **kw)


@dataclass
class CaptureLedger:
    """What one capture run accumulates: the SPMD op stream, per-tag
    abstract-transport step/byte totals, and the count of *real* transport
    steps — which capture mode exists to keep at zero (the no-comm-executed
    contract ``tests/test_analysis.py`` asserts for ``launch/train`` and
    ``launch/serve``)."""

    ops: list = field(default_factory=list)
    #: tag -> {"steps": int, "bytes": int} tallied by the abstract backend
    transport_steps: dict = field(default_factory=dict)
    #: steps tallied by any REAL (non-abstract) transport during capture;
    #: must stay 0 — capture moves no message
    real_steps: int = 0
    size: int = 0
    _chan_ids: dict = field(default_factory=dict, repr=False)
    _chan_refs: list = field(default_factory=list, repr=False)

    def chan_id(self, spec) -> int:
        """Stable rank-local channel id for an opened spec (capture keeps
        the spec alive for the ledger's lifetime so ids cannot alias)."""
        key = id(spec)
        cid = self._chan_ids.get(key)
        if cid is None:
            cid = len(self._chan_refs)
            self._chan_ids[key] = cid
            self._chan_refs.append(spec)
        return cid

    def add(self, op: ChannelOp):
        self.ops.append(op)
        if op.size > self.size:
            self.size = op.size

    def tally_abstract(self, tag: str | None, steps: int, nbytes: int):
        e = self.transport_steps.setdefault(
            tag or "untagged", {"steps": 0, "bytes": 0}
        )
        e["steps"] += steps
        e["bytes"] += nbytes

    def counts(self) -> dict:
        by_op: dict[str, int] = {}
        for o in self.ops:
            by_op[o.op] = by_op.get(o.op, 0) + 1
        return by_op


@dataclass
class Program:
    """A per-rank channel program: what the verifier checks.

    ``spmd=True`` marks programs expanded from one SPMD op stream — every
    rank runs the same sequence, which licenses the aligned prefix walk the
    credit-window check uses (an MPMD program only gets the
    interleaving-independent totals rule)."""

    ranks: dict  # rank -> list[ChannelOp]
    size: int
    spmd: bool = False
    name: str = "program"

    def all_ops(self):
        for r in sorted(self.ranks):
            yield from self.ranks[r]


def as_program(src, size: int | None = None, name: str = "program") -> Program:
    """Normalise a capture ledger / flat op list into a :class:`Program`.

    SPMD ops (``rank=None``) are expanded to every rank; ops that already
    carry a rank stay where they are.  ``size`` defaults to the largest
    communicator size any op saw."""
    ops = src.ops if isinstance(src, CaptureLedger) else list(src)
    if size is None:
        size = max(
            [getattr(src, "size", 0)] + [o.size for o in ops] + [1]
        )
    ranks: dict[int, list] = {r: [] for r in range(size)}
    spmd = True
    for o in ops:
        if o.rank is None:
            for r in range(size):
                ranks[r].append(o.replace(rank=r))
        else:
            spmd = False
            assert 0 <= o.rank < size, (o.rank, size)
            ranks[o.rank].append(o)
    return Program(ranks=ranks, size=size, spmd=spmd, name=name)


class _RankOps:
    """Fluent per-rank op appender (see :class:`ProgramBuilder`)."""

    def __init__(self, builder: "ProgramBuilder", rank: int):
        self._b = builder
        self._rank = rank

    def _add(self, op: str, **kw):
        kw.setdefault("size", self._b.size)
        kw.setdefault("comm", self._b.comm)
        self._b.ops.append(ChannelOp(op=op, rank=self._rank, **kw))
        return self

    def open(self, **kw):
        return self._add("open", **kw)

    def close(self, **kw):
        return self._add("close", **kw)

    def push(self, **kw):
        return self._add("push", **kw)

    def pop(self, **kw):
        return self._add("pop", **kw)

    def transfer(self, **kw):
        return self._add("transfer", **kw)

    def pool_open(self, **kw):
        kw.setdefault("persistent", True)
        return self._add("pool.open", **kw)

    def pool_close(self, **kw):
        kw.setdefault("persistent", True)
        return self._add("pool.close", **kw)


class ProgramBuilder:
    """Hand-build an MPMD channel program (the known-bad corpus' tool).

    >>> b = ProgramBuilder(size=2)
    >>> b.rank(0).open(kind="p2p", port=0, src=0, dst=1).push(port=0)
    >>> b.rank(1).open(kind="p2p", port=0, src=0, dst=1).pop(port=0)
    >>> prog = b.build()
    """

    def __init__(self, size: int, comm: str = "world"):
        self.size = int(size)
        self.comm = comm
        self.ops: list[ChannelOp] = []

    def rank(self, r: int) -> _RankOps:
        assert 0 <= r < self.size, (r, self.size)
        return _RankOps(self, r)

    def spmd(self) -> _RankOps:
        """Appender for SPMD ops (every rank performs them)."""
        ops = _RankOps(self, 0)
        ops._rank = None  # type: ignore[assignment]
        return ops

    def build(self, name: str = "program") -> Program:
        return as_program(self.ops, size=self.size, name=name)
