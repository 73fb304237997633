"""smilint capture-mode verifier: static checks over channel programs
(``repro.analysis.verify``).

Implements the semantic half of the rule catalog over a
:class:`~repro_torch.analysis.ops.Program`:

* **SMI101 port-claim collision** — two live claims of one ``(comm, port)``
  at a rank (the PortAllocator raises at runtime; here it is a diagnostic
  with a source location *before* anything runs).
* **SMI102 endpoint mismatch** — the ranks of one port's channel disagree
  on kind/dtype/wire/transport/count/peers, or a required peer never opens
  the port at all (the paper's §4 matched-signature rule).
* **SMI103 push/pop imbalance** — elements pushed that the consumer side
  can never pop (or pushes beyond a bounded channel's ``count``).
* **SMI104 credit-window overrun** — more outstanding pushes than the
  channel's statically-known window (1-deep p2p pipe register, P-deep
  bcast/reduce FIFO, 1-deep round channels): the push the runtime would
  refuse or silently overwrite.
* **SMI105 persistent-claim leak** — a persistent (pool) claim never
  released; trace exits never lapse it, so it is gone for good.
* **SMI106 deadlock cycle** — a Kahn-style topological run of the per-rank
  op orders over the inter-rank wait-for relation gets stuck: blocked pops
  whose producers are themselves blocked, reported as the cycle.

The reference's module unchanged, bar these docstrings (the same rule
ids, severities and messages): the verifier runs over captured ledgers and
over hand-built MPMD corpus programs identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ops import CaptureLedger, ChannelOp, Program, as_program

#: rule id -> (severity, one-line summary).  The single catalog both passes
#: share; ids below 100 are AST source lints (analysis/rules.py).
CATALOG = {
    "SMI001": ("error", "deprecated stream_* shim call"),
    "SMI002": ("error", "channel opened outside with/close discipline"),
    "SMI003": ("error", "hardcoded port/tag collides with a reserved range"),
    "SMI004": ("error", "raw lax collective bypasses the tagged channel layer"),
    "SMI101": ("error", "port-claim collision"),
    "SMI102": ("error", "cross-rank endpoint mismatch"),
    "SMI103": ("error", "push/pop count imbalance"),
    "SMI104": ("error", "credit-window overrun"),
    "SMI105": ("error", "persistent claim leaked (never released)"),
    "SMI106": ("error", "deadlock cycle in the channel wait-for graph"),
}


@dataclass
class Diagnostic:
    """One machine-readable smilint finding (rule id, rank, port, tag,
    source location — the schema the CI artifact carries)."""

    rule: str
    message: str
    rank: int | None = None
    port: int | None = None
    tag: str | None = None
    location: str | None = None
    severity: str = field(default="")

    def __post_init__(self):
        if not self.severity:
            self.severity = CATALOG.get(self.rule, ("error", ""))[0]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "rank": self.rank,
            "port": self.port,
            "tag": self.tag,
            "location": self.location,
        }

    def __str__(self):
        where = f" @{self.location}" if self.location else ""
        rank = "all-ranks" if self.rank is None else f"rank {self.rank}"
        port = "" if self.port is None else f" port {self.port}"
        tag = "" if self.tag is None else f" tag {self.tag!r}"
        return (f"{self.rule} [{self.severity}] {rank}{port}{tag}: "
                f"{self.message}{where}")


# -- channel identity --------------------------------------------------------


def _ckey(op: ChannelOp):
    """Cross-rank channel identity: the claimed port; anonymous channels
    fall back to the rank-local instance id (no cross-rank identity)."""
    if op.port is not None:
        return ("port", op.comm, op.port)
    return ("anon", op.comm, op.chan)


def _participants(d: ChannelOp) -> set:
    """Ranks required to open a channel with descriptor ``d``."""
    if d.kind == "p2p":
        return {d.src, d.dst}
    return set(range(d.size))


def _producers(d: ChannelOp) -> set:
    """Ranks whose pushes feed the channel."""
    if d.kind == "p2p":
        return {d.src}
    if d.kind in ("bcast", "scatter"):
        return {d.root}
    return set(range(d.size))  # reduce / gather / allreduce: everyone


def _consumers(d: ChannelOp) -> set:
    """Ranks whose pops deliver valid elements."""
    if d.kind == "p2p":
        return {d.dst}
    if d.kind in ("reduce", "gather"):
        return {d.root}
    return set(range(d.size))  # bcast / scatter / allreduce: everyone


def _window(d: ChannelOp) -> int:
    """Statically-known credit window per producing rank: the 1-deep p2p
    pipe register, the P-deep bcast/reduce contribution FIFO (paper §3.3),
    the 1-deep staging slot of the round channels."""
    if d.kind in ("bcast", "reduce"):
        return max(d.size, 1)
    return 1


# -- SMI101: port-claim collisions -------------------------------------------


def _check_collisions(prog: Program) -> list:
    diags = []
    for r in sorted(prog.ranks):
        live: dict = {}
        for op in prog.ranks[r]:
            if op.port is None:
                continue
            key = (op.comm, op.port)
            if op.op in ("open", "pool.open"):
                if key in live:
                    first = live[key]
                    diags.append(Diagnostic(
                        "SMI101", rank=r, port=op.port, tag=op.tag,
                        location=op.location,
                        message=(
                            f"port {op.port} on comm {op.comm!r} is already "
                            f"claimed by a live {first.kind} channel"
                            + (f" (opened at {first.location})"
                               if first.location else "")
                            + "; SMI ports identify distinct hardware "
                              "endpoints and cannot be shared"),
                    ))
                else:
                    live[key] = op
            elif op.op in ("close", "pool.close"):
                live.pop(key, None)
    return diags


# -- SMI102: cross-rank endpoint matching ------------------------------------

#: open-descriptor fields every endpoint of a channel must agree on
_MATCH_FIELDS = ("kind", "dtype", "wire", "transport", "count",
                 "src", "dst", "root", "persistent")


def _check_endpoints(prog: Program) -> list:
    diags = []
    # per cross-rank channel key: rank -> ordered list of opens
    opens: dict = {}
    for op in prog.all_ops():
        if op.op in ("open", "pool.open") and op.port is not None:
            opens.setdefault(("port", op.comm, op.port), {}) \
                 .setdefault(op.rank, []).append(op)
    for (_, comm, port), per_rank in sorted(opens.items()):
        n_gen = max(len(v) for v in per_rank.values())
        for gen in range(n_gen):
            gen_opens = {r: v[gen] for r, v in per_rank.items()
                         if len(v) > gen}
            ref_rank = min(gen_opens)
            ref = gen_opens[ref_rank]
            # every required participant must open this generation
            for r in sorted(_participants(ref)):
                if r not in gen_opens:
                    diags.append(Diagnostic(
                        "SMI102", rank=r, port=port, tag=ref.tag,
                        location=ref.location,
                        message=(
                            f"rank {r} never opens port {port} on comm "
                            f"{comm!r}, but the {ref.kind} channel rank "
                            f"{ref_rank} opened there names it as an "
                            "endpoint (unmatched peer)"),
                    ))
            # and every rank that did open must agree with the reference
            for r, d in sorted(gen_opens.items()):
                if r == ref_rank:
                    continue
                bad = [f for f in _MATCH_FIELDS
                       if getattr(d, f) != getattr(ref, f)]
                if bad:
                    detail = ", ".join(
                        f"{f}: {getattr(ref, f)!r} (rank {ref_rank}) != "
                        f"{getattr(d, f)!r} (rank {r})" for f in bad
                    )
                    diags.append(Diagnostic(
                        "SMI102", rank=r, port=port, tag=d.tag,
                        location=d.location,
                        message=(f"endpoints of port {port} disagree on "
                                 f"{detail}"),
                    ))
    return diags


# -- SMI105: persistent-claim leaks ------------------------------------------


def _check_leaks(prog: Program) -> list:
    diags = []
    for r in sorted(prog.ranks):
        live: dict = {}
        for op in prog.ranks[r]:
            key = _ckey(op)
            if op.op in ("open", "pool.open") and op.persistent:
                live[key] = op
            elif op.op in ("close", "pool.close"):
                live.pop(key, None)
        for key, op in sorted(live.items(), key=lambda kv: str(kv[0])):
            diags.append(Diagnostic(
                "SMI105", rank=r, port=op.port, tag=op.tag,
                location=op.location,
                message=(
                    f"persistent claim of port {op.port} (tag {op.tag!r}) "
                    "is never released; persistent claims survive trace "
                    "exits and garbage collection — only an explicit "
                    "close()/pool.close() frees the port"),
            ))
    return diags


# -- SMI104: credit windows (SPMD lockstep walk) -----------------------------


def _check_windows(prog: Program) -> list:
    """Credit-window overrun on the aligned SPMD walk.

    Every rank of an SPMD program executes the same op sequence in
    lockstep, so pushes and the pops that drain them interleave in exactly
    the recorded order — the outstanding count is exact.  An MPMD program
    has no such alignment (any interleaving may drain between two pushes),
    so only SPMD programs get this check; MPMD over-production still
    surfaces as SMI103.
    """
    if not prog.spmd:
        return []
    diags = []
    # per channel: opening descriptor, pushes accepted, pops consumed
    desc: dict = {}
    pushed: dict = {}
    popped: dict = {}
    for op in prog.ranks.get(0, []):
        key = _ckey(op)
        if op.op in ("open", "pool.open"):
            desc[key] = op
            pushed[key] = popped[key] = 0
        elif op.op == "push":
            d = desc.get(key, op)
            pushed.setdefault(key, 0)
            popped.setdefault(key, 0)
            if pushed[key] - popped[key] >= _window(d):
                verb = ("silently overwrites the in-flight element"
                        if d.kind == "p2p" else "is refused")
                diags.append(Diagnostic(
                    "SMI104", rank=None, port=d.port, tag=d.tag or op.tag,
                    location=op.location,
                    message=(
                        f"push #{pushed[key] + 1} on {d.kind} channel "
                        f"(port {d.port}) exceeds the {_window(d)}-deep "
                        f"credit window and {verb}; pop before pushing "
                        "again"),
                ))
            else:
                pushed[key] += 1
        elif op.op == "pop":
            pushed.setdefault(key, 0)
            popped.setdefault(key, 0)
            # a drain-phase bubble pop consumes nothing and banks no credit
            popped[key] = min(popped[key] + 1, pushed[key])
    return diags


# -- the abstract scheduler: SMI103 + SMI106 ---------------------------------


class _ChanState:
    """Abstract runtime state of one channel during the Kahn run."""

    __slots__ = ("desc", "pushed", "popped", "future_pushes")

    def __init__(self, desc: ChannelOp, size: int):
        self.desc = desc
        self.pushed = dict.fromkeys(range(size), 0)   # pushes, per rank
        self.popped = dict.fromkeys(range(size), 0)   # pop attempts, per rank
        self.future_pushes = dict.fromkeys(range(size), 0)

    def available(self, rank: int) -> bool:
        """Can a pop at ``rank`` deliver one more element right now?"""
        d = self.desc
        if rank not in _consumers(d):
            return True  # bubble pop at a non-consumer: completes, invalid
        produced = min(self.pushed[p] for p in _producers(d))
        if d.count is not None:
            produced = min(produced, d.count)
        return self.popped[rank] < produced

    def producers_pending(self, rank: int) -> set:
        """Producer ranks that still owe this channel future pushes."""
        return {p for p in _producers(self.desc)
                if self.future_pushes.get(p, 0) > 0 and p != rank}


def _run_schedule(prog: Program):
    """Kahn-style topological execution of the per-rank op orders.

    Pushes never block (SMI refusal semantics — a full window refuses or
    overwrites, it does not stall, so it cannot deadlock; over-production
    is SMI103/SMI104's business).  A pop is ready when data is available
    *or* its producers have no future pushes left (the warm-up/drain
    bubble pop).  Returns ``(states, deadlock_diags)``: the final channel
    states for the balance check and — if the run gets stuck — the
    wait-for cycle."""
    size = prog.size
    # channel states, keyed by cross-rank identity; opened lazily so corpus
    # programs that push without opening still verify
    states: dict = {}

    def state(op: ChannelOp) -> _ChanState:
        key = _ckey(op)
        st = states.get(key)
        if st is None:
            st = states[key] = _ChanState(op, size)
        elif op.op in ("open", "pool.open"):
            st.desc = op  # refresh descriptor on (re)open
        return st

    # register descriptors first, then pre-scan future pushes per rank
    for op in prog.all_ops():
        if op.op in ("open", "pool.open"):
            state(op)
    for op in prog.all_ops():
        if op.op == "push":
            st = state(op)
            if op.rank in _producers(st.desc):
                st.future_pushes[op.rank] += 1

    pc = {r: 0 for r in range(size)}
    seqs = {r: prog.ranks.get(r, []) for r in range(size)}

    def try_step(r: int) -> bool:
        seq = seqs[r]
        if pc[r] >= len(seq):
            return False
        op = seq[pc[r]]
        if op.op in ("open", "close", "transfer", "pool.open", "pool.close"):
            state(op)  # ensure descriptor exists
            pc[r] += 1
            return True
        st = state(op)
        if op.op == "push":
            if r in _producers(st.desc):
                st.future_pushes[r] -= 1
                st.pushed[r] += 1
            pc[r] += 1
            return True
        assert op.op == "pop", op.op
        if st.available(r) or not st.producers_pending(r):
            st.popped[r] += 1
            pc[r] += 1
            return True
        return False  # blocked on data

    remaining = sum(len(s) for s in seqs.values())
    while remaining:
        progressed = False
        for r in range(size):
            while try_step(r):
                progressed = True
        remaining = sum(len(seqs[r]) - pc[r] for r in range(size))
        if not progressed:
            break

    deadlocks: list = []
    if remaining:
        # every stuck rank is blocked on a pop; walk the wait-for edges
        # (blocked rank -> producers it waits on) to present the cycle
        blocked = {}
        for r in range(size):
            if pc[r] < len(seqs[r]):
                op = seqs[r][pc[r]]
                if op.op == "pop":
                    st = state(op)
                    blocked[r] = (op, st.producers_pending(r))
        chain = []
        for r, (op, waits_on) in sorted(blocked.items()):
            others = sorted(w for w in waits_on if w in blocked) or \
                sorted(waits_on)
            chain.append(f"rank {r} waits on port {op.port} "
                         f"(producer rank{'s' if len(others) != 1 else ''} "
                         f"{', '.join(map(str, others))})")
        first = sorted(blocked)[0] if blocked else None
        op0 = blocked[first][0] if blocked else None
        deadlocks.append(Diagnostic(
            "SMI106",
            rank=first,
            port=op0.port if op0 is not None else None,
            tag=op0.tag if op0 is not None else None,
            location=op0.location if op0 is not None else None,
            message=("channel wait-for graph has a cycle; no rank can make "
                     "progress: " + "; ".join(chain)),
        ))
    return states, deadlocks


def _check_balance(states: dict) -> list:
    diags = []
    for key, st in sorted(states.items(), key=lambda kv: str(kv[0])):
        d = st.desc
        producers, consumers = _producers(d), _consumers(d)
        counts = {st.pushed[p] for p in producers}
        if len(counts) > 1 and d.kind in ("reduce", "gather", "allreduce"):
            detail = ", ".join(f"rank {p}: {st.pushed[p]}"
                               for p in sorted(producers))
            diags.append(Diagnostic(
                "SMI103", rank=min(producers, key=lambda p: st.pushed[p]),
                port=d.port, tag=d.tag, location=d.location,
                message=(f"{d.kind} channel contributions are unbalanced "
                         f"({detail}); every rank must push equally"),
            ))
        produced = min(st.pushed[p] for p in producers) if producers else 0
        deliverable = produced
        if d.count is not None:
            deliverable = min(deliverable, d.count)
            excess = max(st.pushed[p] for p in producers) - d.count
            if excess > 0:
                diags.append(Diagnostic(
                    "SMI103", rank=max(producers,
                                       key=lambda p: st.pushed[p]),
                    port=d.port, tag=d.tag, location=d.location,
                    message=(f"{excess} push(es) beyond the channel's "
                             f"count={d.count} can never be delivered"),
                ))
        for c in sorted(consumers):
            if st.popped[c] < deliverable:
                diags.append(Diagnostic(
                    "SMI103", rank=c, port=d.port, tag=d.tag,
                    location=d.location,
                    message=(f"{deliverable - st.popped[c]} element(s) "
                             f"pushed on the {d.kind} channel are never "
                             f"popped at rank {c} "
                             f"({st.popped[c]}/{deliverable} pops)"),
                ))
    return diags


# -- entry points ------------------------------------------------------------


def verify_program(prog: Program) -> list:
    """Run every capture-mode rule over ``prog``; diagnostics sorted by
    rule id, then rank."""
    diags = []
    diags += _check_collisions(prog)
    diags += _check_endpoints(prog)
    diags += _check_leaks(prog)
    diags += _check_windows(prog)
    states, deadlocks = _run_schedule(prog)
    diags += deadlocks
    # a deadlocked program never finished its pops; the balance counts are
    # partial and would double-report every blocked element
    if not deadlocks:
        diags += _check_balance(states)
    return sorted(diags, key=lambda d: (d.rule, d.rank if d.rank is not None
                                        else -1, d.port or 0))


def verify_ledger(led: CaptureLedger, size: int | None = None,
                  name: str = "capture") -> list:
    """Expand a captured SPMD op stream per rank and verify it."""
    return verify_program(as_program(led, size=size, name=name))
