"""The seeded known-bad corpus: one program per rule, with golden ids
(``repro.analysis.corpus``).

smilint runs in both directions: every in-repo program must be *clean*,
and every corpus entry must report **exactly** its golden rule set — a
verifier that goes quiet (or noisy) fails the gate either way.
Capture-mode defects are hand-built MPMD/SPMD channel programs
(:class:`~repro_torch.analysis.ops.ProgramBuilder` — endpoint mismatches
and deadlock cycles cannot even be expressed by an SPMD run); AST defects
are seeded source snippets run through :func:`~repro_torch.analysis.rules.
lint_source`.  The programs are the reference's, op for op; the seeded
sources are the reference's but for SMI004's, which takes the port's form
of a raw move (a ``ppermute`` over the rank dimension in ``models/``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .ops import Program, ProgramBuilder
from .rules import lint_source
from .verify import verify_program


@dataclass
class CorpusCase:
    """One seeded defect: a program or source snippet plus its golden
    rule-id set (what the verifier MUST report, and nothing else)."""

    name: str
    golden: frozenset
    program: Program | None = None
    source: str | None = None
    #: repo path the AST seed pretends to live at (path-scoped rules)
    relpath: str | None = None
    note: str = ""

    def run(self) -> list:
        """The diagnostics smilint reports for this case."""
        if self.program is not None:
            return verify_program(self.program)
        rel = self.relpath or f"src/repro_torch/seeded/{self.name}.py"
        return lint_source(self.source, relpath=rel)

    def reported(self) -> frozenset:
        return frozenset(d.rule for d in self.run())

    def ok(self) -> bool:
        return self.reported() == self.golden


# -- capture-mode defects -----------------------------------------------------


def _port_collision() -> CorpusCase:
    """SMI101: every rank claims port 3 twice without closing — the
    second open collides with the live first claim."""
    b = ProgramBuilder(size=4)
    s = b.spmd()
    s.open(kind="p2p", port=3, src=0, dst=1, count=2, dtype="float32")
    s.open(kind="p2p", port=3, src=0, dst=1, count=2, dtype="float32")
    s.push(port=3, src=0, dst=1, count=2)
    s.pop(port=3, src=0, dst=1, count=2)
    s.push(port=3, src=0, dst=1, count=2)
    s.pop(port=3, src=0, dst=1, count=2)
    s.close(port=3, src=0, dst=1)
    s.close(port=3, src=0, dst=1)
    return CorpusCase(
        name="port_collision", golden=frozenset({"SMI101"}),
        program=b.build("port_collision"),
        note="double claim of one live (comm, port)",
    )


def _endpoint_mismatch() -> CorpusCase:
    """SMI102: sender opens port 0 as float32/raw/static; receiver opens
    the same port as int8 over the compressed wire — the paper's matched
    signature rule (§4) broken in dtype and wire."""
    b = ProgramBuilder(size=2)
    b.rank(0) \
        .open(kind="p2p", port=0, src=0, dst=1, count=1, dtype="float32",
              wire="raw", transport="static") \
        .push(port=0, src=0, dst=1, count=1) \
        .close(port=0, src=0, dst=1)
    b.rank(1) \
        .open(kind="p2p", port=0, src=0, dst=1, count=1, dtype="int8",
              wire="int8", transport="compressed:static") \
        .pop(port=0, src=0, dst=1, count=1) \
        .close(port=0, src=0, dst=1)
    return CorpusCase(
        name="endpoint_mismatch", golden=frozenset({"SMI102"}),
        program=b.build("endpoint_mismatch"),
        note="dtype/wire/transport disagree across the port's endpoints",
    )


def _unmatched_peer() -> CorpusCase:
    """SMI102 (unmatched flavour): the sender opens a p2p channel to rank
    1, which never opens the port — a message with no receiver.  The
    sender's unpoppable push co-reports as SMI103."""
    b = ProgramBuilder(size=2)
    b.rank(0) \
        .open(kind="p2p", port=7, src=0, dst=1, count=1, dtype="float32") \
        .push(port=7, src=0, dst=1, count=1) \
        .close(port=7, src=0, dst=1)
    return CorpusCase(
        name="unmatched_peer", golden=frozenset({"SMI102", "SMI103"}),
        program=b.build("unmatched_peer"),
        note="peer rank never opens the port",
    )


def _push_pop_imbalance() -> CorpusCase:
    """SMI103: the producer pushes four elements; the consumer pops one
    — three elements the program provably never delivers."""
    b = ProgramBuilder(size=2)
    r0 = b.rank(0).open(kind="p2p", port=0, src=0, dst=1, count=4,
                        dtype="float32")
    for _ in range(4):
        r0.push(port=0, src=0, dst=1, count=4)
    r0.close(port=0, src=0, dst=1)
    b.rank(1).open(kind="p2p", port=0, src=0, dst=1, count=4,
                   dtype="float32") \
        .pop(port=0, src=0, dst=1, count=4) \
        .close(port=0, src=0, dst=1)
    return CorpusCase(
        name="push_pop_imbalance", golden=frozenset({"SMI103"}),
        program=b.build("push_pop_imbalance"),
        note="4 pushes vs 1 pop on a bounded channel",
    )


def _credit_overrun() -> CorpusCase:
    """SMI104: an SPMD program pushes twice into the 1-deep p2p pipe
    before any pop — the second push silently overwrites the in-flight
    element (Channel.push has no backpressure on the pipe register)."""
    b = ProgramBuilder(size=2)
    s = b.spmd()
    s.open(kind="p2p", port=0, src=0, dst=1, count=2, dtype="float32")
    s.push(port=0, src=0, dst=1, count=2)
    s.push(port=0, src=0, dst=1, count=2)
    s.pop(port=0, src=0, dst=1, count=2)
    s.pop(port=0, src=0, dst=1, count=2)
    s.close(port=0, src=0, dst=1)
    return CorpusCase(
        name="credit_overrun", golden=frozenset({"SMI104"}),
        program=b.build("credit_overrun"),
        note="2 outstanding pushes vs the 1-deep p2p credit window",
    )


def _claim_leak() -> CorpusCase:
    """SMI105: a persistent pool claim with no matching pool.close —
    persistent claims survive every call and GC, so the port is gone
    for good."""
    b = ProgramBuilder(size=4)
    s = b.spmd()
    s.pool_open(kind="allreduce", port=100, tag="serve.decode.mlp",
                dtype="float32")
    s.pool_open(kind="allreduce", port=101, tag="serve.decode.attn",
                dtype="float32")
    s.pool_close(kind="allreduce", port=101, tag="serve.decode.attn")
    return CorpusCase(
        name="claim_leak", golden=frozenset({"SMI105"}),
        program=b.build("claim_leak"),
        note="persistent claim on port 100 never released",
    )


def _deadlock_cycle() -> CorpusCase:
    """SMI106: rank 0 pops from rank 1 before pushing to it; rank 1 pops
    from rank 0 before pushing to it — a two-rank wait-for cycle no
    schedule can break."""
    b = ProgramBuilder(size=2)
    b.rank(0) \
        .open(kind="p2p", port=0, src=1, dst=0, count=1, dtype="float32") \
        .open(kind="p2p", port=1, src=0, dst=1, count=1, dtype="float32") \
        .pop(port=0, src=1, dst=0, count=1) \
        .push(port=1, src=0, dst=1, count=1) \
        .close(port=0, src=1, dst=0).close(port=1, src=0, dst=1)
    b.rank(1) \
        .open(kind="p2p", port=0, src=1, dst=0, count=1, dtype="float32") \
        .open(kind="p2p", port=1, src=0, dst=1, count=1, dtype="float32") \
        .pop(port=1, src=0, dst=1, count=1) \
        .push(port=0, src=1, dst=0, count=1) \
        .close(port=0, src=1, dst=0).close(port=1, src=0, dst=1)
    return CorpusCase(
        name="deadlock_cycle", golden=frozenset({"SMI106"}),
        program=b.build("deadlock_cycle"),
        note="mutual pop-before-push across two ports",
    )


# -- AST defects --------------------------------------------------------------

_AST_CASES = (
    CorpusCase(
        name="stream_shim", golden=frozenset({"SMI001"}),
        source="y = stream_bcast(x, comm, root=0)\n",  # smilint: ignore[SMI001]
        note="deprecated stream_* shim in the port's tree",
    ),
    CorpusCase(
        name="undisciplined_open", golden=frozenset({"SMI002"}),
        source=(
            "def step(comm, x):\n"
            "    ch = open_channel(comm, count=4, src=0, dst=1, port=0)\n"
            "    ch = ch.push(x)\n"
            "    return x\n"
        ),
        note="port-claiming open: no with, no close, no escape",
    ),
    CorpusCase(
        name="reserved_port", golden=frozenset({"SMI003"}),
        source=(
            "def step(comm, x):\n"
            "    with open_allreduce_channel(comm, port=150,\n"
            "                                elem_shape=()) as ch:\n"
            "        return ch.transfer(x)\n"
        ),
        note="hardcoded port inside the serving pool's reserved range",
    ),
    CorpusCase(
        name="raw_collective", golden=frozenset({"SMI004"}),
        source="def fwd(x, pairs):\n    return ppermute(x, pairs)\n",
        relpath="src/repro_torch/models/seeded.py",
        note="raw rank-dimension move bypassing the tagged channel layer",
    ),
)


def corpus() -> tuple:
    """Every seeded case, capture-mode first, AST last."""
    return (
        _port_collision(),
        _endpoint_mismatch(),
        _unmatched_peer(),
        _push_pop_imbalance(),
        _credit_overrun(),
        _claim_leak(),
        _deadlock_cycle(),
    ) + _AST_CASES


def run_corpus() -> tuple[list, bool]:
    """``(report_rows, all_ok)``: per-case golden-vs-reported rows for
    the CLI's report."""
    rows = []
    ok = True
    for case in corpus():
        reported = case.reported()
        match = reported == case.golden
        ok = ok and match
        rows.append({
            "case": case.name,
            "golden": sorted(case.golden),
            "reported": sorted(reported),
            "ok": match,
            "note": case.note,
            "diagnostics": [d.to_dict() for d in case.run()],
        })
    return rows, ok
