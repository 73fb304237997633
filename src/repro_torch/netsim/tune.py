"""Cost-model autotuner (``repro.netsim.tune``): sweep the simulator,
cache the winning plans.

For each (operation, message size) on a topology the tuner scores every
candidate :class:`Plan` (transport backend x wire format x collective
algorithm x chunk count) by replaying its schedule through the link
simulator under a :class:`~repro_torch.netsim.model.LinkModel`, and records
the argmin in a :class:`TuningTable`.  ``Communicator.plan()``, the
``bcast``/``reduce``/``allreduce`` dispatchers (``plan="auto"``, their
default), the channels, the halo exchange and the parallel layers consult
the table.

The static default plan (static transport, 1 chunk, ring/chain schedule:
what ``plan=None`` runs) is always in the candidate set, so the tuner never
selects a plan the simulator scores worse than it.

Tables are cheap to build (pure-Python simulation) and cached per topology
signature in-process (:data:`_TABLES`); :meth:`TuningTable.save` /
:meth:`TuningTable.load` persist them as JSON in the reference's format, so
a table written by either package loads in the other.  Each recorded
winner emits a ``tuner.plan`` trace event while tracing is on
(:mod:`repro_torch.obs.trace`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..obs import trace as obs
from .model import LinkModel
from .schedule import (
    HALO_DIRECTIONS,
    collective_rounds,
    compressed_reduce_scatter_rounds,
    halo_pairs,
    halo_rounds,
    p2p_messages,
    packet_bounds,
    packet_n_packets,
    ring_perm_round,
)
from .sim import simulate, simulate_rounds

#: the paper-evaluation sweep grid: 1 KiB .. 16 MiB
SIZE_GRID = tuple(1 << p for p in range(10, 25, 2))

N_CHUNKS_GRID = (1, 2, 4, 8, 16, 32)

#: ``halo`` is the apps stencil's exchange: ``nbytes`` is one halo
#: slab; the schedule shape is fixed (one neighbour permute per direction)
#: so the tuner's decision is which backend moves the slabs
OPS = ("p2p", "bcast", "reduce", "allreduce", "halo")

ALGOS = {
    "p2p": ("routed",),
    "bcast": ("ring", "tree", "staged"),
    "reduce": ("ring", "tree", "staged"),
    "allreduce": ("ring",),
    # one schedule shape; "ring" labels the neighbour-permute rounds and
    # keeps the static default plan inside the candidate set
    "halo": ("ring",),
}

PACKET_ELEMS = 32
PACKET_R = 8


#: wire formats the tuner sweeps: raw f32 links vs int8 compressed links
WIRES = ("raw", "int8")


@dataclass(frozen=True)
class Plan:
    """One tuned decision: which backend moves the bytes, how many chunks
    ride the pipeline, which schedule shape the collective uses, and the
    wire format (``"raw"`` | ``"int8"`` — the compressed-link backend)."""

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
        """Largest divisor of ``leading_dim`` <= the tuned chunk count (the
        collectives require n_chunks | leading dim; the tuned value is a
        hint, never a correctness constraint)."""
        from .model import clamp_chunks

        return clamp_chunks(self.n_chunks, leading_dim)

    def to_dict(self):
        return {"transport": self.transport, "n_chunks": self.n_chunks,
                "algo": self.algo, "wire": self.wire}


DEFAULT_PLAN = Plan("static", 1, "ring")


def score_plan(topo, rt, op: str, nbytes: int, plan: Plan,
               model: LinkModel) -> float:
    """Predicted seconds for ``op`` of ``nbytes`` under ``plan``.

    Static/fused plans replay their schedule through the tick simulator;
    packet plans use the router's static schedule bound (the same
    ``_bounds`` the device path computes) times the per-packet cycle cost
    including the R-stickiness arbitration factor (Tab. 4).  An ``int8``
    wire keeps the tick structure (same schedule, compressed flits) but
    converts ticks through :meth:`LinkModel.hop_time_wire` — serialising
    the compressed bytes and paying the per-hop codec pass, which is what
    keeps compression off the latency-bound cells.
    """
    P = topo.n_ranks
    if P == 1 or nbytes <= 0:
        return 0.0
    # score p2p at the topology's worst case: the farthest rank from 0
    far = max(range(P), key=lambda d: rt.n_hops(0, d))

    if op == "halo":
        # ``nbytes`` = one halo slab; the decomposition grid is the 2D
        # torus's own dims, else a 1 x P line over the linearised ranks
        grid = topo.dims if topo.dims is not None and len(topo.dims) == 2 \
            else (1, P)
        if plan.transport == "packet":
            pkt_bytes = PACKET_ELEMS * 4
            K = packet_n_packets(max(int(nbytes // 4), 1), PACKET_ELEMS)
            total = 0
            for drx, dry, _axis in HALO_DIRECTIONS:
                pairs = halo_pairs(grid, drx, dry)
                if not pairs:
                    continue
                n_steps, _ = packet_bounds(rt, pairs, K,
                                           pkt_elems=PACKET_ELEMS)
                total += n_steps
            return total * model.hop_time(pkt_bytes) * \
                model.injection_cycles(PACKET_R)
        _, _, reports = simulate_rounds(
            topo, rt, halo_rounds(grid, nbytes, nbytes)
        )
        return sum(
            r.ticks * model.hop_time_wire(r.flit_bytes_max, plan.wire)
            for r in reports
        )

    if plan.transport == "packet":
        pkt_bytes = PACKET_ELEMS * 4
        if op in ("p2p", "bcast", "reduce"):
            # the packet backend drives the same logical schedule; cost it
            # as the chain's per-link serialisation of the full message
            pairs, n_rounds = [(0, far)], 1
            per_sender = nbytes
        else:  # allreduce: 2(P-1) identical ring permutes of nbytes/P
            pairs, n_rounds = [(i, (i + 1) % P) for i in range(P)], 2 * (P - 1)
            per_sender = nbytes / P
        K = packet_n_packets(max(int(per_sender // 4), 1), PACKET_ELEMS)
        n_steps, _ = packet_bounds(rt, pairs, K, pkt_elems=PACKET_ELEMS)
        return n_rounds * n_steps * model.hop_time(pkt_bytes) * \
            model.injection_cycles(PACKET_R)

    # static / fused: replay the exact schedule; tick period set by the
    # flit's wire bytes under the plan's wire format
    if op == "p2p":
        rep = simulate(topo, rt, p2p_messages(rt, 0, far, nbytes,
                                              plan.n_chunks))
        return rep.ticks * model.hop_time_wire(rep.flit_bytes_max, plan.wire)
    if op == "allreduce" and plan.wire == "int8":
        # the compressed wire runs the once-quantised-contribution RS
        # (distance-s permutes, real multi-hop cost) + a compressed AG
        rounds = compressed_reduce_scatter_rounds(P, nbytes / P) + [
            ring_perm_round(P, nbytes / P) for _ in range(P - 1)
        ]
    else:
        rounds = collective_rounds(topo, rt, op, plan.algo, nbytes,
                                   n_chunks=plan.n_chunks)
    _, _, reports = simulate_rounds(topo, rt, rounds)
    wire_s = sum(
        r.ticks * model.hop_time_wire(r.flit_bytes_max, plan.wire)
        for r in reports
    )
    # reducing ops fold an accumulate into every schedule tick; the unfused
    # static backend pays the HBM round-trip between permute and add on each
    # of them, the fused backend's receive+accumulate kernel does not
    # (transport/fused.py).  An upper-estimate tick count (every round
    # charged) is fine: it shifts all unfused plans of one schedule equally.
    if op in ("reduce", "allreduce") and plan.transport != "fused":
        wire_s += model.unfused_add_latency * sum(r.ticks for r in reports)
    return wire_s


@dataclass
class TuningTable:
    """op x size -> (best plan, its score, the static default's score)."""

    topo_sig: str
    model: LinkModel
    entries: dict = field(default_factory=dict)  # (op, size) -> dict

    def lookup(self, op: str, nbytes: int) -> Plan:
        """Best plan for the nearest swept size (log-distance)."""
        sizes = sorted({s for (o, s) in self.entries if o == op})
        if not sizes:
            return DEFAULT_PLAN
        nbytes = max(int(nbytes), 1)
        best = min(sizes, key=lambda s: abs(s.bit_length() - nbytes.bit_length()))
        e = self.entries[(op, best)]
        return Plan(e["transport"], e["n_chunks"], e["algo"],
                    e.get("wire", "raw"))

    def score(self, op: str, nbytes: int) -> float:
        e = self.entries[(op, nbytes)]
        return e["score"]

    # -- persistence (the cached tuning-table format of DESIGN.md §6) ------

    def to_json(self) -> str:
        return json.dumps({
            "topo_sig": self.topo_sig,
            "model": {
                "hop_latency": self.model.hop_latency,
                "link_bw": self.model.link_bw,
                "injection_base": self.model.injection_base,
                "switch_cycles": self.model.switch_cycles,
                "quant_latency": self.model.quant_latency,
                "unfused_add_latency": self.model.unfused_add_latency,
            },
            "entries": [
                {"op": op, "nbytes": size, **e}
                for (op, size), e in sorted(self.entries.items())
            ],
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "TuningTable":
        spec = json.loads(s)
        t = TuningTable(spec["topo_sig"], LinkModel(**spec["model"]))
        for e in spec["entries"]:
            e = dict(e)
            t.entries[(e.pop("op"), e.pop("nbytes"))] = e
        return t

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "TuningTable":
        with open(path) as f:
            return TuningTable.from_json(f.read())


def topo_signature(topo, rt=None) -> str:
    """Cache key: the connection graph AND the route table — one topology
    admits different route sets (DOR vs BFS tie-breaks), and plans scored
    against one must not be served to a communicator using the other."""
    sig = topo.to_json()
    if rt is not None:
        sig += "|" + rt.next_hop.tobytes().hex()
    return sig


def autotune(
    topo, rt=None, *,
    ops=OPS, sizes=SIZE_GRID, model: LinkModel | None = None,
    transports=("static", "packet", "fused"), n_chunks_grid=N_CHUNKS_GRID,
    wires=WIRES,
) -> TuningTable:
    """Sweep plans over the (op x size) grid and record the winners.

    The wire dimension (``wires``) is swept for static-schedule plans:
    an ``"int8"`` wire is the compressed-link backend wrapping the same
    schedule.  The raw static default remains in every candidate set, so
    a compressed plan is only ever recorded when the simulator scores it
    strictly better — compression can win bandwidth-bound cells but never
    displaces the default on latency-bound ones.  The fused backend runs
    the identical static schedules but skips the per-tick unfused-add cost
    on reducing ops; ties (ops with no accumulate) keep the static default
    via the strict-< argmin.
    """
    from ..core.routing import compute_route_table  # lazy: keep import light

    if rt is None:
        rt = compute_route_table(topo)
    model = model or LinkModel()
    table = TuningTable(topo_signature(topo, rt), model)
    for op in ops:
        algos = ALGOS[op]
        for size in sizes:
            best = None
            default_score = None
            for tname in transports:
                # wire formats ride static schedules; the packet cost
                # model is packetisation-based, so it scores raw only.
                # The rooted "reduce" op is also excluded: its chain/tree/
                # staged schedules re-quantise the travelling partial sum
                # every hop (no once-quantised form exists for it yet), so
                # an int8 plan there would compound error with P — the
                # exact failure the compressed reduce-scatter schedule
                # avoids (DESIGN.md §7).  "halo" is excluded too: the apps
                # layer diffs distributed against single-rank results
                # exactly, so a lossy wire there is an explicit user
                # choice (comm_mode="smi:compressed"), never a tuned one
                wire_grid = wires if tname == "static" \
                    and op not in ("reduce", "halo") else ("raw",)
                for wire in wire_grid:
                    for algo in algos:
                        chunk_grid = n_chunks_grid
                        if tname == "packet" or algo in ("tree", "staged") \
                                or op in ("allreduce", "halo"):
                            # whole-message rounds / router packetisation /
                            # ring RS+AG / single-hop halo permutes:
                            # chunking cannot change the schedule
                            chunk_grid = (1,)
                        for nc in chunk_grid:
                            plan = Plan(tname, nc, algo, wire)
                            s = score_plan(topo, rt, op, size, plan, model)
                            if plan == DEFAULT_PLAN or (
                                op == "p2p"
                                and plan == Plan("static", 1, "routed")
                            ):
                                default_score = s
                            if best is None or s < best[1]:
                                best = (plan, s)
            plan, s = best
            assert default_score is not None, "default plan must be swept"
            # invariant: argmin over a set containing the default
            assert s <= default_score + 1e-18
            table.entries[(op, size)] = {
                **plan.to_dict(), "score": s, "static_score": default_score,
            }
            if obs.TRACING:
                obs.emit("tuner.plan", tag=op, nbytes=int(size), topology=topo.name, score=s,
                         static_score=default_score, **plan.to_dict())
    return table


# ---------------------------------------------------------------------------
# in-process table cache — what Communicator / the dispatchers consult
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def tuning_table_for(topo, rt=None, model: LinkModel | None = None) -> TuningTable:
    sig = topo_signature(topo, rt)
    if sig not in _TABLES:
        _TABLES[sig] = autotune(topo, rt, model=model)
    return _TABLES[sig]


def tuned_plan(op: str, comm, nbytes: int) -> Plan:
    """The table-backed decision point used by the core dispatchers."""
    table = tuning_table_for(comm.topology, comm.route_table)
    return table.lookup(op, nbytes)


def clear_cache():
    _TABLES.clear()
