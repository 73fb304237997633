"""Link-level discrete-event simulator for message schedules
(``repro.netsim.sim``).

Replays a set of :class:`Message` flows over a :class:`~repro_torch.core.
topology.Topology` and its :class:`~repro_torch.core.routing.RouteTable`
under the structural rules the transports implement:

* one flit (chunk / packet) per directed link per tick;
* store-and-forward: a flit arriving at an intermediate rank departs on its
  next link no earlier than the following tick;
* per-link arbitration among the input FIFOs wanting that link, with the
  router's transit priority, R-sticky polling and optional switch bubble
  (``core/router.py``);
* bounded transit FIFOs with backpressure: a flit only traverses a link
  when the downstream queue has room (stalls are counted, never dropped).

The simulator works in abstract *ticks*; :class:`SimReport` converts to
seconds through a :class:`~repro_torch.netsim.model.LinkModel`.  For an
uncontended routed transfer the tick count is the static transport's
schedule (``n_chunks + hops - 1``), which is what lets the tests hold the
simulator equal to ``TransportStats`` tick for tick.  Pure Python.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAX_TICKS_FACTOR = 64  # runaway guard: ticks <= factor * total flit-hops


@dataclass
class Message:
    """One logical flow: ``n_flits`` equal flits from ``src`` along a route.

    ``path`` overrides route-table lookup with an explicit rank list (used
    for chain collectives, where the stream multicast-taps every rank on the
    way and delivery time is the last rank's last flit).  ``pipelined``
    messages inject at most one flit per tick (the static chunk pipeline);
    staged messages have every flit FIFO-ready at ``t_start`` (the packet
    router's pre-staged input queues).
    """

    src: int
    dst: int
    n_flits: int = 1
    flit_bytes: float = 0.0
    t_start: int = 0
    port: int = 0
    pipelined: bool = True
    path: list | None = None


@dataclass
class SimReport:
    """What one simulation run produced."""

    ticks: int
    flit_bytes_max: float
    msg_done: list            # per-message delivery tick (inclusive)
    link_busy: dict           # (a, b) -> flits carried
    link_max_queue: dict      # (a, b) -> peak transit-queue depth
    stalls: int               # link-tick slots lost to full downstream FIFOs
    flit_hops: int            # total flits x hops moved
    byte_hops: float          # total payload bytes x hops moved
    dropped: int = 0          # flits past a full (rank, port) delivery buffer
    #: per-tick move log, only filled by ``simulate(..., trace=True)``:
    #: (tick, src, dst, msg index, delivered) per link traversal
    moves: list = field(default_factory=list)

    def occupancy(self, link) -> float:
        """Fraction of ticks the directed ``link`` carried a flit."""
        return self.link_busy.get(tuple(link), 0) / max(self.ticks, 1)

    def congestion(self) -> int:
        """Peak transit-queue depth across all links (0 == contention-free)."""
        return max(self.link_max_queue.values(), default=0)

    def time(self, model) -> float:
        """Seconds under ``model``: every tick forwards at most one flit per
        link, so the tick period is one max-size-flit hop."""
        return self.ticks * model.hop_time(self.flit_bytes_max)


@dataclass
class _Flit:
    msg: int
    idx: int
    route: tuple
    leg: int = 0  # next edge index into route


def _route_of(msg: Message, rt) -> tuple:
    if msg.path is not None:
        return tuple(msg.path)
    return tuple(rt.path(msg.src, msg.dst))


def simulate(
    topo,
    rt,
    messages,
    *,
    fifo_depth: int | None = None,
    R: int | None = None,
    switch_bubble: bool = False,
    out_cap: int | None = None,
    trace: bool = False,
) -> SimReport:
    """Run the schedule to completion and report.

    ``fifo_depth`` bounds every transit FIFO (None = unbounded); ``R`` is
    the arbiter's polling stickiness (None = pure round-robin with free
    switching); ``switch_bubble`` burns the link's cycle whenever the
    arbiter acquires a new input FIFO (the paper's Tab. 4 cost);
    ``out_cap`` bounds every (rank, port) delivery buffer — a flit past it
    is dropped on arrival and counted in :attr:`SimReport.dropped`, the
    device router's delivery-overrun semantics (it still counts toward
    message completion so an undersized buffer can't hang the schedule).
    ``trace=True`` additionally records every link traversal into
    :attr:`SimReport.moves` (off by default: tuner sweeps replay thousands
    of schedules and must not pay the log).
    """
    messages = list(messages)
    routes = [_route_of(m, rt) for m in messages]
    for m, route in zip(messages, routes):
        assert len(route) >= 1, "empty route"
        for a, b in zip(route[:-1], route[1:]):
            assert b in topo.links[a], (
                f"route edge {a}->{b} is not a topology link"
            )

    # Per directed link: transit FIFO + the injection FIFOs (one per message
    # originating on it, in port order — the router's input queues).
    transit: dict = {}
    inject: dict = {}
    for li, (m, route) in enumerate(zip(messages, routes)):
        if len(route) < 2:
            continue
        edge = (route[0], route[1])
        inject.setdefault(edge, []).append(li)
    for edge in inject:
        inject[edge].sort(key=lambda li: (messages[li].port, li))

    sent = [0 for _ in messages]        # flits that left the source FIFO
    done_flits = [0 for _ in messages]
    msg_done = [-1 for _ in messages]
    n_live = sum(1 for m, r in zip(messages, routes) if len(r) >= 2)
    for li, route in enumerate(routes):
        if len(route) < 2:  # src == dst: delivered at t_start for free
            msg_done[li] = messages[li].t_start
            done_flits[li] = messages[li].n_flits

    edges = sorted(
        set(inject) | {
            (a, b)
            for route in routes
            for a, b in zip(route[:-1], route[1:])
        }
    )
    last_src: dict = {e: -1 for e in edges}   # arbiter state per link
    stick: dict = {e: 0 for e in edges}
    link_busy: dict = {}
    link_max_queue: dict = {}
    stalls = 0
    flit_hops = 0
    byte_hops = 0.0
    dropped = 0
    moves_log: list | None = [] if trace else None
    out_fill: dict = {}  # (rank, port) -> delivered flits held

    total_work = sum(
        m.n_flits * (len(r) - 1) for m, r in zip(messages, routes)
    )
    max_ticks = max(16, MAX_TICKS_FACTOR * max(total_work, 1))

    def _ready(li: int, t: int) -> bool:
        m = messages[li]
        if sent[li] >= m.n_flits or t < m.t_start:
            return False
        if m.pipelined and sent[li] > (t - m.t_start):
            return False  # the pipeline injects one chunk per tick
        return True

    t = 0
    pending = n_live
    while pending > 0:
        assert t < max_ticks, "simulator failed to converge (routing loop?)"
        moves = []  # (edge, flit, from_transit)
        reserved: dict = {}  # downstream edge -> flits already bound this tick
        for edge in edges:
            tq = transit.get(edge, [])
            link_max_queue[edge] = max(link_max_queue.get(edge, 0), len(tq))
            # candidate sources: injection FIFOs in port order, transit last
            # (mirrors core/router.py's source indexing)
            srcs = inject.get(edge, [])
            S = len(srcs) + 1
            avail = [ _ready(li, t) for li in srcs ] + [bool(tq)]

            def _flit_of(s):
                if s == S - 1:
                    return tq[0]
                li = srcs[s]
                return _Flit(li, sent[li], routes[li], 0)

            def _has_room(fl: _Flit) -> bool:
                route, leg = fl.route, fl.leg
                if leg + 1 == len(route) - 1:
                    return True  # delivery, no queue
                if fifo_depth is None:
                    return True
                down = (route[leg + 1], route[leg + 2])
                q = len(transit.get(down, [])) + reserved.get(down, 0)
                return q < fifo_depth

            # transit priority, then R-sticky polling (core/router.py step 1)
            chosen = -1
            if avail[S - 1]:
                chosen = S - 1
            elif any(avail):
                last = last_src[edge]
                # R-sticky: keep draining the latched FIFO up to R flits;
                # R=None means pure round-robin (free switching)
                keep = (
                    R is not None
                    and 0 <= last < S
                    and stick[edge] < R
                    and avail[last]
                )
                if keep:
                    chosen = last
                else:
                    start = (last + 1) % S if last >= 0 else 0
                    for off in range(S):
                        cand = (start + off) % S
                        if avail[cand]:
                            chosen = cand
                            break
            if chosen < 0:
                continue
            s_is_transit = chosen == S - 1
            fl = _flit_of(chosen)
            if not _has_room(fl):
                stalls += 1
                continue
            if switch_bubble and chosen != last_src[edge]:
                # acquiring a new FIFO burns the cycle; the arbiter latches
                last_src[edge] = chosen
                stick[edge] = 0
                continue
            stick[edge] = stick[edge] + 1 if chosen == last_src[edge] else 0
            last_src[edge] = chosen
            if s_is_transit:
                tq.pop(0)
            else:
                sent[fl.msg] += 1
                fl.leg = 0
            if fl.leg + 1 < len(fl.route) - 1:
                down = (fl.route[fl.leg + 1], fl.route[fl.leg + 2])
                reserved[down] = reserved.get(down, 0) + 1
            moves.append((edge, fl))

        for edge, fl in moves:
            link_busy[edge] = link_busy.get(edge, 0) + 1
            flit_hops += 1
            byte_hops += messages[fl.msg].flit_bytes
            fl.leg += 1
            route = fl.route
            if moves_log is not None:
                moves_log.append(
                    (t, edge[0], edge[1], fl.msg, fl.leg == len(route) - 1)
                )
            # delivery is by path position, not rank value: route-expanded
            # logical chains may revisit a rank before terminating there
            if fl.leg == len(route) - 1:
                if out_cap is not None:
                    slot = (route[-1], messages[fl.msg].port)
                    if out_fill.get(slot, 0) >= out_cap:
                        dropped += 1
                    else:
                        out_fill[slot] = out_fill.get(slot, 0) + 1
                done_flits[fl.msg] += 1
                if done_flits[fl.msg] == messages[fl.msg].n_flits:
                    msg_done[fl.msg] = t
                    pending -= 1
            else:
                down = (route[fl.leg], route[fl.leg + 1])
                transit.setdefault(down, []).append(fl)
        t += 1

    flit_max = max((m.flit_bytes for m in messages), default=0.0)
    return SimReport(
        ticks=t,
        flit_bytes_max=flit_max,
        msg_done=msg_done,
        link_busy=link_busy,
        link_max_queue=link_max_queue,
        stalls=stalls,
        flit_hops=flit_hops,
        byte_hops=byte_hops,
        dropped=dropped,
        moves=moves_log if moves_log is not None else [],
    )


def simulate_rounds(topo, rt, rounds, model=None, **kw):
    """Run barrier-separated schedule rounds (tree collectives, ring shifts).

    Each round starts when the previous one fully completes.  Returns
    ``(total_ticks, total_seconds, reports)`` — seconds is None without a
    ``model``.
    """
    total_ticks = 0
    total_s = 0.0 if model is not None else None
    reports = []
    for msgs in rounds:
        rep = simulate(topo, rt, msgs, **kw)
        reports.append(rep)
        total_ticks += rep.ticks
        if model is not None:
            total_s += rep.time(model)
    return total_ticks, total_s, reports
