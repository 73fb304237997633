"""Dynamic packet-switched transport (paper §4.2–§4.3), on the rank stack.

A port of ``repro.core.router``: the paper's CK_S/CK_R kernels forward
fixed-size packets over the physical links by routing tables that are
uploaded at runtime.  The fixed link schedule (one link per ±1 step of each
torus dim) is the compiled program; the ``(n, n)`` route table mapping
(rank, dst) to a link id is runtime data, so swapping tables re-routes the
same kernel without building anything (the paper's §5.3.1 experiment).

Per router tick: every link arbitrates a packet whose table entry routes it
out that link (transit first, then the input FIFOs with R-stickiness,
§4.3), all links fire (invalid packets ride as bubbles), and arrivals are
delivered (dst == rank) or parked in the transit FIFO.  A delivery past
``out_cap`` or a park past ``transit_cap`` drops the packet and counts it
in ``overflow``.

Three implementations of the same tick, equal bit for bit on
``(out_pay, out_cnt, overflow, t_done)``:

* ``impl="scalar"`` — the reference's per-link loop, vectorised over the
  ranks only: the oracle, and the path for fabrics with no links and for
  non-float32 wires;
* ``impl="vector"`` — :func:`~repro_torch.kernels.router.router_run_ref`,
  the whole-state tick of ``kernels/router/ref.py`` with a gather exchange
  between ticks and an early exit once the network drains;
* ``impl="kernel"`` — kernel C (``csrc/router.cu``): the whole run in one
  CUDA launch, on the kernel ``kernels.router.router_path`` picks by shape.

``impl=None`` takes ``kernel`` on a CUDA tensor and ``vector`` on a CPU
tensor, as the reference takes Pallas on a TPU and ``vector`` elsewhere.

With ranks run as processes (``comm.group``, :mod:`repro_torch.core.spmd`)
each process ticks only the ranks it holds, one tick at a time, and the
link rows cross between processes after every tick, the drain test a
group-wide sum: the reference's own loop under ``shard_map``.  There
``kernel`` is kernel C's block-tick form, one launch a tick, ``vector`` its
plain version, and ``scalar`` (the stacked oracle) is refused.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.router import (
    init_state,
    router_run,
    router_run_ref,
    router_tick_block,
    router_tick_block_plain,
    tick_spec_of,
)
from ..kernels.router.ref import ROW_HEAD
from ..obs import trace as obs
from .comm import Communicator
from .routing import compute_route_table, physical_link_map
from .topology import Topology

LOCAL = -1  # routing-table value for "deliver here" (never looked up)
IMPLS = ("scalar", "vector", "kernel")


def make_links(dims: tuple[int, ...]):
    """Physical link list for a torus mesh: (link_id, perm pairs).

    link 2*i   = +1 along dim i; link 2*i+1 = -1 along dim i (omitted when
    the dim has size <= 2, where -1 == +1)."""
    topo = Topology.torus(dims)
    n = topo.n_ranks
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    strides = list(reversed(strides))

    def coords(r):
        return [(r // strides[i]) % dims[i] for i in range(len(dims))]

    def rank_of(c):
        return sum(c[j] * strides[j] for j in range(len(dims)))

    links = []
    for i, d in enumerate(dims):
        if d == 1:
            continue
        steps = (+1,) if d == 2 else (+1, -1)
        for sidx, step in enumerate(steps):
            pairs = []
            for r in range(n):
                c = coords(r)
                c[i] = (c[i] + step) % d
                pairs.append((r, rank_of(c)))
            links.append((2 * i + sidx, pairs))
    return links


def make_router_tables(topology: Topology, dims: tuple[int, ...], rt=None) -> np.ndarray:
    """The route generator for the dynamic router: (n, n) int32 of link ids.

    Every edge of ``topology`` must be a physical neighbour pair on the
    ``dims`` torus (logical connections are real wires).  Entry [r, d] =
    physical link id of the first hop r -> d.  Pass ``rt`` (a precomputed
    RouteTable, e.g. a communicator's) to follow exactly those paths."""
    if rt is None:
        rt = compute_route_table(topology)
    phys = physical_link_map(dims)
    # remap ids for size-2 dims where only the +1 link exists
    live_ids = {lid for lid, _ in make_links(dims)}

    def canon(lid):
        return lid if lid in live_ids else lid - 1  # -1 of a size-2 dim -> +1

    n = topology.n_ranks
    tbl = np.full((n, n), LOCAL, dtype=np.int32)
    for r in range(n):
        for d in range(n):
            if r == d:
                continue
            nh = int(rt.next_hop[r, d])
            if (r, nh) not in phys:
                raise ValueError(
                    f"logical edge {r}->{nh} of {topology.name} is not a physical "
                    f"link on torus{dims}; embed the topology first (e.g. snake_bus)"
                )
            tbl[r, d] = canon(phys[(r, nh)])
    return tbl


def snake_bus(dims: tuple[int, int]) -> Topology:
    """A linear bus embedded in the torus along a boustrophedon path — the
    paper's 'treat the 8 FPGAs as a linear bus by editing the connection
    list' experiment (§5.3.1)."""
    X, Y = dims
    order = []
    for x in range(X):
        ys = range(Y) if x % 2 == 0 else range(Y - 1, -1, -1)
        order += [x * Y + y for y in ys]
    edges = list(zip(order[:-1], order[1:]))
    return Topology.from_edges(X * Y, edges, name=f"snake_bus{dims}")


@dataclass(frozen=True)
class RouterConfig:
    dims: tuple[int, ...]
    n_ports: int = 2          # application endpoints per rank
    fifo_cap: int = 8         # input FIFO depth (paper: compile-time buffer)
    transit_cap: int = 16     # CK transit queue depth
    out_cap: int = 16         # delivery buffer per port
    pkt_elems: int = 32       # payload elements (the 28 B packet, scaled)
    R: int = 8                # polling stickiness (paper §4.3)
    switch_bubble: bool = False  # switching input FIFOs costs one dead
    # cycle on the link (the paper's Tab. 4 effect; opt-in)
    tick_batch: int | None = None  # ticks the vector path runs between two
    # drain checks (None = 4); the kernel checks every tick.  Never changes
    # a result.


def _exchange_tables(links, n: int):
    """Static per-rank exchange tables.

    ``nbr[r, li]`` = the rank link ``li`` delivers to from ``r``;
    ``src[r, li]`` = the rank whose link-``li`` packet lands on ``r``.
    ``packed_ok`` is True when every rank's link destinations are distinct
    (always the case for torus links)."""
    NL = len(links)
    nbr = np.zeros((n, NL), np.int32)
    src = np.zeros((n, NL), np.int32)
    for li, (_lid, pairs) in enumerate(links):
        for s, d in pairs:
            nbr[s, li] = d
            src[d, li] = s
    packed_ok = all(len(set(nbr[q])) == NL for q in range(n))
    return nbr, src, packed_ok


@functools.lru_cache(maxsize=64)
def _fabric(dims: tuple[int, ...], device: torch.device):
    """(links, link ids, ``src`` exchange table on ``device``) of a torus,
    made once per fabric and device."""
    links = make_links(dims)
    n = int(np.prod(dims)) if dims else 1
    _, src, _ = _exchange_tables(links, n)
    return links, tuple(lid for lid, _ in links), torch.from_numpy(src).to(device)


def run_router(
    cfg: RouterConfig,
    comm: Communicator,
    route_tbl: torch.Tensor,   # (n, n) int32 link ids — RUNTIME data
    inq_pay: torch.Tensor,     # (P, n_ports, fifo_cap, E) staged messages
    inq_dst: torch.Tensor,     # (P, n_ports, fifo_cap) destination ranks
    inq_len: torch.Tensor,     # (P, n_ports) packets staged per FIFO
    n_steps: int,
    *,
    impl: str | None = None,
):
    """Run up to ``n_steps`` router ticks on every rank of ``comm``.

    Returns ``(out_pay, out_cnt, overflow, t_done)``: per-port delivery
    buffers ``(P, n_ports, out_cap, E)``, their fill counts, the loss
    counter per rank (0 == lossless run) and the last delivery tick.
    ``impl`` picks the datapath (see the module docstring).  The vector
    and kernel datapaths stop once the network drains, which never changes
    the returned values.  ``impl="kernel"`` on a CPU tensor raises: the
    kernel has no CPU mode.
    """
    n = comm.size
    links, link_ids, src = _fabric(tuple(cfg.dims), inq_pay.device)
    if impl is None:
        impl = "kernel" if inq_pay.device.type == "cuda" else "vector"
    if impl not in IMPLS:
        raise ValueError(f"unknown router impl {impl!r}; one of {IMPLS}")
    if impl == "vector" and (not links or inq_pay.dtype != torch.float32):
        # degenerate fabrics (no links) and other wire dtypes keep the
        # reference path; the packetised wire is always float32
        impl = "scalar"
    if obs.TRACING:
        obs.emit("router.run", impl=impl, n_steps=int(n_steps), n_links=len(links),
                 n_ports=int(cfg.n_ports), dims=list(cfg.dims))
    route_tbl = route_tbl.to(torch.int32)
    inq_dst, inq_len = inq_dst.to(torch.int32), inq_len.to(torch.int32)
    if impl == "scalar":
        if comm.group is not None:
            raise ValueError("impl='scalar' is the stacked oracle; ranks run as processes tick "
                             "on impl='vector' or 'kernel'")
        return _run_router_scalar(cfg, comm, route_tbl, inq_pay, inq_dst, inq_len, n_steps,
                                  links)
    spec = tick_spec_of(cfg, n, link_ids)
    batch = 4 if cfg.tick_batch is None else cfg.tick_batch
    if obs.TRACING:
        # the drain test's batch (clamped to divide n_steps, as the plain
        # run clamps it) and how the pending count is read: summed over the
        # rank stack, the reference's psum mode (its lane mode reads the
        # packed exchange's own pending lane on pre-VMA runtimes)
        B = max(1, min(int(batch), int(n_steps)))
        while n_steps % B:
            B -= 1
        obs.emit("router.tick_batch", batch=B, n_batches=int(n_steps) // B, lane_live=False)
        obs.emit("router.drain", mode="psum")
    if comm.group is not None:
        return _run_router_process(spec, tuple(cfg.dims), comm, route_tbl, inq_pay, inq_dst,
                                   inq_len, n_steps, batch, impl)
    if impl == "vector":
        out = router_run_ref(spec, route_tbl, src, inq_pay, inq_dst, inq_len, n_steps, batch)
    else:
        if inq_pay.device.type != "cuda":
            raise ValueError("impl='kernel' runs kernel C, which needs CUDA tensors; "
                             "use impl='vector' or 'scalar' on the CPU")
        out = router_run(spec, route_tbl.contiguous(), src, inq_pay.contiguous(),
                         inq_dst.contiguous(), inq_len.contiguous(), n_steps)
    return out[:4]


@functools.lru_cache(maxsize=64)
def _src_table(dims: tuple[int, ...]) -> np.ndarray:
    """The host copy of a torus's ``src`` exchange table (the link
    exchange's plan is made from it)."""
    links = make_links(dims)
    return _exchange_tables(links, int(np.prod(dims)) if dims else 1)[1]


def link_row_bytes(dims: tuple[int, ...], pkt_elems: int) -> int:
    """Bytes a rank's link rows of one tick take in a rank process's receive
    slot (``core/spmd.py``): a row a link, its header and payload."""
    return len(make_links(tuple(dims))) * (ROW_HEAD + pkt_elems) * 4


def _run_router_process(spec, dims, comm, route_tbl, inq_pay, inq_dst, inq_len, n_steps: int,
                        batch: int, impl: str):
    """The router run of a rank process: it ticks the ranks ``[lo, lo +
    n_local)`` it holds, on their rows of the staged input and of the route
    table, and between ticks moves every link's rows through the group's
    link exchange, the drain test a group-wide sum once a batch of ticks,
    as the reference's loop does under ``shard_map`` (tick, exchange, drain
    check).  ``impl="kernel"`` ticks on kernel C's block-tick form (CUDA
    tensors only), ``"vector"`` on its plain version.  Returns the held
    ranks' ``(out_pay, out_cnt, overflow, t_done)``, which stacked in rank
    order equal the stacked run's."""
    lo, n, dev = comm.lo, comm.n_local, inq_pay.device
    if tuple(route_tbl.shape) != (comm.size, comm.size):
        raise ValueError(f"a rank process routes on the whole ({comm.size}, {comm.size}) route "
                         f"table, not one of shape {tuple(route_tbl.shape)}")
    if impl == "kernel" and dev.type != "cuda":
        raise ValueError("impl='kernel' runs kernel C, which needs CUDA tensors; "
                         "use impl='vector' on the CPU")
    tick = router_tick_block if impl == "kernel" else router_tick_block_plain
    src = _src_table(dims)
    tbl = route_tbl[lo:lo + n].contiguous()
    inq_pay, inq_dst, inq_len = (a.contiguous() for a in (inq_pay, inq_dst, inq_len))
    st = init_state(spec, n, dev, inq_pay.dtype)
    arr = torch.zeros((n, spec.n_links, ROW_HEAD + spec.pkt_elems), dtype=torch.int32,
                      device=dev)
    B = max(1, min(int(batch), int(n_steps)))
    while n_steps % B:
        B -= 1
    t, total = 0, None
    while t < n_steps:
        for k in range(B):
            st, snd, pend = tick(spec, tbl, inq_pay, inq_dst, inq_len, st, arr, lo, t)
            arr, total = comm.group.exchange_links(
                snd, src, int(pend.cpu().sum()) if k == B - 1 else None)
            t += 1
        if total == 0:
            break
    # the final exchange's arrivals are still in flight at loop exit
    st, _, _ = tick(spec, tbl, inq_pay, inq_dst, inq_len, st, arr, lo, t, arbitrate=False)
    return st["out_pay"], st["out_cnt"], st["overflow"], st["t_done"]


def _run_router_scalar(cfg, comm, route_tbl, inq_pay, inq_dst, inq_len, n_steps, links):
    """The per-link reference loop (the equivalence oracle), with every
    rank's state a row of one tensor: per tick, each link arbitrates in link
    order against the sources earlier links took, all links fire, and the
    arrivals are absorbed one link at a time."""
    n = comm.size
    P, E, NP, NL = inq_pay.shape[0], cfg.pkt_elems, cfg.n_ports, len(links)
    S, TC, OC = NP + 1, cfg.transit_cap, cfg.out_cap
    dev = inq_pay.device
    rows = torch.arange(P, device=dev)
    r = rows.to(torch.int32)
    ports = torch.arange(NP, device=dev)
    _, _, src = _fabric(tuple(cfg.dims), dev)
    src = src.long()

    def z(*shape, dt=torch.int32):
        return torch.zeros((P,) + shape, dtype=dt, device=dev)

    inq_head, tr_head, tr_cnt = z(NP), z(), z()
    tr_pay, tr_dst, tr_port = z(TC, E, dt=inq_pay.dtype), z(TC), z(TC)
    out_pay, out_cnt = z(NP, OC, E, dt=inq_pay.dtype), z(NP)
    overflow, t_done = z(), z()
    last_src, stick = z(NL), z(NL)

    for t in range(n_steps):
        # ---- gather candidate heads: sources 0..NP-1 = FIFOs, NP = transit
        hc = inq_head.clamp(max=cfg.fifo_cap - 1)
        th = tr_head % TC
        pays = torch.cat([inq_pay[rows.view(-1, 1), ports.view(1, -1), hc],
                          tr_pay[rows, th].unsqueeze(1)], 1)               # (P, S, E)
        dsts = torch.cat([inq_dst[rows.view(-1, 1), ports.view(1, -1), hc],
                          tr_dst[rows, th].unsqueeze(1)], 1)               # (P, S)
        prts = torch.cat([ports.to(torch.int32).expand(P, NP), tr_port[rows, th].unsqueeze(1)], 1)
        has = torch.cat([inq_head < inq_len, (tr_cnt > 0).unsqueeze(1)], 1)
        want = torch.where(dsts == r.view(-1, 1), torch.full_like(dsts, -2),
                           route_tbl.gather(1, dsts.clamp(0, n - 1).long()))

        taken = torch.zeros((P, S), dtype=torch.bool, device=dev)
        sel_src = []
        for li, (lid, _) in enumerate(links):
            avail = has & (want == lid) & ~taken
            tr_want = avail[:, S - 1]
            last = last_src[:, li]
            keep = (stick[:, li] < cfg.R) & avail.gather(
                1, last.clamp(0, S - 1).long().view(-1, 1)).squeeze(1)
            idxs = (last.view(-1, 1) + 1 + torch.arange(S, device=dev, dtype=torch.int32)) % S
            off = torch.argmax(avail.gather(1, idxs.long()).to(torch.int32), dim=1, keepdim=True)
            rr = idxs.gather(1, off).squeeze(1)
            chosen = torch.where(tr_want, torch.full_like(last, S - 1), torch.where(keep, last, rr))
            any_avail = avail.any(1)
            if cfg.switch_bubble:
                send = any_avail & (chosen == last)
            else:
                send = any_avail
            last_src[:, li] = torch.where(any_avail, chosen, last)
            stick[:, li] = torch.where(send & (chosen == last), stick[:, li] + 1,
                                       torch.zeros_like(last))
            chosen = torch.where(send, chosen, torch.full_like(chosen, -1))
            hit = send.view(-1, 1) & (torch.arange(S, device=dev) == chosen.view(-1, 1))
            taken = taken | hit
            sel_src.append(chosen)

        # ---- pop selected sources
        for c in sel_src:
            inq_head += (c.view(-1, 1) == ports.view(1, -1)).to(torch.int32)
            tr_pop = (c == S - 1).to(torch.int32)
            tr_head += tr_pop
            tr_cnt -= tr_pop

        # ---- fire all links (fixed wiring; bubbles ride as invalid)
        arrivals = []
        for li, c in enumerate(sel_src):
            val = c >= 0
            cs = c.clamp(0, S - 1).long()
            pay = pays[rows, cs]
            dst = torch.where(val, dsts.gather(1, cs.view(-1, 1)).squeeze(1),
                              torch.full_like(c, -1))
            prt = torch.where(val, prts.gather(1, cs.view(-1, 1)).squeeze(1), torch.zeros_like(c))
            g = src[:, li]  # every rank receives link li's packet from src[r, li]
            arrivals.append((pay[g], dst[g], prt[g], val[g]))

        # ---- absorb arrivals, one link at a time: deliver or park
        for pay, dst, prt, val in arrivals:
            mine = val & (dst == r)
            fwd = val & (dst != r)
            fits = out_cnt.gather(1, prt.clamp(0, NP - 1).long().view(-1, 1)).squeeze(1) < OC
            delivered = mine & fits
            for p in range(NP):
                hit = delivered & (prt == p)
                slot = out_cnt[:, p].clamp(0, OC - 1).long()
                out_pay[rows[hit], p, slot[hit]] = pay[hit]
                out_cnt[:, p] += hit.to(torch.int32)
            overflow += (mine & ~fits).to(torch.int32)
            t_done = torch.where(delivered, torch.full_like(t_done, t), t_done)
            room = tr_cnt < TC
            ok = fwd & room
            tail = ((tr_head + tr_cnt) % TC).long()
            tr_pay[rows[ok], tail[ok]] = pay[ok]
            tr_dst[rows[ok], tail[ok]] = dst[ok]
            tr_port[rows[ok], tail[ok]] = prt[ok]
            tr_cnt += ok.to(torch.int32)
            overflow += (fwd & ~room).to(torch.int32)
    return out_pay, out_cnt, overflow, t_done
