"""The plain PyTorch version of kernel C: one router tick on all P ranks.

A port of ``repro.kernels.router.ref``.  Every tensor carries the leading
rank dimension ``P``; behind it the shapes are the reference's per-rank
shapes (``inq_pay (P, NP, fifo_cap, E)``, ``tr_pay (P, transit_cap, E)``,
``out_pay (P, NP, out_cap, E)``, int32 counters).  ``r`` is the rank id of
every row (``arange(P)``) and ``t`` the tick, a Python int.

Absorb keeps the reference's exclusive prefix sums in link order: arrival
``li``'s delivery slot is ``out_cnt[port]`` plus the earlier arrivals of
the same tick that deliver to the same port, and its transit tail is the
count of earlier parked arrivals.  A masked scatter writes only the rows
its mask keeps, which is ``mode="drop"`` of the reference.  Arbitration is
the reference's one-shot masked argmax over the ``(NL, S)`` availability
matrix, exact because each candidate wants exactly one link.

:func:`router_run_ref` loops :func:`router_tick` over a whole router run
with the gather exchange between ticks; it is what the kernel
``csrc/router.cu`` computes in one launch.  Payloads move only by index
and ``where``, never through arithmetic, so any float32 bit pattern
(an int32 payload bit-cast to float32, NaNs included) arrives unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

I32 = torch.int32


@dataclass(frozen=True)
class TickSpec:
    """Static shape/config of one router tick."""

    n: int                    # ranks
    n_ports: int
    fifo_cap: int
    transit_cap: int
    out_cap: int
    pkt_elems: int
    R: int
    switch_bubble: bool
    link_ids: tuple[int, ...]  # physical id of each link, in link order

    @property
    def n_links(self) -> int:
        return len(self.link_ids)

    @property
    def n_srcs(self) -> int:
        """Arbitration candidates per link: the input FIFOs + transit."""
        return self.n_ports + 1


def tick_spec_of(cfg, n: int, link_ids) -> TickSpec:
    """Build a TickSpec from a ``core.router.RouterConfig``."""
    return TickSpec(
        n=n, n_ports=cfg.n_ports, fifo_cap=cfg.fifo_cap,
        transit_cap=cfg.transit_cap, out_cap=cfg.out_cap,
        pkt_elems=cfg.pkt_elems, R=cfg.R,
        switch_bubble=cfg.switch_bubble, link_ids=tuple(link_ids),
    )


def init_state(spec: TickSpec, P: int, device, dtype=torch.float32) -> dict:
    """The zero router state of ``P`` ranks (the reference's ``init``)."""
    NP, NL, E = spec.n_ports, spec.n_links, spec.pkt_elems

    def z(*shape, dt=I32):
        return torch.zeros((P,) + shape, dtype=dt, device=device)

    return dict(
        inq_head=z(NP), tr_pay=z(spec.transit_cap, E, dt=dtype),
        tr_dst=z(spec.transit_cap), tr_port=z(spec.transit_cap),
        tr_head=z(), tr_cnt=z(), out_pay=z(NP, spec.out_cap, E, dt=dtype),
        out_cnt=z(NP), overflow=z(), last_src=z(NL), stick=z(NL), t_done=z(),
    )


def _count(mask: torch.Tensor, dim: int) -> torch.Tensor:
    return mask.sum(dim, dtype=I32)


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim, dtype=I32) - x


def _put_rows(buf, mask, index, values):
    """Copy of ``buf`` with ``buf[p, *index[p, l]] = values[p, l]`` where
    ``mask[p, l]``; rows the mask drops are not written."""
    p, li = mask.nonzero(as_tuple=True)
    return buf.index_put((p, *(ix[p, li].long() for ix in index)), values[p, li])


def router_absorb(spec: TickSpec, st, arr_pay, arr_dst, arr_prt, arr_val, r, t):
    """Absorb one tick's arrivals on every rank: deliver (dst == rank) or
    park in transit.

    ``arr_*`` are the ``(P, NL)`` link arrivals in link order; ``t`` labels
    the tick the arrivals completed (the ``t_done`` stamp).  A delivery
    past ``out_cap`` and a park past ``transit_cap`` both drop the packet
    and count it in ``overflow``.  Returns a new state dict.
    """
    NP, NL = spec.n_ports, spec.n_links
    if NL == 0:
        return st
    st = dict(st)
    me = r.view(-1, 1)
    mine = arr_val & (arr_dst == me)                           # (P, NL)
    fwd = arr_val & (arr_dst != me)
    prt = arr_prt.clamp(0, NP - 1)

    # -- deliveries: per-port slots via exclusive prefix sums in link order
    ports = torch.arange(NP, device=prt.device)
    hot = mine.unsqueeze(2) & (prt.unsqueeze(2) == ports)      # (P, NL, NP)
    prior = _excl_cumsum(hot.to(I32), 1)
    slot = st["out_cnt"].gather(1, prt) + prior.gather(2, prt.unsqueeze(2)).squeeze(2)
    ok_del = mine & (slot < spec.out_cap)
    st["out_pay"] = _put_rows(st["out_pay"], ok_del, (prt, slot), arr_pay)
    st["out_cnt"] = st["out_cnt"] + _count(hot & ok_del.unsqueeze(2), 1)
    st["overflow"] = st["overflow"] + _count(mine & ~ok_del, 1)
    st["t_done"] = torch.where(ok_del.any(1), torch.full_like(st["t_done"], t), st["t_done"])

    # -- transit parking: ring-buffer tails via exclusive prefix sum
    off = _excl_cumsum(fwd.to(I32), 1)                         # (P, NL)
    room = (st["tr_cnt"].view(-1, 1) + off) < spec.transit_cap
    ok_park = fwd & room
    tail = (st["tr_head"].view(-1, 1) + st["tr_cnt"].view(-1, 1) + off) % spec.transit_cap
    st["tr_pay"] = _put_rows(st["tr_pay"], ok_park, (tail,), arr_pay)
    st["tr_dst"] = _put_rows(st["tr_dst"], ok_park, (tail,), arr_dst)
    st["tr_port"] = _put_rows(st["tr_port"], ok_park, (tail,), arr_prt)
    st["tr_cnt"] = st["tr_cnt"] + _count(ok_park, 1)
    st["overflow"] = st["overflow"] + _count(fwd & ~room, 1)
    return st


def router_arbitrate(spec: TickSpec, my_tbl, inq_pay, inq_dst, inq_len, st, r,
                     link_ids=None):
    """Arbitrate all links of every rank in one shot and pop the selected
    sources.

    ``my_tbl`` is the ``(P, n)`` route table (row ``r`` = rank ``r``'s).
    Returns ``(st, snd_pay, snd_dst, snd_prt, snd_val, pending)``: the
    ``(P, NL)`` outgoing link rows plus each rank's remaining work count
    (staged + parked + in flight) for the early-exit ticker.
    """
    NP, NL, S, n = spec.n_ports, spec.n_links, spec.n_srcs, spec.n
    dev = inq_pay.device
    if link_ids is None:
        link_ids = torch.tensor(spec.link_ids, dtype=I32, device=dev)
    st = dict(st)
    P = inq_pay.shape[0]
    rows = torch.arange(P, device=dev)

    # candidate heads: sources 0..NP-1 = input FIFOs, S-1 = transit
    hclip = st["inq_head"].clamp(max=spec.fifo_cap - 1)        # (P, NP)
    pr, pp = rows.view(-1, 1), torch.arange(NP, device=dev).view(1, -1)
    fifo_pay = inq_pay[pr, pp, hclip]                          # (P, NP, E)
    fifo_dst = inq_dst[pr, pp, hclip]
    fifo_has = st["inq_head"] < inq_len
    th = st["tr_head"] % spec.transit_cap
    cand_pay = torch.cat([fifo_pay, st["tr_pay"][rows, th].unsqueeze(1)], 1)
    cand_dst = torch.cat([fifo_dst, st["tr_dst"][rows, th].unsqueeze(1)], 1)
    cand_prt = torch.cat([pp.to(I32).expand(P, NP), st["tr_port"][rows, th].unsqueeze(1)], 1)
    cand_has = torch.cat([fifo_has, (st["tr_cnt"] > 0).unsqueeze(1)], 1)

    want = torch.where(cand_dst == r.view(-1, 1), torch.full_like(cand_dst, -2),
                       my_tbl.gather(1, cand_dst.clamp(0, n - 1).long()))   # (P, S)
    A = cand_has.unsqueeze(1) & (want.unsqueeze(1) == link_ids.view(1, -1, 1))  # (P, NL, S)

    last = st["last_src"]                                      # (P, NL)
    tr_want = A[..., S - 1]
    keep = (st["stick"] < spec.R) & A.gather(2, last.clamp(0, S - 1).long().unsqueeze(2)).squeeze(2)
    idxs = (last.unsqueeze(2) + 1 + torch.arange(S, device=dev, dtype=I32)) % S  # (P, NL, S)
    rot = A.gather(2, idxs.long())
    off = torch.argmax(rot.to(I32), dim=2, keepdim=True)       # first maximum
    rr = idxs.gather(2, off).squeeze(2)
    chosen = torch.where(tr_want, torch.full_like(last, S - 1), torch.where(keep, last, rr))
    any_avail = A.any(2)
    if spec.switch_bubble:
        send = any_avail & (chosen == last)
    else:
        send = any_avail
    st["last_src"] = torch.where(any_avail, chosen, last)
    st["stick"] = torch.where(send & (chosen == last), st["stick"] + 1, torch.zeros_like(last))
    sel = torch.where(send, chosen, torch.full_like(chosen, -1))  # (P, NL)

    # pops (availability sets are disjoint: each source selected at most once)
    st["inq_head"] = st["inq_head"] + _count(sel.unsqueeze(2) == pp.view(1, 1, -1), 1)
    tr_pops = _count(sel == S - 1, 1)
    st["tr_head"] = st["tr_head"] + tr_pops
    st["tr_cnt"] = st["tr_cnt"] - tr_pops

    # outgoing rows (invalid selections ride as bubbles)
    cs = sel.clamp(0, S - 1).long()
    snd_val = sel >= 0
    snd_pay = cand_pay[rows.view(-1, 1), cs]                   # (P, NL, E)
    snd_dst = torch.where(snd_val, cand_dst.gather(1, cs), torch.full_like(sel, -1))
    snd_prt = torch.where(snd_val, cand_prt.gather(1, cs), torch.zeros_like(sel))

    pending = (inq_len - st["inq_head"]).sum(1, dtype=I32) + st["tr_cnt"] + _count(snd_val, 1)
    return st, snd_pay, snd_dst, snd_prt, snd_val, pending


def router_tick(spec: TickSpec, my_tbl, inq_pay, inq_dst, inq_len, st,
                arr_pay, arr_dst, arr_prt, arr_val, r, t, link_ids=None):
    """One full tick: absorb the previous tick's arrivals (labelled
    ``t - 1``), then arbitrate/pop the outgoing rows for tick ``t``."""
    st = router_absorb(spec, st, arr_pay, arr_dst, arr_prt, arr_val, r, t - 1)
    return router_arbitrate(spec, my_tbl, inq_pay, inq_dst, inq_len, st, r, link_ids)


#: int32 words ahead of a packet's payload in a link row: destination, port, valid
ROW_HEAD = 3


def pack_rows(pay, dst, prt, val) -> torch.Tensor:
    """One tick's ``(P, NL)`` link rows as one ``(P, NL, ROW_HEAD + E)``
    int32 tensor: destination, port, valid, then the float32 payload's
    bits (the form the rows cross between rank processes in)."""
    return torch.cat([dst.to(I32).unsqueeze(2), prt.to(I32).unsqueeze(2),
                      val.to(I32).unsqueeze(2), pay.contiguous().view(I32)], 2)


def unpack_rows(rows: torch.Tensor):
    """:func:`pack_rows`'s inverse: ``(pay, dst, prt, val)``."""
    return (rows[..., ROW_HEAD:].contiguous().view(torch.float32), rows[..., 0],
            rows[..., 1], rows[..., 2] != 0)


def router_tick_block_plain(spec: TickSpec, my_tbl, inq_pay, inq_dst, inq_len, st, arr, lo: int,
                            t: int, arbitrate: bool = True):
    """One tick of the ranks ``[lo, lo + n)`` on their own state: the plain
    version of kernel C's block-tick form.  ``my_tbl`` is the block's
    ``(n, P)`` rows of the route table, ``arr`` the ``(n, NL, ROW_HEAD +
    E)`` link rows that arrived from tick ``t - 1``.  Returns ``(st, snd,
    pending)``: the new state, this tick's send rows (packed the same way)
    and each rank's pending count; with ``arbitrate=False`` only the
    arrivals are absorbed and ``snd`` and ``pending`` are None."""
    n = inq_pay.shape[0]
    r = torch.arange(lo, lo + n, device=inq_pay.device, dtype=I32)
    pay, dst, prt, val = unpack_rows(arr)
    if not arbitrate:
        return router_absorb(spec, st, pay, dst, prt, val, r, t - 1), None, None
    st, sp, sd, sq, sv, pend = router_tick(spec, my_tbl, inq_pay, inq_dst, inq_len, st, pay,
                                           dst, prt, val, r, t)
    return st, pack_rows(sp, sd, sq, sv), pend


def router_run_ref(spec: TickSpec, route_tbl, src, inq_pay, inq_dst, inq_len,
                   n_steps: int, tick_batch: int = 4):
    """A whole router run of up to ``n_steps`` ticks on every rank: the
    plain version of kernel C.

    Between ticks the exchange is a gather, ``arr[r, li] = snd[src[r, li],
    li]`` (``src`` from ``core.router._exchange_tables``).  The drain check
    runs once per batch of ``tick_batch`` ticks (clamped to divide
    ``n_steps``, so a live network never ticks past the budget); idle
    ticks are identity on every output, so stopping early changes nothing.
    Returns ``(out_pay, out_cnt, overflow, t_done, ticks)``; ``ticks``, a
    Python int, is the number of ticks run.
    """
    P, NL = inq_pay.shape[0], spec.n_links
    dev = inq_pay.device
    r = torch.arange(P, device=dev, dtype=I32)
    link_ids = torch.tensor(spec.link_ids, dtype=I32, device=dev)
    inq_len = inq_len.to(I32)
    st = init_state(spec, P, dev, inq_pay.dtype)
    arr = (torch.zeros((P, NL, spec.pkt_elems), dtype=inq_pay.dtype, device=dev),
           torch.zeros((P, NL), dtype=I32, device=dev),
           torch.zeros((P, NL), dtype=I32, device=dev),
           torch.zeros((P, NL), dtype=torch.bool, device=dev))
    gather_src, lanes = src.long(), torch.arange(NL, device=dev)

    B = max(1, min(int(tick_batch), int(n_steps)))
    while n_steps % B:
        B -= 1
    t = 0
    while t < n_steps:
        for _ in range(B):
            st, sp, sd, sq, sv, pend = router_tick(
                spec, route_tbl, inq_pay, inq_dst, inq_len, st, *arr, r, t, link_ids)
            arr = (sp[gather_src, lanes], sd[gather_src, lanes], sq[gather_src, lanes],
                   sv[gather_src, lanes])
            t += 1
        if int(pend.sum()) == 0:
            break
    # the final exchange's arrivals are still in flight at loop exit
    st = router_absorb(spec, st, *arr, r, t - 1)
    return st["out_pay"], st["out_cnt"], st["overflow"], st["t_done"], t
