"""Rank-process functions of tests/test_torch_spmd_packet.py.

The rank processes import this module by name, so it imports neither JAX
nor ``repro``: only ``torch`` and the port.  Each function takes the
process-mode communicator and the rows of the ranks its process holds, and
returns rows (stacked again in rank order by the group) and plain values.
"""

from __future__ import annotations

from repro_torch.core import RouterConfig, run_router, snake_bus
from repro_torch.transport import get_transport

#: the partial permutation of the packet cases (ranks 2 and 5 receive nothing)
PARTIAL = ((0, 3), (1, 0), (3, 1), (4, 7), (6, 4), (7, 6))


def router(comm, pay, dst, ln, *, cfg: RouterConfig, tbl, n_steps: int) -> dict:
    """``run_router`` on this process's ranks (``tbl`` the whole route
    table): its rows of ``(out_pay, out_cnt, overflow, t_done)``."""
    out = run_router(cfg, comm, tbl, pay, dst, ln, n_steps)
    return dict(zip(("out_pay", "out_cnt", "overflow", "t_done"), out))


def _stats(t) -> dict:
    """A transport's counters (one tuple: the group lists it a process) and
    the overflow of the ranks held here."""
    return {"stats": (t.stats.steps, t.stats.bytes_moved, t.stats.by_tag),
            "overflow": t.stats.overflow}


def packet_steps(comm, x, snake: bool, pkt_elems: int, key: str = "packet") -> dict:
    """The packet wire's steps on ``comm`` (its topology, or the snake bus
    embedded in its torus) over the transport ``key``: a permute by the
    partial permutation, +-1 ring shifts and a 5-hop p2p, each on a
    transport instance of its own, tagged: the rows and the counters (the
    overflow of the ranks held here)."""
    if snake:
        comm = comm.with_topology(snake_bus(tuple(comm.axis_sizes)))
    steps = {"permute": lambda t, v: t.permute(v, comm, PARTIAL),
             "shift+1": lambda t, v: t.shift(v, comm, 1),
             "shift-1": lambda t, v: t.shift(v, comm, -1),
             "p2p": lambda t, v: t.p2p(v, src=0, dst=5, comm=comm, n_chunks=2)}
    out = {}
    for name, step in steps.items():
        t = get_transport(key, device=comm.device, pkt_elems=pkt_elems)
        with t.tagged(name):
            y = step(t, x)
        out[name] = {"y": y, **_stats(t)}
    return out


def reroute(comm, x, pkt_elems: int) -> dict:
    """One packet transport instance shifting ``x`` by -1 over the torus,
    then over the snake bus embedded in it: the rows of each, the route
    tables it cached and the overflow of the ranks held here."""
    t = get_transport("packet", device=comm.device, pkt_elems=pkt_elems)
    out = {}
    for name, c in (("torus", comm), ("snake_bus", comm.with_topology(snake_bus(
            tuple(comm.axis_sizes))))):
        out[name] = t.shift(x, c, -1)
    out["tables"] = len(t._tbl_cache)
    out["overflow"] = t.stats.overflow
    return out


def block_tick_launches(comm) -> int:
    """This process's launches of kernel C's block-tick form so far."""
    from repro_torch.kernels.router import router_tick_block

    return router_tick_block.launches
