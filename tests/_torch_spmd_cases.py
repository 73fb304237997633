"""Rank-process functions of tests/test_torch_spmd.py.

The rank processes import this module by name, so it imports neither JAX
nor ``repro``: only ``torch`` and the port.  Each function takes the
process-mode communicator and the rows of the ranks its process holds, and
returns rows (stacked again in rank order by the group) and plain values.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.core import collectives as C
from repro_torch.core.comm import ppermute
from repro_torch.transport import get_transport

#: the partial permutation of the ppermute cases (ranks 2 and 5 receive nothing)
PARTIAL = ((0, 3), (1, 0), (3, 1), (4, 7), (6, 4), (7, 6))


def ring(P: int, k: int) -> tuple:
    return tuple((i, (i + k) % P) for i in range(P))


def ppermute_steps(P: int) -> dict:
    """The ppermute cases: ring shifts of +-1 and +-3, the partial
    permutation."""
    return {"ring+1": ring(P, 1), "ring-1": ring(P, -1), "ring+3": ring(P, 3),
            "ring-3": ring(P, -3), "partial": PARTIAL}


def ppermutes(comm, x, y):
    """Every case of :func:`ppermute_steps` on ``x``, and the partial
    permutation moving ``(x, y)`` as one tuple step."""
    out = {name: ppermute(x, pairs, comm) for name, pairs in ppermute_steps(comm.size).items()}
    out["tuple"] = ppermute((x, y), PARTIAL, comm)
    return out


#: name -> the collective on the port's module, as the reference's test cases
#: call it: (module, comm, transport, x) -> result
COLLECTIVES = {
    "allreduce": lambda m, c, t, x: m.allreduce(x, c, plan=None, transport=t),
    "reduce_scatter": lambda m, c, t, x: m.stream_reduce_scatter(x, c, transport=t),
    "reduce": lambda m, c, t, x: m.reduce(x, c, root=3, plan=None, transport=t),
    "bcast": lambda m, c, t, x: m.bcast(x, c, root=5, plan=None, transport=t),
    "allgather": lambda m, c, t, x: m.stream_allgather(x, c, transport=t),
}


def _launches():
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    return {"fold": fused_accumulate.launches, "shift": fused_shift_accumulate.launches}


def collective(comm, x, name: str, transport: str):
    """One collective of :data:`COLLECTIVES` over ``transport``: the rows,
    the transport's counters (total and by tag) and kernel A's launches in
    this process (its plain version on the CPU launches nothing)."""
    t = get_transport(transport, device=comm.device)
    before = _launches()
    with t.tagged(name):
        y = COLLECTIVES[name](C, comm, t, x)
    after = _launches()
    return {"y": y, "stats": (t.stats.steps, t.stats.bytes_moved, t.stats.by_tag),
            "launches": {k: after[k] - before[k] for k in after}}


def collectives(comm, x, names, transports):
    """:func:`collective` for every name and transport, in one call."""
    return {f"{n}/{t}": collective(comm, x, n, t) for n in names for t in transports}


def stencil(comm, tiles, steps: int, overlapped: bool, transport: str):
    """``steps`` steps of the 2D stencil on the rank grid of ``comm``'s
    axes over ``transport``: the tiles and the ``halo`` tag's counters."""
    from repro_torch.apps import HALO_TAG, DistributedStencil

    app = DistributedStencil.create(tuple(comm.axis_sizes), comm=comm)
    t = get_transport(transport, device=comm.device)
    out = app.run(tiles, steps, overlapped=overlapped, transport=t)
    return {"tiles": out, "halo": t.stats.tag_counts(HALO_TAG)}


def p2p(comm, x, hops=((1, 1), (4, 4), (7, 7)), count: int = 6, transport: str = "static"):
    """Channel transfers from rank 0 at each (destination, hops) of ``hops``
    and a push/pop loop of ``count`` elements: each destination's
    transferred rows, and its pops' valid bits and values, rows a rank."""
    from repro_torch.channels import open_channel

    out = {}
    for dst, _ in hops:
        t = get_transport(transport, device=comm.device)
        ch = open_channel(comm, src=0, dst=dst, port=None, n_chunks=2, transport=t)
        oks, vals = [], []
        pc = open_channel(comm, count=count, src=0, dst=dst, port=None, transport=t)
        for i in range(count + comm.route_table.n_hops(0, dst) - 1):
            if i < count:
                pc = pc.push(float(i + 1))
            pc, val, ok = pc.pop()
            oks.append(ok)
            vals.append(val)
        out[dst] = {"y": ch.transfer(x), "oks": torch.stack(oks, 1),
                    "vals": torch.stack(vals, 1), "popped": pc.popped,
                    "stats": (t.stats.steps, t.stats.bytes_moved)}
    return out


def raise_on_rank(comm, x, rank: int):
    """Raises in the process holding ``rank`` after one step; the others go
    on to the next step's barrier and wait there."""
    x = ppermute(x, ring(comm.size, 1), comm)
    if comm.is_local(rank):
        raise ValueError(f"rank {rank} failed on purpose")
    return ppermute(x, ring(comm.size, 1), comm)


def loaded_modules(comm):
    """The modules of JAX or of ``repro`` this rank process has loaded, and
    its threads' count on the CPU."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return {"bad": bad, "threads": torch.get_num_threads(), "lo": comm.lo}
