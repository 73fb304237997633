"""Static transport: routed index-copy schedules on the rank stack.

The fast path.  Every logical step is one :func:`~repro_torch.core.comm.
ppermute` — an index copy along the rank dimension — and routing decisions
are burnt into the schedule from the communicator's route table, as the
reference's trace-time ``lax.ppermute`` schedules are.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.comm import ppermute
from .base import Transport
from .registry import register_transport


@register_transport("static")
@dataclass
class StaticTransport(Transport):
    """One index copy per step; the collectives' default backend."""

    def permute(self, x, comm, pairs):
        self._check(x)
        self.account(x)
        if isinstance(x, tuple):
            return tuple(ppermute(v, pairs) for v in x)
        return ppermute(x, pairs)

    def p2p(self, x, *, src, dst, comm, n_chunks: int = 1):
        """Chunk-pipelined multi-hop transfer (paper §3.1 / Fig. 9).

        Each rank's message (dim 1 of the stack) splits into ``n_chunks``
        chunks that move through the routed pipe one hop per step, all
        hops advancing in parallel — one copy per step carrying every
        in-flight chunk (asynchronicity degree k of §3.3 = path length)."""
        from ..core.streaming import _mask_sel

        if src == dst:
            return x
        self._check(x)
        path = comm.route_table.path(src, dst)
        hops = len(path) - 1
        pairs = comm.path_perm(path)

        S = x.shape[1]
        if S % n_chunks:
            raise ValueError(f"message length {S} not divisible by n_chunks={n_chunks}")
        csz = S // n_chunks
        r = comm.rank()
        steps = n_chunks + hops - 1

        y = torch.zeros_like(x)
        pipe = x.new_zeros((x.shape[0], csz) + tuple(x.shape[2:]))
        self.account(pipe, steps=steps)
        for t in range(steps):
            # the source loads chunk t while there is one left
            if t < n_chunks:
                pipe = _mask_sel(r == path[0], x[:, t * csz:(t + 1) * csz], pipe)
            # one pipeline shift: every hop advances
            pipe = ppermute(pipe, pairs)
            # the destination stores chunk t - hops + 1 when it arrives
            c = t - (hops - 1)
            if c >= 0:
                y[path[-1], c * csz:(c + 1) * csz] = pipe[path[-1]]
        return y
