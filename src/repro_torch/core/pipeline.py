"""Pipeline parallelism over SMI streaming channels (``repro.core.pipeline``).

The paper's GESUMMV application (§5.4.1) is MPMD functional decomposition:
rank 0 computes GEMV and streams its results into rank 1's AXPY.
Generalised, that is pipeline parallelism: each rank owns one stage's
parameters, and activations stream stage to stage through a chain channel
while every stage computes on its current microbatch -- a GPipe schedule
whose inter-stage transfer is one channel hop along the stage chain.

The ranks are stacked (``core/comm.py``): a stage's parameters and its
input are rank-stacked ``(P, ...)``, so one call of the stage function
computes every stage's tick at once (one kernel D launch a tick for a
product stage).  The backward is autograd through the unrolled schedule: a
hop is an index copy along the rank dimension, whose transpose moves the
gradient one stage back, so the reverse pipeline needs no code of its own.
"""

from __future__ import annotations

from typing import Callable

import torch

from .comm import Communicator
from .streaming import _mask_sel


def pipeline_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor, comm: Communicator):
    """Run ``stage_fn`` as a P-stage pipeline over microbatches.

    ``stage_fn(params, x) -> y``: ``params`` every stage's parameters,
    rank-stacked (rank r = stage r), ``x`` and ``y`` the rank-stacked
    ``(P, mb, ...)`` inputs and outputs, of one shape (homogeneous stages).
    ``x_mb`` is ``(M, mb, ...)``, read by stage 0 only.

    Returns ``(P, M, mb, ...)``: the last stage's outputs on rank P-1, zeros
    on the other ranks.  Schedule: M + P - 1 ticks; at tick t stage s
    computes microbatch t - s, and the activations hop one stage a tick
    through the chain channel (tag ``"pp.stage"``, opened once for the
    schedule and tallied once a tick)."""
    from ..parallel.layers import stage_transport

    P = comm.size
    r = comm.rank()
    M = x_mb.shape[0]
    chain = [(i, i + 1) for i in range(P - 1)]
    spec, t = stage_transport(comm)
    buf = None
    outs = [None] * M
    for tk in range(M + P - 1):
        m = tk - r                                   # each stage's microbatch
        active = (m >= 0) & (m < M)
        feed = x_mb[min(tk, M - 1)].unsqueeze(0).expand((P,) + tuple(x_mb.shape[1:]))
        inp = feed if buf is None else _mask_sel(r == 0, feed, buf)
        y = stage_fn(stage_params, inp)
        y = _mask_sel(active, y, torch.zeros((), dtype=y.dtype, device=y.device))
        if 0 <= tk - (P - 1) < M:                    # delivered at the last stage
            outs[tk - (P - 1)] = y[P - 1]
        with t.tagged(spec.stats_tag):
            buf = t.permute(y, comm, chain) if P > 1 else y
    last = torch.stack(outs).unsqueeze(0)
    return torch.cat((last.new_zeros((P - 1,) + tuple(last.shape[1:])), last))


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params, x_mb: torch.Tensor,
                  y_mb: torch.Tensor, comm: Communicator) -> torch.Tensor:
    """The pipelined forward and each microbatch's ``loss_fn(pred,
    target) -> scalar`` at the last stage; returns their mean, a 0-dim
    tensor (the reference sums it over the ranks, so every stage sees the
    last stage's value).  Autograd through it gives every stage's gradient,
    the reverse schedule by transposition."""
    out = pipeline_apply(stage_fn, stage_params, x_mb, comm)[comm.size - 1]
    return torch.stack([loss_fn(out[i], y_mb[i]) for i in range(out.shape[0])]).mean()
