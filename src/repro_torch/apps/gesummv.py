"""GESUMMV, ``y = alpha A x + beta B x`` (paper §5.4.1, Fig. 13), on one
rank and as the paper's two-rank functional decomposition.

On two ranks, rank 0 holds A and rank 1 holds B; each computes its GEMV
from its own memory, and rank 0 streams its scaled result to rank 1 through
an SMI channel (``open_channel(comm, src=0, dst=1, port=None,
n_chunks=8).transfer``), where the two are summed.  On the FPGAs the two
ranks double the memory bandwidth this memory-bound routine gets.  Here
both ranks are rows of one rank-stacked tensor on one card and share its
memory, so the decomposition moves the same bytes through the same memory
as the single-rank form: it shows the channel at work, not the paper's 2x.
The GEMVs are ``torch.matmul`` (the reference computes them outside any
Pallas kernel too).
"""

from __future__ import annotations

import torch

from ..channels import open_channel
from ..core.comm import Communicator

ALPHA, BETA = 1.5, 2.5


def gesummv(A: torch.Tensor, B: torch.Tensor, x: torch.Tensor, *, alpha: float = ALPHA,
            beta: float = BETA) -> torch.Tensor:
    """Single rank: both GEMVs from one memory, ``alpha A x + beta B x``."""
    return alpha * (A @ x) + beta * (B @ x)


def gesummv_two_ranks(AB: torch.Tensor, x: torch.Tensor, comm: Communicator, *,
                      alpha: float = ALPHA, beta: float = BETA, n_chunks: int = 8,
                      transport=None) -> torch.Tensor:
    """Two stacked ranks: ``AB`` is ``(2, N, N)`` with A on rank 0 and B on
    rank 1, ``x`` the ``(N,)`` vector every rank holds.  Both partial GEMVs
    run in one call; rank 0's scaled result streams to rank 1 through a
    transient anonymous channel of ``n_chunks`` chunks.  Returns ``(2, N)``:
    ``y`` on rank 1, zeros on rank 0."""
    if comm.size != 2 or AB.dim() != 3 or AB.shape[0] != 2:
        raise ValueError(f"the two-rank GESUMMV takes a 2-rank communicator and a (2, N, N) "
                         f"stack, not {comm.size} ranks and {tuple(AB.shape)}")
    partial = AB @ x                                               # (2, N)
    partial = torch.where(comm.rank(2) == 0, alpha * partial, beta * partial)
    got = open_channel(comm, src=0, dst=1, port=None, n_chunks=n_chunks,
                       transport=transport).transfer(partial)
    return torch.where(comm.rank(2) == 1, partial + got, torch.zeros_like(partial))
