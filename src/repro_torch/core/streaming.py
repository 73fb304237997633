"""Single-hop exchange and the rank-mask helper (paper §3.1).

``stream_exchange`` is the halo-exchange wire: one step over explicit
(src, dst) pairs.  The chunk-pipelined point-to-point transfer is the
transport's ``p2p`` (``transport/static.py``); the channel API that wraps
it comes with a later slice.  The reference's ``run_spmd`` and
``make_test_mesh`` have no counterpart: the ranks are the leading
dimension of every tensor, not devices of a mesh.
"""

from __future__ import annotations

import torch

from .comm import Communicator


def _mask_sel(pred, a, b):
    """``where(pred, a, b)`` with a per-rank predicate ``pred`` of shape
    (P,) broadcast over the rank-stacked ``a`` and ``b``."""
    return torch.where(pred.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def stream_exchange(
    x: torch.Tensor,
    *,
    pairs: list[tuple[int, int]],
    comm: Communicator,
    transport=None,
    tag: str | None = None,
) -> torch.Tensor:
    """Single-hop bulk exchange over explicit (src, dst) pairs — the
    "fixed wiring" streaming model of paper Fig. 3.

    ``tag`` buckets the step's wire accounting under a message tag
    (:meth:`repro_torch.transport.base.Transport.tagged`)."""
    from ..transport.registry import resolve_transport

    t = resolve_transport(transport, comm)
    if tag is None:
        return t.permute(x, comm, pairs)
    with t.tagged(tag):
        return t.permute(x, comm, pairs)
