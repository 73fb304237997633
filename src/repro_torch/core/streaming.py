"""The transfer-level point-to-point shim, the single-hop exchange and the
rank-mask helper (paper §3.1).

* :func:`stream_p2p` — the legacy whole-message entry point: it opens a
  transient anonymous-port p2p channel (:mod:`repro_torch.channels`) and
  transfers through it; its ``transport=``/``plan=`` keywords are
  deprecated.
* :func:`stream_exchange` — the halo-exchange wire: one step over explicit
  (src, dst) pairs.

The channel API is re-exported here for the reference's import paths.  The
reference's ``run_spmd``, ``make_test_mesh`` and ``pvary`` have no
counterpart: the ranks are the leading dimension of every tensor, not
devices of a mesh.
"""

from __future__ import annotations

import warnings

import torch

from .comm import Communicator


def _mask_sel(pred, a, b):
    """``where(pred, a, b)`` with a per-rank predicate ``pred`` of shape
    (P,) broadcast over the rank-stacked ``a`` and ``b``."""
    return torch.where(pred.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def stream_p2p(x: torch.Tensor, *, src: int, dst: int, comm: Communicator, n_chunks: int = 1,
               transport=None, plan=None) -> torch.Tensor:
    """Stream row ``src`` of the rank-stacked ``x`` to row ``dst`` along the
    routed path; zeros on every other rank.

    A shim over the channel API: it opens a transient anonymous-port p2p
    channel carrying the call's config and transfers through it (the static
    and fused backends run the chunk-pipelined multi-hop schedule with
    ``n_chunks`` chunks in flight; the packet backend stages the message
    into the router).  ``transport=`` and ``plan=`` are deprecated here:
    carry them on the channel (``open_channel(comm, src=..., dst=...,
    transport=..., plan=...)``), where they configure every transfer and
    push/pop of the channel."""
    from ..channels import open_channel

    if transport is not None or plan is not None:
        warnings.warn(
            "stream_p2p(transport=..., plan=...) is deprecated; open a channel carrying the "
            "config instead: open_channel(comm, src=..., dst=..., transport=..., "
            "plan=...).transfer(x)",
            DeprecationWarning, stacklevel=2)
    ch = open_channel(comm, src=src, dst=dst, port=None, transport=transport, plan=plan)
    return ch.transfer(x, n_chunks=n_chunks)


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


#: channel API names served lazily from repro_torch.channels (PEP 562): the
#: channels package imports core.comm, so an import at the top would cycle
_CHANNEL_EXPORTS = ("Channel", "ChannelSpec", "channel_transfer", "open_channel", "pop", "push")


def __getattr__(name):
    if name in _CHANNEL_EXPORTS:
        from .. import channels

        return getattr(channels, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
