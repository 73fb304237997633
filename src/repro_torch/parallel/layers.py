"""The parallel layers the model calls (``repro.parallel.layers``).

At tensor-parallel degree 1 every collective is the identity and every
projection is one matrix product.  At tp = P > 1 the ranks are stacked:
every activation and sharded weight carries a leading rank dimension
``(P, ...)``, row ``r`` being what rank ``r`` holds under the reference's
``shard_map``; replicated weights stay one copy, which broadcasting hands to
every rank.  Each layer call then owns a
:class:`~repro_torch.channels.ChannelSpec` (:func:`layer_spec`: the TP
communicator, the launch's transport backend, the layer's stats tag) and
drives the streamed schedule of ``core/overlap.py`` or
``core/collectives.py`` through a fresh transport resolved from it, every
wire byte tallied under the tag (and mirrored into an active
:func:`~repro_torch.parallel.ledger.capture`).  ``comm_mode="bulk"`` runs
the same collectives as one pass over the rank stack (the reference's
``lax.all_gather`` / ``psum_scatter`` / ``psum``), untallied, as there.

The projections' products are ``ctx.matmul_fn`` when the launch injects
one (kernel D: one launch per ring step for all P ranks), else
``torch.matmul`` cast back to the input dtype, which accumulates in float32
for bfloat16 and float32 inputs alike, as the reference's ``jnp.dot(...,
preferred_element_type=float32)`` does.

When the context carries a persistent
:class:`~repro_torch.channels.ChannelPool` (``ctx.channels``), each layer's
spec comes from the pool: the pool-prefixed tag and one persistent port
claim a tag.  ``wire="int8"`` runs a layer over the compressed link.

Not ported yet: tuned layer plans (``plan=`` raises, ROADMAP item 3), ring
attention, the MoE, loss, gradient and pipeline layers.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from ..channels import ChannelSpec
from ..core.collectives import _stream_allreduce_impl, stream_allgather, stream_reduce_scatter
from ..core.overlap import _default_mm, stream_allgather_matmul, stream_matmul_reducescatter
from ..mesh.api import PLAN_ROADMAP
from ..transport.base import rank_bytes
from . import ledger


def _matmul(ctx):
    return ctx.matmul_fn or _default_mm


def layer_spec(ctx, tag: str, *, kind: str = "allreduce", wire: str = "raw", plan=None,
               transport=None, port: int | None = None, n_chunks: int = 1,
               op=None) -> ChannelSpec:
    """The ChannelSpec a parallel layer owns: the context's TP communicator
    and launch-selected backend, the layer's stats tag, and the call's wire
    override.  A tuning plan (the call's or the context's) raises until the
    tuner is ported.

    When the context carries a persistent :class:`~repro_torch.channels.
    ChannelPool` (``ctx.channels``, a serving runtime), the spec comes from
    the pool: the same config under the pool-prefixed tag
    (``"serve.tp.attn.qkv"``), its port claimed persistently, one spec a tag
    for every later call."""
    if plan is None:
        plan = ctx.plan
    if plan is not None:
        raise NotImplementedError(f"plan={plan!r} on layer {tag!r}: {PLAN_ROADMAP}")
    if transport is None:
        transport = ctx.transport
    pool = ctx.channels
    if pool is not None:
        return pool.spec(tag, kind=kind, wire=wire, transport=transport, n_chunks=n_chunks,
                         op=op)
    return ChannelSpec(comm=ctx.model_comm, kind=kind, tag=tag, wire=wire, plan=plan,
                       transport=transport, port=port, n_chunks=n_chunks, op=op)


def _open(spec: ChannelSpec, x):
    """A fresh transport realising ``spec`` for one layer call, mirrored
    into the active capture ledger."""
    if spec.plan is not None:
        raise NotImplementedError(f"plan={spec.plan!r}: {PLAN_ROADMAP}")
    return ledger.attach(spec.resolve())


@contextmanager
def _tagged(t, tag: str | None):
    """Account the block under ``tag`` (no-op for untagged channels)."""
    if tag is None:
        yield t
    else:
        with t.tagged(tag):
            yield t


def _channel(ctx, x, tag, kind, spec, plan, transport, wire):
    if spec is None:
        spec = layer_spec(ctx, tag, kind=kind, wire=wire, plan=plan, transport=transport)
    return spec, _open(spec, x)


# ------------------------------------------------------------ tagged psums
#
# Sites the reference reduces with a raw lax.psum/pmax keep a plain sum or
# max over the rank dimension, tallied under the layer tag as one logical
# step moving one rank's tensor.


def psum_tagged(x, ctx, tag: str):
    if ctx.tp == 1:
        return x
    ledger.tally(tag, 1, rank_bytes(x))
    return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x)


def pmax_tagged(x, ctx, tag: str):
    if ctx.tp == 1:
        return x
    ledger.tally(tag, 1, rank_bytes(x))
    return x.amax(0, keepdim=True).expand_as(x)


# ------------------------------------------------------- linear projections


def column_parallel_linear(x2d, w, ctx, *, tag: str = "tp.col", spec=None, plan=None,
                           transport=None, wire: str = "raw", return_gathered: bool = False):
    """y = AG_seq(x) @ w_colshard through a tagged channel.

    ``x2d``: (P, t_local, K) sequence-sharded rows; ``w``: (P, K, N_local).
    Returns (P, t_local * tp, N_local) — full rows, local columns — with the
    all-gather streamed through the per-chunk GEMM (core/overlap.py).
    ``return_gathered=True`` also returns the gathered input (free on the
    ring: every shard transits every rank).  At tp = 1 the rank dimension
    is absent."""
    mm = _matmul(ctx)
    if ctx.tp == 1:
        y = mm(x2d, w)
        return (y, x2d) if return_gathered else y
    if not ctx.is_smi:
        xf = all_gather_rows(x2d)
        y = mm(xf, w)
        return (y, xf) if return_gathered else y
    spec, t = _channel(ctx, x2d, tag, "gather", spec, plan, transport, wire)
    with _tagged(t, spec.stats_tag):
        return stream_allgather_matmul(x2d, w, spec.comm, matmul=mm, transport=t,
                                       return_gathered=return_gathered)


def row_parallel_linear(x2d, w, ctx, *, tag: str = "tp.row", spec=None, plan=None,
                        transport=None, wire: str = "raw"):
    """y = RS_seq(x @ w_rowshard) through a tagged channel.

    ``x2d``: (P, t_full, K_local) full rows, local contraction; ``w``:
    (P, K_local, N).  Returns (P, t_full / tp, N) sequence shards, with the
    reduce-scatter streamed through the per-chunk GEMM."""
    mm = _matmul(ctx)
    if ctx.tp == 1:
        return mm(x2d, w)
    if not ctx.is_smi:
        return sum_scatter_rows(mm(x2d, w))
    spec, t = _channel(ctx, x2d, tag, "reduce", spec, plan, transport, wire)
    with _tagged(t, spec.stats_tag):
        return stream_matmul_reducescatter(x2d, w, spec.comm, matmul=mm, transport=t)


# --------------------------------------------------- sequence redistributes


def all_gather_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The bulk all-gather (``lax.all_gather(..., tiled=True)``): every
    rank's ``(m, ...)`` concatenated along the per-rank ``axis``, on every
    rank."""
    g = torch.cat(x.unbind(0), dim=axis)
    return g.unsqueeze(0).expand((x.shape[0],) + tuple(g.shape)).contiguous()


def sum_scatter_rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The bulk reduce-scatter (``lax.psum_scatter(..., tiled=True)``): the
    sum over ranks, split along the per-rank ``axis`` into P blocks, block
    ``r`` on rank ``r``."""
    P = x.shape[0]
    y = x.sum(0, dtype=x.dtype)
    return y.unflatten(axis, (P, y.shape[axis] // P)).movedim(axis, 0).contiguous()


def gather_sequence(x, ctx, axis: int = 0, *, tag: str = "tp.gather", spec=None, plan=None,
                    transport=None, wire: str = "raw"):
    """Plain sequence all-gather along the per-rank ``axis`` through a
    tagged channel (the K/V input of attention; decode logit assembly)."""
    if ctx.tp == 1:
        return x
    if not ctx.is_smi:
        return all_gather_rows(x, axis)
    spec, t = _channel(ctx, x, tag, "gather", spec, plan, transport, wire)
    with _tagged(t, spec.stats_tag):
        g = stream_allgather(x.movedim(axis + 1, 1), spec.comm, transport=t)
        return g.movedim(1, axis + 1)


def reduce_scatter_sequence(x, ctx, axis: int = 0, *, tag: str = "tp.scatter", spec=None,
                            plan=None, transport=None, wire: str = "raw"):
    """Sequence reduce-scatter along the per-rank ``axis`` through a tagged
    channel (the embedding's fused vocab-psum + sequence scatter)."""
    if ctx.tp == 1:
        return x
    if not ctx.is_smi:
        return sum_scatter_rows(x, axis)
    spec, t = _channel(ctx, x, tag, "reduce", spec, plan, transport, wire)
    with _tagged(t, spec.stats_tag):
        y = stream_reduce_scatter(x.movedim(axis + 1, 1), spec.comm, transport=t)
        return y.movedim(1, axis + 1)


def all_reduce(x, ctx, *, tag: str = "tp.allreduce", spec=None, plan=None, transport=None,
               wire: str = "raw"):
    """Full all-reduce over the model axis through a tagged channel
    (replicated-MLP decode)."""
    if ctx.tp == 1:
        return x
    if not ctx.is_smi:
        return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x).contiguous()
    spec, t = _channel(ctx, x, tag, "allreduce", spec, plan, transport, wire)
    with _tagged(t, spec.stats_tag):
        return _stream_allreduce_impl(x, spec.comm, transport=t)


# -------------------------------------------------------------- embedding


def parallel_embedding(table_local, ids, ctx, *, tag: str = "tp.embed"):
    """Vocab-parallel embedding lookup: every rank's shard partial, summed
    over ranks by one tagged psum."""
    return psum_tagged(parallel_embedding_partial(table_local, ids, ctx), ctx, tag)


def parallel_embedding_partial(table_local, ids, ctx):
    """This vocab shard's embedding rows of ``ids``; ids outside the shard
    give zero rows, as in the reference.  At tp > 1, ``table_local`` is the
    rank-stacked ``(P, V/P, D)`` and ``ids`` the replicated ids; the result
    is every rank's partial, ``(P,) + ids.shape + (D,)``."""
    V_local = table_local.shape[-2]
    zero = torch.zeros((), dtype=table_local.dtype, device=table_local.device)
    if ctx.tp == 1:
        local = ids - ctx.rank() * V_local
        ok = (local >= 0) & (local < V_local)
        return torch.where(ok[..., None], table_local[local.clamp(0, V_local - 1)], zero)
    r = ctx.rank(ids.dim() + 1)
    local = ids.unsqueeze(0) - r * V_local
    ok = (local >= 0) & (local < V_local)
    emb = table_local[r, local.clamp(0, V_local - 1)]
    return torch.where(ok[..., None], emb, zero)
