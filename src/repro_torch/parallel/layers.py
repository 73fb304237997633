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
claim a tag.  ``wire="int8"`` runs a layer over the compressed link.  A
plan (the call's or the context's; ``"auto"`` for a config's ``comm_plan``
under a bare ``comm_mode="smi"``) lets the netsim tuning table pick each
layer call's backend and wire, recorded per tag in the capture ledger's
``plans``.

The vocab-parallel cross entropy is the loss layer of training
(:func:`vocab_parallel_cross_entropy`).  Over the data axis's ``"dp"``
communicator, :func:`grad_allreduce` rings one gradient tensor over a
tagged ``"grad"`` channel and :func:`fsdp_allgather` gathers one FSDP
leaf over an ``"fsdp.gather"`` channel; :func:`stage_transport` is the
pipeline's chain channel (``core/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

from ..channels import ChannelSpec
from ..core.collectives import _stream_allreduce_impl, stream_allgather, stream_reduce_scatter
from ..core.overlap import (
    _default_mm,
    stream_allgather_matmul,
    stream_matmul_reducescatter,
    stream_ring_attention,
)
from ..transport.base import rank_bytes
from . import ledger

#: channel kind -> the netsim tuner op a ``plan="auto"`` consults (the
#: tuner prices rooted and ring collectives; ring all-gathers and
#: reduce-scatters cost like the all-reduce phases they compose into)
_PLAN_OPS = {"bcast": "bcast", "reduce": "allreduce", "gather": "allreduce",
             "scatter": "allreduce", "allreduce": "allreduce",
             "exchange": "allreduce", "p2p": "p2p"}


def _matmul(ctx):
    return ctx.matmul_fn or _default_mm


def layer_spec(ctx, tag: str, *, kind: str = "allreduce", wire: str = "raw", plan=None,
               transport=None, port: int | None = None, n_chunks: int = 1,
               op=None) -> ChannelSpec:
    """The ChannelSpec a parallel layer owns: the context's TP communicator
    and launch-selected backend, the layer's stats tag, and the call's
    wire/plan overrides.  ``transport=None`` inherits ``ctx.transport``
    unless a ``plan`` (the call's or the context's) is given: then the
    tuned plan picks the backend (pass ``transport`` to pin it).

    When the context carries a persistent :class:`~repro_torch.channels.
    ChannelPool` (``ctx.channels``, a serving runtime), the spec comes from
    the pool: the same config under the pool-prefixed tag
    (``"serve.tp.attn.qkv"``), its port claimed persistently, one spec a tag
    for every later call."""
    if plan is None:
        plan = ctx.plan
    if transport is None and plan is None:
        transport = ctx.transport
    pool = ctx.channels
    if pool is not None:
        return pool.spec(tag, kind=kind, wire=wire, plan=plan, transport=transport,
                         n_chunks=n_chunks, op=op)
    return ChannelSpec(comm=ctx.model_comm, kind=kind, tag=tag, wire=wire, plan=plan,
                       transport=transport, port=port, n_chunks=n_chunks, op=op)


def _open(spec: ChannelSpec, x):
    """A fresh transport realising ``spec`` for one layer call, mirrored
    into the active capture ledger.  A ``plan`` (``"auto"`` or a netsim
    Plan) selects backend and wire from the tuning table, at one rank's
    bytes of ``x``, unless the spec pins a transport; the choice is recorded
    in the active ledger's ``plans`` under the spec's tag.  An int8 plan
    on a non-floating payload falls back to the raw wire."""
    if spec.plan is not None and spec.transport is None:
        from ..netsim.tune import Plan

        p = spec.plan
        if not isinstance(p, Plan):
            if p != "auto":
                raise ValueError(f"plan must be 'auto', None or a Plan; got {p!r}")
            p = spec.comm.plan(_PLAN_OPS.get(spec.kind, "allreduce"), rank_bytes(x))
        floating = all(v.dtype.is_floating_point for v in (x if isinstance(x, tuple) else (x,)))
        if p.wire != "raw" and not floating:
            p = dataclasses.replace(p, wire="raw")
        spec = spec.replace(transport=p.transport_key)
        if spec.tag is not None:
            ledger.record_plan(spec.tag, p.transport_key)
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
# max over the rank dimension, tallied under the layer tag (the pool's
# bucket for it under a serving pool) as one logical step moving one
# rank's tensor.


def _psum_tag(ctx, tag: str) -> str:
    return ctx.channels.retag(tag) if ctx.channels is not None else tag


def psum_tagged(x, ctx, tag: str):
    if ctx.tp == 1:
        return x
    ledger.tally(_psum_tag(ctx, tag), 1, rank_bytes(x))
    return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x)


def pmax_tagged(x, ctx, tag: str):
    if ctx.tp == 1:
        return x
    ledger.tally(_psum_tag(ctx, tag), 1, rank_bytes(x))
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


# -------------------------------------------------------------------- MoE


def moe_dispatch(x2d, ctx, *, tag: str = "ep.dispatch", **kw):
    """Expert dispatch: gather the sequence-sharded token stream to the
    full token view every expert group routes over (the EP all-gather)."""
    return gather_sequence(x2d, ctx, tag=tag, **kw)


def moe_combine(y_partial, ctx, *, tag: str = "ep.combine", **kw):
    """Expert combine: merge the per-expert-group partials AND return them
    to sequence shards in one reduce-scatter (the EP combine collective)."""
    return reduce_scatter_sequence(y_partial, ctx, tag=tag, **kw)


# -------------------------------------------------------------- attention


def ring_attention(q, k, v, ctx, *, tag: str = "tp.attn.ring", spec=None, plan=None,
                   transport=None, **kw):
    """Sequence-parallel ring attention: the (small, GQA) K/V blocks stream
    around a tagged ``"exchange"`` channel ring while every rank computes
    its sequence shard's attention (``core/overlap.py``)."""
    if ctx.tp == 1 or not ctx.is_smi:
        raise ValueError("ring attention streams over a model ring: tp > 1 and an smi mode")
    spec, t = _channel(ctx, (k, v), tag, "exchange", spec, plan, transport, "raw")
    with _tagged(t, spec.stats_tag):
        return stream_ring_attention(q, k, v, spec.comm, transport=t, **kw)


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


def vocab_parallel_cross_entropy(logits_local, labels, ctx, *, tag: str = "tp.loss.ce"):
    """Cross entropy with vocabulary-sharded logits, every position's
    ``log sum exp - picked``: the max, the sum of exps and the label's logit
    each cross the model axis once, as tagged reductions (the Megatron
    scheme).  At tp = 1 ``logits_local`` is ``(B, S, V)`` and the result
    ``(B, S)``; at tp = P > 1 it is the rank-stacked ``(P, B, S, V/P)``,
    ``labels`` the replicated ``(B, S)`` ids, and every rank's copy of the
    result ``(P, B, S)`` (the ranks' copies are equal).  The max is
    gradient-neutral and detached (the reference's ``stop_gradient``);
    labels outside the vocabulary pick nothing."""
    V_local = logits_local.shape[-1]
    lf = logits_local.float()
    m = pmax_tagged(lf.amax(dim=-1).detach(), ctx, tag)
    z = psum_tagged(torch.exp(lf - m[..., None]).sum(dim=-1), ctx, tag)
    r = ctx.rank(labels.dim() + 1) if ctx.tp > 1 else 0
    local = labels - r * V_local
    ok = (local >= 0) & (local < V_local)
    if ctx.tp > 1:
        local = local.expand(lf.shape[:-1])
    picked = torch.gather(lf, -1, local.clamp(0, V_local - 1).long()[..., None])[..., 0]
    picked = psum_tagged(torch.where(ok, picked, torch.zeros((), device=lf.device)), ctx, tag)
    return torch.log(z) + m - picked


# ------------------------------------------------------ gradient sync (DP)


def grad_allreduce(g, comm, *, tag: str = "grad", transport=None, wire: str = "raw"):
    """One tensor's data-parallel ring all-reduce over a tagged ``"grad"``
    channel: ``g`` is the ``(dp, ...)`` stack of the data ranks' tensors,
    and every row of the result holds its rank's sum.  ``wire="int8"``
    composes the compressed link (blockwise scales, per-hop error
    feedback).  The transport resolves fresh a call, so the int8 wire's
    residuals do not bleed between tensors, unless a live instance is
    passed."""
    spec = ChannelSpec(comm=comm, kind="allreduce", tag=tag, wire=wire, transport=transport,
                       port=None)
    t = _open(spec, g)
    with _tagged(t, spec.stats_tag):
        return _stream_allreduce_impl(g, comm, transport=t)


def fsdp_allgather(p, comm, dim: int, *, tag: str = "fsdp.gather", transport=None,
                   lanes: int = 1):
    """One FSDP leaf all-gathered along ``dim`` over a tagged channel:
    ``p`` is the ``(dp, ...)`` stack of the data ranks' blocks, ``dim`` a
    block's dimension; returns every rank's full copy, ``(dp, ...)``.  A
    block stacked over ``lanes`` model ranks (its leading dim) is that many
    devices' shares, and a step tallies one's.  Autograd transposes the
    ring into the reduce-scatter of the gradient."""
    spec = ChannelSpec(comm=comm, kind="gather", tag=tag, transport=transport, port=None)
    t = _open(spec, p)
    x = t
    while x is not None:
        x.lanes = lanes
        x = getattr(x, "inner", None)
    with _tagged(t, spec.stats_tag):
        g = stream_allgather(p.movedim(dim + 1, 1), comm, transport=t)
        return g.movedim(1, dim + 1)


# ------------------------------------------------------------ pipeline hop


def stage_transport(comm, *, tag: str = "pp.stage", transport=None):
    """The chain channel's transport of a pipeline schedule, resolved once
    for the schedule (the paper's open-once channel) and driven once a
    tick.  A runtime-stats backend (the packet router) or a lossy wire
    falls back to the static wire, which moves the same values: a stage hop
    must deliver its activations exactly.  Returns ``(spec, transport)``,
    the transport mirrored into an active ledger capture."""
    spec = ChannelSpec(comm=comm, kind="exchange", tag=tag, transport=transport, port=None)
    t = spec.resolve()
    if getattr(t, "runtime_stats", False) or getattr(t, "lossy_wire", False):
        from ..transport.registry import get_transport

        t = get_transport("static", device=comm.device)
    return spec, ledger.attach(t)
