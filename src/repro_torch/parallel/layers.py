"""The parallel layers the model calls (``repro.parallel.layers``), their
``tp == 1`` branches.

At tensor-parallel degree 1 every collective is the identity and every
projection is one matrix product.  The reference computes that product as
``jnp.dot(a, b, preferred_element_type=float32).astype(a.dtype)`` outside
any Pallas kernel (``ParallelCtx.matmul_fn`` is never set by an entry
point), so here it is ``torch.matmul``, which accumulates in float32 for
bfloat16 and float32 inputs alike, cast back to the input dtype.  A
context of more than one rank cannot be made yet (``mesh.api.make_ctx``).
"""

from __future__ import annotations

import torch


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b).to(a.dtype)


def psum_tagged(x, ctx, tag: str):
    return x


def pmax_tagged(x, ctx, tag: str):
    return x


def column_parallel_linear(x2d, w, ctx, *, tag: str = "tp.col"):
    return _matmul(x2d, w)


def row_parallel_linear(x2d, w, ctx, *, tag: str = "tp.row"):
    return _matmul(x2d, w)


def gather_sequence(x, ctx, axis: int = 0, *, tag: str = "tp.gather"):
    return x


def all_reduce(x, ctx, *, tag: str = "tp.allreduce"):
    return x


def parallel_embedding(table_local, ids, ctx, *, tag: str = "tp.embed"):
    """Vocab-parallel embedding lookup; one shard at tp = 1."""
    return psum_tagged(parallel_embedding_partial(table_local, ids, ctx), ctx, tag)


def parallel_embedding_partial(table_local, ids, ctx):
    """This vocab shard's embedding rows of ``ids``; ids outside the shard
    give zero rows, as in the reference."""
    V_local = table_local.shape[0]
    local = ids - ctx.rank() * V_local
    ok = (local >= 0) & (local < V_local)
    emb = table_local[local.clamp(0, V_local - 1)]
    return torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
