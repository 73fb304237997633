"""LM wrapper (``repro.models.model``): embedding -> block stack -> final
norm; prefill and one decode step at any tensor-parallel degree.

At tp = P > 1 the residual stream is sequence-sharded and rank-stacked,
``(P, B, S/P, D)``: the vocab-parallel embedding fuses its sum over the
vocabulary shards into the reduce-scatter onto sequence shards, and
:func:`lm_prefill` returns the sharded hidden states, which
:func:`gather_hidden` assembles into ``(B, S, D)``.  A decode step's rows
are replicated, ``(P, B, 1, D)``, and its KV caches sequence-sharded
(``models/attention.py``); its logits are each rank's vocabulary shard,
gathered over the ``tp.loss.gather`` channel unless the caller assembles
them (``gather_logits=False``).

The vocabulary stays padded to a multiple of 256 (``cfg.padded_vocab``):
greedy decoding takes the argmax over every padded column, as the reference
does.

:func:`lm_loss` is the training loss: the causal-LM cross entropy over
vocabulary-sharded logits, in chunks of the sequence, plus the MoE
load-balancing loss.

The modality frontends are the reference's stubs.  An audio model's
``n_codebooks`` token streams (tokens ``(B, S, n_cb)``, a decode step's
``(B, n_cb)``) each have an embedding and a head (``embed_cb`` (n_cb, V, D),
``head_cb`` (n_cb, D, V)); their partial embeddings are summed before the
vocabulary reduction, and a decode step's logits are ``(B, V, n_cb)``.  A
vision model's precomputed patch embeddings (``extra_embeds``, (B,
n_patches, D)) take the first positions of the sequence: those positions'
vocabulary partials are zeroed and the patches added on rank 0's partial
only, so the reduction over ranks carries them exactly.
"""

from __future__ import annotations

import torch

from ..core.comm import resolve_device
from ..mesh.api import make_ctx
from ..mesh.api import PartitionSpec as PS
from ..parallel import (
    gather_sequence,
    parallel_embedding_partial,
    psum_tagged,
    reduce_scatter_sequence,
    vocab_parallel_cross_entropy,
)
from .common import rms_norm, tree_map, trunc_normal
from .transformer import (
    apply_stack,
    decode_stack,
    init_stack,
    init_stack_cache,
    recomputed,
    stack_cache_specs,
    stack_specs,
)

def model_dtype(cfg) -> torch.dtype:
    """The dtype the model computes in: bfloat16 or float32, from the config."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_lm(cfg, generator: torch.Generator | None = None, device=None, dtype=None, ctx=None):
    """Global-shape LM params on ``device`` (``cuda`` unless named; drawn
    from ``generator``, seeded 0 on that device when none is given), float32
    as in the reference unless ``dtype`` names another: the full-width run
    passes the model dtype, and each layer is drawn in float32 and cast.
    ``ctx`` (tp = 1 unless given) pads the attention heads to a multiple of
    its tp; :func:`~repro_torch.interop.shard_params` splits the result.  A
    codebook model has ``embed_cb`` and ``head_cb`` in place of ``embed``
    and ``head``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params asked on {dev}")
    D, V = cfg.d_model, cfg.padded_vocab
    dt = torch.float32 if dtype is None else dtype
    ctx = ctx or make_ctx()
    if V % ctx.tp:
        raise ValueError(f"padded vocabulary {V} not divisible by tp={ctx.tp}")
    cb, lead = ("_cb", (cfg.n_codebooks,)) if cfg.n_codebooks > 1 else ("", ())
    p = {"final_norm": torch.ones((D,), dtype=dt, device=dev),
         "embed" + cb: trunc_normal(generator, (*lead, V, D), 0.02, dt),
         "stack": init_stack(generator, cfg, ctx, dtype)}
    if cb or not cfg.tie_embeddings:
        p["head" + cb] = trunc_normal(generator, (*lead, D, V), D ** -0.5, dt)
    return p


class _ShapesOnly:
    """A stand-in generator for :func:`param_shapes`: its leaves lie on the
    ``meta`` device, shapes and dtypes without storage."""

    device = torch.device("meta")


def param_shapes(cfg, ctx=None, dtype=None):
    """:func:`init_lm`'s global leaves on the ``meta`` device (shapes and
    dtypes, no storage; the reference's ``jax.eval_shape(init_lm)``), for
    :func:`~repro_torch.mesh.api.build_fsdp_plan` and the dry run."""
    return init_lm(cfg, _ShapesOnly(), device="meta", dtype=dtype, ctx=ctx)


_FSDP_TOP = ("embed", "head", "embed_cb", "head_cb", "final_norm")


def _gather_top(pf, cfg, ctx, fsdp_plan):
    """The embedding, heads and final norm with their FSDP leaves gathered
    for ``ctx``'s data group (the block stack gathers its own, layer by
    layer)."""
    if fsdp_plan is None:
        return pf
    from ..mesh.api import fsdp_gather

    specs = lm_specs(cfg, ctx)
    keys = [k for k in _FSDP_TOP if k in pf]
    got = fsdp_gather({k: pf[k] for k in keys}, {k: fsdp_plan[k] for k in keys}, ctx,
                      {k: specs[k] for k in keys})
    return {**pf, **got}


def lm_specs(cfg, ctx):
    """How each leaf of the LM params lies over the mesh: the embedding
    split by vocabulary rows, the head by vocabulary columns, the final norm
    replicated."""
    m = ctx.model_axis
    sp = {"final_norm": PS(None), "stack": stack_specs(cfg, ctx)}
    if cfg.n_codebooks > 1:
        sp.update(embed_cb=PS(None, m, None), head_cb=PS(None, None, m))
        return sp
    sp["embed"] = PS(m, None)
    if not cfg.tie_embeddings:
        sp["head"] = PS(None, m)
    return sp


def _cast(p, dtype):
    """float32 leaves to ``dtype``; other leaves as they are (no copy when
    a leaf already has its type)."""
    return tree_map(lambda v: v.to(dtype) if v.dtype == torch.float32 else v, p)


def _codebook(t, cb: int, ctx):
    """Codebook ``cb``'s table of a ``(n_cb, ...)`` leaf (rank-stacked
    ``(P, n_cb, ...)`` at tp > 1)."""
    return t[:, cb] if ctx.tp > 1 else t[cb]


def _embed_partial(params, tokens, cfg, ctx):
    """Every rank's vocabulary partial of the tokens' embedding; a codebook
    model's streams (the tokens' last dim) summed, codebook by codebook."""
    if cfg.n_codebooks > 1:
        return sum(parallel_embedding_partial(_codebook(params["embed_cb"], cb, ctx),
                                              tokens[..., cb], ctx)
                   for cb in range(cfg.n_codebooks))
    return parallel_embedding_partial(params["embed"], tokens, ctx)


def embed_tokens_sp(params, tokens, cfg, ctx, extra_embeds=None):
    """tokens (B, S) (or (B, S, n_cb)) -> (B, S, D) in the model dtype; at
    tp = P > 1 the sequence shards (P, B, S/P, D).  ``extra_embeds`` (B,
    n_patches, D) take the first positions in place of the tokens'
    embeddings."""
    emb = _embed_partial(params, tokens, cfg, ctx)
    if extra_embeds is not None:
        # patch positions: the vocabulary partial zeroed, the patch added on
        # rank 0's partial only, so the sum over ranks is the patch itself
        S, npch = emb.shape[-2], extra_embeds.shape[1]
        patch = (torch.arange(S, device=emb.device) < npch)[:, None]
        emb = torch.where(patch, torch.zeros((), dtype=emb.dtype, device=emb.device), emb)
        full = torch.nn.functional.pad(extra_embeds.to(emb.device), (0, 0, 0, S - npch))
        emb = emb + torch.where(patch & (torch.as_tensor(ctx.rank(4)) == 0), full,
                                torch.zeros((), dtype=full.dtype, device=emb.device))
    if ctx.tp > 1:
        # the vocab psum fused into the sequence scatter: each rank's partial
        # laid out shard-major, (P_dst, B, S_loc) on the rows
        P, B, S, D = emb.shape
        blocks = emb.reshape(P, B, P, S // P, D).transpose(1, 2).reshape(P, S * B, D)
        emb = reduce_scatter_sequence(blocks, ctx, tag="tp.embed").reshape(P, B, S // P, D)
    return emb.to(model_dtype(cfg))


def lm_prefill(params, tokens, cfg, ctx, *, capacity: int, extra_embeds=None, use_kernel=None,
               fsdp_plan=None):
    """Prefill: the full forward over ``tokens`` (B, S) (or (B, S, n_cb)),
    the first positions taken by ``extra_embeds`` (B, n_patches, D) when
    given; returns the final hidden states, (B, S, D) at tp = 1 and the
    sequence shards (P, B, S/P, D) at tp = P > 1 (:func:`gather_hidden`
    assembles them).  ``params`` are the global ones at tp = 1 and
    :func:`~repro_torch.interop.shard_params`'s at tp > 1.  Like the
    reference, it fills no cache (the serving engines replay prompts through
    decode).  ``use_kernel`` goes to every attention and SSM block
    (``None``: kernels E and F on the card; ``False``: their plain versions,
    for comparisons).  ``fsdp_plan`` gathers the FSDP-stored leaves over
    the data ring for ``ctx.data_group``, each layer's as it runs."""
    pf = _gather_top(_cast(params, model_dtype(cfg)), cfg, ctx, fsdp_plan)
    x = embed_tokens_sp(pf, tokens, cfg, ctx, extra_embeds)
    x, _ = apply_stack(pf["stack"], x, cfg, ctx, use_kernel=use_kernel, remat="none",
                       fsdp_plan=None if fsdp_plan is None else fsdp_plan["stack"])
    return rms_norm(x, pf["final_norm"], cfg.norm_eps)


def gather_hidden(h: torch.Tensor) -> torch.Tensor:
    """Rank-stacked sequence shards (P, B, S/P, D) -> (B, S, D), rank r's
    shard at positions r*S/P.. (the reference's ``out_specs=P(batch,
    "model", None)``)."""
    P, B, S_loc, D = h.shape
    return h.transpose(0, 1).reshape(B, P * S_loc, D)


def _head_tables(pf, cfg, ctx):
    """The output projection(s) ``(.., D, V_loc)``: each codebook's head,
    the tied embedding transposed, or the head."""
    if cfg.n_codebooks > 1:
        return [_codebook(pf["head_cb"], cb, ctx) for cb in range(cfg.n_codebooks)]
    if cfg.tie_embeddings:
        return [pf["embed"].transpose(-1, -2)]
    return [pf["head"]]


def lm_loss(params, tokens, labels, cfg, ctx, *, extra_embeds=None, remat: str = "dots",
            loss_chunks: int = 1, aux_weight: float = 1e-2, use_kernel=None, fsdp_plan=None):
    """The causal-LM loss: the mean cross entropy over the labels that are
    not ``-100``, plus ``aux_weight`` times the MoE load-balancing loss.
    Returns ``(loss, (ce, aux))``, 0-dim float32 tensors.

    ``tokens`` and ``labels`` are ``(B, S)`` (``(B, S, n_cb)`` for a
    codebook model, each codebook's cross entropy summed into one mean);
    ``extra_embeds`` (B, n_patches, D) take the first positions.  ``params``
    are the global ones at tp = 1 and
    :func:`~repro_torch.interop.shard_params`'s at tp = P > 1.  The final
    hidden states are taken in ``loss_chunks`` chunks of each rank's
    sequence shard: at tp > 1 each chunk is gathered over the
    ``tp.loss.gather`` channel, and the vocabulary-parallel cross entropy
    reduces over ``tp.loss.ce``; with more than one chunk each chunk's
    logits are recomputed in the backward pass (the reference's
    ``jax.checkpoint``).  ``remat`` is :func:`~.transformer.apply_stack`'s.

    At tp > 1 every rank of the stack computes the same loss; this returns
    rank 0's, so that its gradient is the loss's own (the sum over the
    stack would be P times it).  ``use_kernel`` goes to every attention and
    SSM block (kernels E and F on the card).  ``fsdp_plan`` gathers the
    FSDP-stored leaves over the data ring for ``ctx.data_group`` (the
    reference's ZeRO-3 streaming: the stack's layer by layer), and the
    gather's backward sums the group's gradients into the owners'
    blocks."""
    tp = ctx.tp
    pf = _gather_top(_cast(params, model_dtype(cfg)), cfg, ctx, fsdp_plan)
    x = embed_tokens_sp(pf, tokens, cfg, ctx, extra_embeds)
    x, aux = apply_stack(pf["stack"], x, cfg, ctx, use_kernel=use_kernel, remat=remat,
                         fsdp_plan=None if fsdp_plan is None else fsdp_plan["stack"])
    x = rms_norm(x, pf["final_norm"], cfg.norm_eps)     # (B, S_loc, D) or (P, B, S_loc, D)
    tables = _head_tables(pf, cfg, ctx)
    B, S_loc, D = x.shape[-3:]
    if S_loc % loss_chunks:
        raise ValueError(f"{loss_chunks} loss chunks do not split {S_loc} positions a rank")
    csz = S_loc // loss_chunks
    lead = labels.shape[2:]

    def chunk_ce(xc, labc):
        """xc: a chunk of every rank's shard; labc: (B, tp*csz[, n_cb]) in
        the gathered chunk's order.  Returns (sum of CE, count of labels),
        every rank's at tp > 1."""
        if tp > 1:
            xg = gather_sequence(xc.reshape(tp, B * csz, D), ctx, tag="tp.loss.gather")
            xc = xg.reshape(tp, tp, B, csz, D).transpose(1, 2).reshape(tp, B, tp * csz, D)
        total = count = 0.0
        for cb, table in enumerate(tables):
            logits = (xc @ (table.unsqueeze(1) if tp > 1 else table)).float()
            lab = labc[..., cb] if cfg.n_codebooks > 1 else labc
            valid = lab >= 0
            ce = vocab_parallel_cross_entropy(logits, lab.clamp_min(0), ctx)
            total = total + torch.where(valid, ce, 0.0).sum(dim=(-2, -1))
            count = count + valid.float().sum()
        return total, count

    total = count = 0.0
    for ci in range(loss_chunks):
        xc = x[..., ci * csz:(ci + 1) * csz, :]
        if tp > 1:
            # the gathered chunk's labels: (B, tp, csz) -> (B, tp*csz), rank-major
            lb = labels.reshape((B, tp, S_loc) + lead)[:, :, ci * csz:(ci + 1) * csz]
            lb = lb.reshape((B, tp * csz) + lead)
        else:
            lb = labels[:, ci * csz:(ci + 1) * csz]
        t, c = recomputed(chunk_ce, xc, lb) if loss_chunks > 1 else chunk_ce(xc, lb)
        total = total + t
        count = count + c
    if tp > 1:
        total = total[0]
    ce = total / count.clamp(min=1.0)
    return ce + aux_weight * aux, (ce, aux)


def lm_decode_step(params, caches, token, pos, cfg, ctx, *, gather_logits: bool = True,
                   fsdp_plan=None):
    """One decode step.  token (B,) int (or (B, n_cb)); pos a scalar or a
    (B,) vector.  Returns (float32 logits, caches) with the caches updated
    in place: the logits are (B, padded_vocab) at tp = 1; at tp = P > 1
    every rank's gathered copy, (P, B, padded_vocab), or with
    ``gather_logits=False`` every rank's own vocabulary shard, (P, B,
    padded_vocab / P), for the caller to assemble (the reference's
    ``out_specs``).  A codebook model's logits gain a trailing ``n_cb``
    dimension, and its gather carries ``n_cb`` times the bytes.
    ``fsdp_plan`` gathers the FSDP-stored leaves over the data ring for
    ``ctx.data_group``, each layer's before it runs."""
    pf = _gather_top(_cast(params, model_dtype(cfg)), cfg, ctx, fsdp_plan)
    emb = _embed_partial(pf, token, cfg, ctx)
    x = psum_tagged(emb, ctx, "tp.embed").unsqueeze(-2).to(model_dtype(cfg))  # (.., B, 1, D)
    # on the device once, not once a layer (a copy from the host waits for the card)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    x, caches = decode_stack(pf["stack"], caches, x, pos, cfg, ctx,
                             fsdp_plan=None if fsdp_plan is None else fsdp_plan["stack"])
    x = rms_norm(x, pf["final_norm"], cfg.norm_eps).squeeze(-2)        # (.., B, D)
    tables = _head_tables(pf, cfg, ctx)
    if cfg.n_codebooks > 1:
        logits = torch.stack([x @ t for t in tables], dim=-1)          # (.., B, V_loc, n_cb)
    else:
        logits = x @ tables[0]
    if ctx.tp > 1 and gather_logits:
        # the vocabulary shards, gathered: (P, V_loc, B[, n_cb]) -> (P, V, B[, n_cb])
        logits = gather_sequence(logits.movedim(2, 1), ctx, tag="tp.loss.gather").movedim(1, 2)
    return logits.float(), caches


def assemble_logits(logits: torch.Tensor) -> torch.Tensor:
    """Every rank's vocabulary shard (P, B, V/P[, n_cb]) -> (B, V[, n_cb]),
    rank r's columns at r*V/P (the reference's ``out_specs=P(None,
    "model")``: no wire)."""
    return logits.transpose(0, 1).flatten(1, 2)


def lm_caches(cfg, B: int, capacity: int, ctx, device=None):
    """Empty decode caches for ``B`` slots of ``capacity`` positions, in the
    model dtype, on ``device`` (``cuda`` unless named); at tp = P > 1 each
    rank holds ``capacity / P`` of every attention layer's slots."""
    return init_stack_cache(cfg, B, capacity, ctx, model_dtype(cfg), resolve_device(device))


def lm_cache_specs(cfg, ctx, shard_batch: bool = True):
    """How each leaf of the decode caches lies over the mesh."""
    return stack_cache_specs(cfg, ctx, shard_batch)
