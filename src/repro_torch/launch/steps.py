"""Step builders (``repro.launch.steps``): the prefill step, the wave
engine's decode step and the continuous engine's tensor-parallel runtime,
for a model config and a ``(data, model)`` mesh.

The model axis's P ranks are stacked on one card (``mesh/api.py``).  The
data axis's groups run beside that stack, one after another
(``mesh.api.over_data_groups``): the batch is split over them where it
divides (prefill, ``build_serve``), and the serving slots are replicated
over them (``build_continuous_serve``: slot scheduling is a global
decision, so every group computes the same step, which the stack runs
once).  FSDP stays off: it raises where it would shard anything (a
builder's ``fsdp=False`` replicates the weights over the data axis).  Every
block kind is served: dense, MoE, Mamba2 and the RG-LRU hybrid, with the
codebook token streams of an audio model and the patch embeddings of a
vision model's prefill.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs import ModelConfig, ShapeConfig
from ..core.comm import resolve_device
from ..mesh.api import check_fsdp, make_ctx, over_data_groups
from ..models import gather_hidden, lm_prefill
from ..serving.engine import local_step


def _layer_plan(cfg: ModelConfig, comm_mode: str):
    """The layer plan a launch selects: the config's ``comm_plan`` (default
    ``"auto"``) when the comm_mode does not pin a transport backend; an
    explicit ``smi:<backend>`` (or bulk/none) keeps the layers on the pinned
    backend (plan None)."""
    return cfg.comm_plan if comm_mode == "smi" else None


def _rows(caches, rows: slice, tp: int):
    """The cache rows ``rows`` of every leaf, as views (written in place)."""
    from ..serving.continuous import cache_batch_dim

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(walk(v, path + (i,)) for i, v in enumerate(t))
        if t is None:
            return None
        return t.narrow(cache_batch_dim(path, tp), rows.start, rows.stop - rows.start)

    return walk(caches, ())


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None, comm_mode: str = "smi",
                  shared_gather: bool = False, ring_attn: bool = False, fsdp="auto",
                  device=None):
    """The prefill step of ``cfg`` for ``shape`` on ``device`` (``cuda``
    unless named): a callable ``prefill(params, tokens, pixel_embeds=None, *,
    use_kernel=None)`` that runs :func:`~repro_torch.models.lm_prefill` on
    tokens (B, S) (or (B, S, n_cb) for a codebook model), a vision model's
    patch embeddings (B, n_patches, D) in the first positions, and returns
    the final hidden states (B, S, D).  On the card its attention is
    kernel E and its SSD scan kernel F; ``use_kernel=False`` runs their
    plain versions there, for comparisons.

    ``mesh=(dp, P)`` runs it tensor-parallel over P stacked ranks, the
    layers' collectives over ``comm_mode``: a bare ``"smi"`` (the default)
    takes the config's ``comm_plan`` (``"auto"``: the netsim tuning table
    picks each layer's backend and wire), a pinned ``"smi:static"``,
    ``"smi:fused"`` or ``"bulk"`` keeps every layer there; ``params`` are then
    :func:`~repro_torch.interop.shard_params`'s for ``prefill.ctx``.  The
    batch (the tokens' and the patch embeddings' rows) is split over the
    ``dp`` data groups where it divides.
    ``ring_attn`` streams the K/V blocks around the model ring instead of
    gathering the sequence (``models/attention.py apply_attention_ring``).
    The products are ``torch.matmul``, as the reference's are unless a
    caller injects a kernel through ``make_ctx(..., matmul_fn=...)``.
    """
    dev = resolve_device(device)
    ctx = make_ctx(mesh, comm_mode=comm_mode, opt_shared_gather=shared_gather,
                   opt_ring_attn=ring_attn, plan=_layer_plan(cfg, comm_mode), device=dev)
    check_fsdp(fsdp, mesh, cfg.param_count())

    want_dim = 3 if cfg.n_codebooks > 1 else 2

    def prefill(params, tokens: torch.Tensor, pixel_embeds=None, *,
                use_kernel=None) -> torch.Tensor:
        if tokens.dim() != want_dim:
            raise ValueError(f"{cfg.name} takes tokens of {want_dim} dims, got "
                             f"{tuple(tokens.shape)}")
        tokens = tokens.to(dev)
        extra = None if pixel_embeds is None else pixel_embeds.to(dev)

        def group(rows):
            h = lm_prefill(params, tokens[rows], cfg, ctx, capacity=shape.seq_len,
                           extra_embeds=None if extra is None else extra[rows],
                           use_kernel=use_kernel)
            return gather_hidden(h) if ctx.tp > 1 else h

        return torch.cat(over_data_groups(ctx, tokens.shape[0], group))

    prefill.device = dev
    prefill.ctx = ctx
    return prefill


def build_serve(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None, comm_mode: str = "smi",
                fsdp="auto", device=None) -> dict:
    """The wave engine's decode step: one token for the whole batch
    (``shape.global_batch`` rows) against a full KV cache of
    ``shape.seq_len`` positions, on ``device`` (``cuda`` unless named).

    Returns ``dict(step, ctx, batch, capacity)``:
    ``step(params, caches, token, pos) -> (float32 logits (B, V), caches)``
    (token (B, n_cb) and logits (B, V, n_cb) for a codebook model)
    runs :func:`~repro_torch.models.lm_decode_step` with
    ``gather_logits=False`` and assembles the vocabulary shards without a
    wire (the reference's ``out_specs``), the batch split over the data
    groups where it divides (their caches the rows of one cache tree).
    Pass it to :class:`~repro_torch.serving.ServeEngine` as ``runtime=``.
    """
    dev = resolve_device(device)
    ctx = make_ctx(mesh, comm_mode=comm_mode, plan=_layer_plan(cfg, comm_mode), device=dev)
    check_fsdp(fsdp, mesh, cfg.param_count())
    B, capacity = shape.global_batch, shape.seq_len

    decode = local_step(cfg, ctx)

    def step(params, caches, token, pos):
        token = token.to(dev)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)

        def group(rows):
            logits, _ = decode(params, _rows(caches, rows, ctx.tp), token[rows],
                               pos if pos.dim() == 0 else pos[rows])
            return logits

        return torch.cat(over_data_groups(ctx, token.shape[0], group)), caches

    return dict(step=step, ctx=ctx, batch=B, capacity=capacity)


def build_continuous_serve(cfg: ModelConfig, *, mesh=None, comm_mode: str = "smi",
                           batch_slots: int = 4, capacity: int = 128, fsdp="auto",
                           device=None) -> dict:
    """The tensor-parallel runtime of the continuous-batching engine
    (:class:`~repro_torch.serving.ContinuousEngine` ``runtime=``), on
    ``device`` (``cuda`` unless named).

    Returns ``dict(ctx, pool, step, reset, migrate_start, migrate_finish,
    init_caches, batch_slots, capacity)``: the per-slot decode step (``pos``
    a (B,) vector; the vocabulary shards assembled without a wire), the
    slot invalidation, the two migration legs on the pool's
    ``serve.migrate`` gather/scatter channels, and the
    :class:`~repro_torch.channels.ChannelPool` whose persistent port claims
    outlive every step (released only by ``pool.close()`` or the engine's
    shutdown).  Every layer channel of the step resolves to ONE persistent
    pool spec a tag, reused by every decode step.  Without an smi mode or
    at tp = 1 there is no pool, and migration holds the image locally.

    Slots are batch rows replicated over the data axes; the KV cache is
    sequence-sharded over the model axis, which is what migration streams
    across ranks.
    """
    from ..channels import ChannelPool
    from ..serving.continuous import (
        local_runtime,
        migrate_gather,
        migrate_scatter,
        open_migration,
    )

    dev = resolve_device(device)
    ctx = make_ctx(mesh, batch_axes=(), comm_mode=comm_mode,
                   plan=_layer_plan(cfg, comm_mode), device=dev)
    check_fsdp(fsdp, mesh, cfg.param_count())
    pool = None
    if ctx.is_smi and ctx.tp > 1:
        pool = ChannelPool(ctx.model_comm, prefix="serve.")
        ctx = dataclasses.replace(ctx, channels=pool)
    rt = local_runtime(cfg, ctx, batch_slots, capacity, dev)
    if pool is not None:
        gspec, sspec = open_migration(pool)
        rt.update(
            pool=pool,
            migrate_start=lambda caches, slot: migrate_gather(caches, slot, gspec, ctx.tp),
            migrate_finish=lambda caches, inflight, slot: migrate_scatter(caches, inflight, slot,
                                                                           sspec, ctx.tp))
    return rt
