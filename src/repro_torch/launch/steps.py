"""Step builders (``repro.launch.steps``): the training step, the prefill
step, the wave engine's decode step and the continuous engine's
tensor-parallel runtime, for a model config and a ``(model,)``, ``(data,
model)`` or ``(pod, data, model)`` mesh.

The model axis's P ranks are stacked on one card (``mesh/api.py``).  The
data groups of the batch axes (``pod`` times ``data`` of them) run beside
that stack, one after another (``mesh.api.run_groups``, each training
group's forward and backward before the next's): the batch is split over
them where it
divides (training, prefill, ``build_serve``), and the serving slots are
replicated over them (``build_continuous_serve``: slot scheduling is a
global decision, so every group computes the same step, which the stack
runs once).  Under FSDP (``fsdp=True``, or ``"auto"`` where one model
shard's bfloat16 weights pass 10 GB) the weights are stored as their data
blocks (``interop.shard_params(..., fsdp_plan=)``, the builder's
``plan``) and each layer's are gathered over the data ring as it runs, in
training, prefill and both engines.  Training syncs the gradients over the
data axis: an FSDP leaf's through the gather's transposed ring, a leaf
stored whole through a ``"grad"`` ring (the int8 wire with
``compressed_grads``); without FSDP, in one bulk mean.  Every block kind
is served and trained: dense, MoE, Mamba2 and the RG-LRU hybrid, with the
codebook token streams of an audio model and the patch embeddings of a
vision model.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..configs import ModelConfig, ShapeConfig
from ..core.comm import resolve_device
from ..data import input_specs
from ..interop import shard_params
from ..mesh.api import (
    build_fsdp_plan,
    check_fsdp,
    grad_sync_fsdp,
    make_ctx,
    over_data_groups,
    run_groups,
)
from ..models import gather_hidden, init_lm, lm_loss, lm_prefill, lm_specs, param_shapes
from ..models.common import tree_flatten, tree_unflatten
from ..models.transformer import check_remat
from ..optim import adamw_init, adamw_update, clip_by_global_norm, cosine_warmup
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


@dataclasses.dataclass
class TrainSettings:
    """A training launch's settings (the reference's fields).  ``comm_mode``
    is ``"smi"``, ``"smi:<backend>"`` or ``"bulk"``; ``remat`` one of
    ``models.transformer.REMAT_POLICIES``; ``fsdp`` and
    ``compressed_grads`` act over a data axis of more than one rank."""

    comm_mode: str = "smi"
    remat: str = "nothing"
    loss_chunks: int = 8
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    fsdp: bool = True
    compressed_grads: bool = False
    shared_gather: bool = False
    ring_attn: bool = False


def _fsdp_plan(cfg, ctx, fsdp, mesh):
    """The FSDP plan of a builder (None when FSDP is off): ``fsdp``
    resolved by :func:`~repro_torch.mesh.api.check_fsdp`."""
    if not check_fsdp(fsdp, mesh, cfg.param_count()):
        return None
    return build_fsdp_plan(param_shapes(cfg, ctx), lm_specs(cfg, ctx), mesh, ctx.batch_axes)


def _group_ctxs(ctx):
    """``ctx`` for each data group (its ``data_group`` set)."""
    return [dataclasses.replace(ctx, data_group=g) for g in range(ctx.dp)]


def build_train(cfg: ModelConfig, shape: ShapeConfig, st: TrainSettings, *, mesh=None,
                matmul_fn=None, device=None) -> dict:
    """The training step of ``cfg`` for ``shape`` on ``device`` (``cuda``
    unless named), over ``mesh=(1, P)`` (tp = 1 without one).

    Returns ``dict(step, grads, init_state, init_params, input_specs, ctx,
    plan, cfg, settings, device)``:

    * ``init_params(seed=0)``: the float32 params drawn from a generator
      seeded ``seed`` on the device (rank-stacked at tp > 1 and
      FSDP-stored by ``plan``, :func:`~repro_torch.interop.shard_params`),
      requiring gradients;
      ``init_state(seed=0)``: ``{"params", "opt": {"m", "v", "step"}}``
      with float32 AdamW moments and an int32 step;
    * ``grads(params, batch, use_kernel=None)``: ``(loss, ce, gradients)``
      of one batch, nothing updated (the gradients a tree shaped as the
      params, synced over the data axis);
    * ``step(state, batch, use_kernel=None)``: one step on ``batch``
      (``tokens``, ``labels`` and a vision model's ``pixel_embeds``,
      tensors or numpy arrays): the loss (:func:`~repro_torch.models.
      lm_loss`, computed in the model's dtype with ``st.remat`` and
      ``st.loss_chunks``), its gradients, clipped to ``st.clip_norm``, and
      AdamW at the ``cosine_warmup`` rate.  The state is updated in place
      and returned with ``{"loss", "ce", "gnorm", "lr"}`` (0-dim float32
      tensors; ``loss`` includes the MoE load-balancing term).

    The gradients are those of the loss itself: at tp > 1 the loss is rank
    0's copy, a replicated leaf is stored once (its gradient sums every
    rank's share) and a sharded one holds each rank's block, so they equal
    tp = 1's.  On the card attention is kernel E and the SSD scan kernel F,
    forward and backward (``use_kernel=False``: their plain versions);
    ``matmul_fn`` puts a kernel on the tensor-parallel GEMMs
    (``repro_torch.kernels.matmul.matmul``: kernel D, whose backward
    products are kernel D too).

    ``mesh=(dp, P)`` (or ``(pod, data, P)``, ``dp = pod * data``) splits
    the batch over ``dp`` data groups (the whole batch to each when it does
    not split), which run one after another beside the model-axis stack,
    each its forward and backward, the ledger paused after the first.  Each
    group's gradient of a leaf stored whole is its own (the group computes
    on an alias of the leaf) until the data ring sums it: over a
    ``"grad"`` channel under FSDP (``st.fsdp``, the reference's default;
    ``plan`` from :func:`~repro_torch.mesh.api.build_fsdp_plan`), in one
    untallied mean without.  An FSDP leaf's gradient sums the groups'
    through the gather's transposed ring and is divided by ``dp``.  The
    loss and ``ce`` are the groups' mean."""
    dev = resolve_device(device)
    check_remat(st.remat)
    ctx = make_ctx(mesh, comm_mode=st.comm_mode, matmul_fn=matmul_fn,
                   opt_shared_gather=st.shared_gather, opt_ring_attn=st.ring_attn,
                   plan=_layer_plan(cfg, st.comm_mode), device=dev)
    ispecs = input_specs(cfg, shape)
    plan = _fsdp_plan(cfg, ctx, st.fsdp, mesh)
    dp = ctx.dp
    gctxs = _group_ctxs(ctx)

    def init_params(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = shard_params(init_lm(cfg, gen, device=dev, ctx=ctx), cfg, ctx, plan)
        for p in tree_flatten(params):
            p.requires_grad_(True)
        return params

    def init_state(seed: int = 0) -> dict:
        params = init_params(seed)
        return {"params": params, "opt": adamw_init(params)}

    def loss_of(params, args, rows, gctx, use_kernel):
        extra = args.get("pixel_embeds")
        return lm_loss(params, args["tokens"][rows], args["labels"][rows], cfg, gctx,
                       extra_embeds=None if extra is None else extra[rows], remat=st.remat,
                       loss_chunks=st.loss_chunks, use_kernel=use_kernel, fsdp_plan=plan)

    def grads_dp(params, args, use_kernel):
        """Every data group's loss and gradients, synced over the data axis."""
        leaves = tree_flatten(params)
        dims = tree_flatten(plan) if plan is not None else [-1] * len(leaves)
        whole = [i for i, d in enumerate(dims) if d < 0]
        sharded = [i for i, d in enumerate(dims) if d >= 0]
        n = args["tokens"].shape[0]
        m = n // dp if n % dp == 0 else n          # the whole batch to each group
        # the groups' shares of the FSDP leaves' gradients, summed as they come
        acc = [torch.zeros_like(leaves[i]) for i in sharded]

        def group(g):
            own = list(leaves)
            for i in whole:                        # this group's own gradient
                own[i] = leaves[i].detach().requires_grad_(True)
            rows = slice(g * m, g * m + m) if m < n else slice(0, n)
            loss, (ce, _) = loss_of(tree_unflatten(params, own), args, rows, gctxs[g],
                                    use_kernel)
            got = torch.autograd.grad(loss, [leaves[i] for i in sharded] +
                                      [own[i] for i in whole])
            for a, t in zip(acc, got):
                a.add_(t)
            return loss.detach(), ce.detach(), got[len(sharded):]

        runs = run_groups(dp, group)
        out = [None] * len(leaves)
        for k, i in enumerate(sharded):
            out[i] = acc[k]
        for k, i in enumerate(whole):              # (dp, ...): row g group g's
            out[i] = torch.stack([r[2][k] for r in runs])
        if plan is None:                           # the reference's bulk pmean: untallied
            out = [t.sum(0) / dp for t in out]
        else:
            out = tree_flatten(grad_sync_fsdp(tree_unflatten(params, out), plan, ctx,
                                              compressed=st.compressed_grads,
                                              specs=lm_specs(cfg, ctx)))
            out = [t if d >= 0 else t[0] for t, d in zip(out, dims)]
        loss = functools.reduce(torch.add, (r[0] for r in runs))
        ce = functools.reduce(torch.add, (r[1] for r in runs))
        return loss / dp, ce / dp, tree_unflatten(params, out)

    def grads(params, batch, use_kernel=None):
        args = {k: torch.as_tensor(batch[k]).to(dev) for k in ispecs}
        if dp > 1:
            return grads_dp(params, args, use_kernel)
        loss, (ce, _) = loss_of(params, args, slice(None), ctx, use_kernel)
        g = tree_unflatten(params, torch.autograd.grad(loss, tree_flatten(params)))
        return loss.detach(), ce.detach(), g

    def step(state, batch, use_kernel=None):
        params = state["params"]
        loss, ce, g = grads(params, batch, use_kernel)
        g, gnorm = clip_by_global_norm(g, st.clip_norm)
        lr = cosine_warmup(state["opt"]["step"], base_lr=st.base_lr,
                           warmup_steps=st.warmup_steps, total_steps=st.total_steps)
        adamw_update(params, g, state["opt"], lr=lr)
        return state, {"loss": loss, "ce": ce, "gnorm": gnorm, "lr": lr}

    return dict(step=step, grads=grads, init_state=init_state, init_params=init_params,
                input_specs=ispecs, ctx=ctx, plan=plan, cfg=cfg, settings=st, device=dev)


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
    Under FSDP (``fsdp``, resolved by ``mesh.api.check_fsdp``) ``params``
    are stored by ``prefill.plan`` and each group gathers each layer's.
    """
    dev = resolve_device(device)
    ctx = make_ctx(mesh, comm_mode=comm_mode, opt_shared_gather=shared_gather,
                   opt_ring_attn=ring_attn, plan=_layer_plan(cfg, comm_mode), device=dev)
    plan = _fsdp_plan(cfg, ctx, fsdp, mesh)
    gctxs = _group_ctxs(ctx)

    want_dim = 3 if cfg.n_codebooks > 1 else 2

    def prefill(params, tokens: torch.Tensor, pixel_embeds=None, *,
                use_kernel=None) -> torch.Tensor:
        if tokens.dim() != want_dim:
            raise ValueError(f"{cfg.name} takes tokens of {want_dim} dims, got "
                             f"{tuple(tokens.shape)}")
        tokens = tokens.to(dev)
        extra = None if pixel_embeds is None else pixel_embeds.to(dev)

        def group(g, rows):
            h = lm_prefill(params, tokens[rows], cfg, gctxs[g], capacity=shape.seq_len,
                           extra_embeds=None if extra is None else extra[rows],
                           use_kernel=use_kernel, fsdp_plan=plan)
            return gather_hidden(h) if ctx.tp > 1 else h

        return torch.cat(over_data_groups(ctx, tokens.shape[0], group))

    prefill.device = dev
    prefill.ctx = ctx
    prefill.plan = plan
    return prefill


def build_serve(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None, comm_mode: str = "smi",
                fsdp="auto", device=None) -> dict:
    """The wave engine's decode step: one token for the whole batch
    (``shape.global_batch`` rows) against a full KV cache of
    ``shape.seq_len`` positions, on ``device`` (``cuda`` unless named).

    Returns ``dict(step, ctx, plan, batch, capacity)``:
    ``step(params, caches, token, pos) -> (float32 logits (B, V), caches)``
    (token (B, n_cb) and logits (B, V, n_cb) for a codebook model)
    runs :func:`~repro_torch.models.lm_decode_step` with
    ``gather_logits=False`` and assembles the vocabulary shards without a
    wire (the reference's ``out_specs``), the batch split over the data
    groups where it divides (their caches the rows of one cache tree).
    Under FSDP (``fsdp``) the params are stored by ``plan`` and each group
    gathers each layer's before it runs, as the reference's step does.
    Pass it to :class:`~repro_torch.serving.ServeEngine` as ``runtime=``.
    """
    dev = resolve_device(device)
    ctx = make_ctx(mesh, comm_mode=comm_mode, plan=_layer_plan(cfg, comm_mode), device=dev)
    plan = _fsdp_plan(cfg, ctx, fsdp, mesh)
    B, capacity = shape.global_batch, shape.seq_len

    decodes = [local_step(cfg, gctx, plan) for gctx in _group_ctxs(ctx)]

    def step(params, caches, token, pos):
        token = token.to(dev)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)

        def group(g, rows):
            logits, _ = decodes[g](params, _rows(caches, rows, ctx.tp), token[rows],
                                   pos if pos.dim() == 0 else pos[rows])
            return logits

        return torch.cat(over_data_groups(ctx, token.shape[0], group)), caches

    return dict(step=step, ctx=ctx, plan=plan, batch=B, capacity=capacity)


def build_continuous_serve(cfg: ModelConfig, *, mesh=None, comm_mode: str = "smi",
                           batch_slots: int = 4, capacity: int = 128, fsdp="auto",
                           device=None) -> dict:
    """The tensor-parallel runtime of the continuous-batching engine
    (:class:`~repro_torch.serving.ContinuousEngine` ``runtime=``), on
    ``device`` (``cuda`` unless named).

    Returns ``dict(ctx, pool, plan, step, reset, migrate_start,
    migrate_finish, init_caches, batch_slots, capacity)``: the per-slot decode step (``pos``
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
    across ranks.  Under FSDP (``fsdp``) the params are stored by ``plan``
    and the step gathers each layer's over the data ring for the first
    group, the one the stack runs (the reference's runtime leaves the
    blocks ungathered here, ROADMAP.md §3).
    """
    from ..channels import ChannelPool
    from ..serving.continuous import (
        local_runtime,
        migrate_gather,
        migrate_scatter,
        open_migration,
    )

    dev = resolve_device(device)
    fsdp = check_fsdp(fsdp, mesh, cfg.param_count())
    # the batch axes are the FSDP gather's alone: slots are not split over them
    ctx = make_ctx(mesh, batch_axes=None if fsdp else (), comm_mode=comm_mode,
                   plan=_layer_plan(cfg, comm_mode), device=dev)
    plan = _fsdp_plan(cfg, ctx, fsdp, mesh)
    pool = None
    if ctx.is_smi and ctx.tp > 1:
        pool = ChannelPool(ctx.model_comm, prefix="serve.")
        ctx = dataclasses.replace(ctx, channels=pool)
    rt = local_runtime(cfg, ctx, batch_slots, capacity, dev, plan)
    if pool is not None:
        gspec, sspec = open_migration(pool)
        rt.update(
            pool=pool,
            migrate_start=lambda caches, slot: migrate_gather(caches, slot, gspec, ctx.tp),
            migrate_finish=lambda caches, inflight, slot: migrate_scatter(caches, inflight, slot,
                                                                           sspec, ctx.tp))
    rt["plan"] = plan
    return rt
