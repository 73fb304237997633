"""Block assembly (``repro.models.transformer``): the dense ``"attn"``
block, the MoE ``"moe"`` block (attention, then the experts), the Mamba2
``"ssm"`` block and the RG-LRU ``"rec"`` block (the recurrence, then the
MLP), stacked per pattern period.

Parameters keep the reference's layout: ``{"periods": tuple of per-position
block trees whose leaves carry a leading layer dim, "rem": tuple of
remainder blocks}``.  The periods run as a Python loop over that dim (the
reference's ``lax.scan``), each period under ``torch.utils.checkpoint``
when the training step asks for remat (:func:`apply_stack`).  Under FSDP
(``fsdp_plan``) a period's leaves are stored ``(L, dp, ...)``, each
layer's gathered over the data ring as the layer runs.  At tp > 1 the
activations are the rank-stacked ``(P, B, S/P, D)`` and the sharded leaves
of a period are laid out ``(L, P, ...)`` (``interop.shard_params``), so a
layer's slice is rank-stacked; so are the decode caches, ``(L, P, B, ...)``.
A block returns the MoE load-balancing loss beside its output (0 for the
blocks without experts), as the reference's does.  An unknown block kind
raises ``ValueError``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from ..mesh.api import PartitionSpec as PS
from ..parallel import ledger
from .attention import (
    apply_attention,
    attention_specs,
    decode_attention,
    init_attention,
    init_kv_cache,
    kv_cache_specs,
)
from .common import rms_norm, tree_map
from .mlp import apply_mlp, apply_mlp_replicated, init_mlp, mlp_specs
from .moe import apply_moe, apply_moe_replicated, init_moe, moe_specs
from .rglru import (
    apply_rglru,
    decode_rglru,
    init_rglru,
    init_rglru_cache,
    rglru_cache_specs,
    rglru_specs,
)
from .ssm import apply_ssm, decode_ssm, init_ssm, init_ssm_cache, ssm_cache_specs, ssm_specs

#: the block kinds of the reference, all run by the port
KINDS = ("attn", "moe", "ssm", "rec")
#: the reference's remat policies: ``"none"`` keeps every activation;
#: ``"dots"`` saves every matrix product's output and recomputes the rest
#: in the backward pass; ``"dots_nb"`` saves only the products without
#: batch dimensions (the projections, not attention's score blocks);
#: ``"nothing"`` recomputes each period from its input
REMAT_POLICIES = ("none", "dots", "dots_nb", "nothing")


def check_remat(remat: str):
    """Raise on a remat policy the reference does not define."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")


def _product_ops():
    """The dispatcher's matrix products: ATen's (``torch.matmul`` and
    ``einsum`` reach them) and kernel D's op, which its autograd Function
    launches."""
    from ..kernels.matmul.ops import matmul_op

    a = torch.ops.aten
    plain = (a.mm.default, a.addmm.default)
    batched = (a.bmm.default, a.baddbmm.default)
    return plain, batched, matmul_op


class _Projections(TorchFunctionMode):
    """Marks the rank-stacked projections of tp = P > 1 while they
    dispatch: a product called as ``(P, t, K) @ (P, K, N)``, each rank's
    2-D product stacked (the reference's per-device dot without batch
    dimensions).  The batched products (attention's scores, the experts')
    are called through ``einsum`` or with more dimensions, so they stay
    unmarked even where their flattened batch happens to equal P."""

    _FUNCS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.bmm)

    def __init__(self, tp: int):
        super().__init__()
        self.tp = tp
        self.depth = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._FUNCS and len(args) == 2 and all(
                isinstance(a, torch.Tensor) and a.dim() == 3 and a.shape[0] == self.tp
                for a in args):
            self.depth += 1
            try:
                return func(*args, **kwargs)
            finally:
                self.depth -= 1
        return func(*args, **kwargs)


def _saves_product(remat: str, marks: _Projections | None = None):
    """The selective-checkpoint policy of a ``"dots"`` remat: which op
    outputs to keep for the backward pass.  ``"dots_nb"`` keeps the 2-D
    products, kernel D's, and the batched products that ``marks`` (an
    active :class:`_Projections`, at tp > 1) holds for rank-stacked
    projections; it recomputes the products with a batch (attention's
    score blocks, the experts')."""
    from torch.utils.checkpoint import CheckpointPolicy

    plain, batched, kernel = _product_ops()

    def policy(_ctx, op, *args, **kwargs):
        if op in plain or op is kernel:
            keep = True
        elif op in batched:
            keep = remat == "dots" or (marks is not None and marks.depth > 0)
        else:
            keep = False
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


@contextlib.contextmanager
def _all(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


def recomputed(fn, *args, remat: str = "nothing", tp: int = 1):
    """``fn(*args)`` whose activations are recomputed in the backward pass,
    as the reference's ``jax.checkpoint`` with ``remat``'s policy
    (``"nothing"``: every one; ``"dots"``/``"dots_nb"``: all but the
    matrix products the policy saves, through
    ``torch.utils.checkpoint.create_selective_checkpoint_contexts``).  The
    recompute runs the Python forward again, so it runs with the ledger
    paused: the capture holds each collective once, as the reference's
    trace does (its AD-transposed collectives tally nothing either).
    Kernel launches are real work and count in both; a product the policy
    saves is not launched again."""
    if remat == "nothing":
        def context_fn():
            return contextlib.nullcontext(), ledger.paused()
    else:
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        def context_fn():
            marks = _Projections(tp) if remat == "dots_nb" and tp > 1 else None
            fwd, rec = create_selective_checkpoint_contexts(_saves_product(remat, marks))
            extra = (marks,) if marks is not None else ()
            return _all(fwd, *extra), _all(rec, *extra, ledger.paused())
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)


def _check_kind(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def init_block(generator, kind: str, cfg, ctx, dtype=None):
    """``{"norm1", "attn", "norm2", "mlp"}`` for an attention block, the
    same with ``"moe"`` in place of ``"mlp"`` for an MoE block and ``"rec"``
    in place of ``"attn"`` for an RG-LRU block, ``{"norm1", "ssm"}`` (no
    MLP) for an SSM block."""
    _check_kind(kind)
    D = cfg.d_model
    dt = torch.float32 if dtype is None else dtype
    dev = generator.device
    p = {"norm1": torch.ones((D,), dtype=dt, device=dev)}
    if kind == "ssm":
        p["ssm"] = init_ssm(generator, cfg, ctx, dtype)
        return p
    if kind == "rec":
        p["rec"] = init_rglru(generator, cfg, ctx, dtype)
    else:
        p["attn"] = init_attention(generator, cfg, ctx, dtype)
    p["norm2"] = torch.ones((D,), dtype=dt, device=dev)
    if kind in ("attn", "rec"):
        p["mlp"] = init_mlp(generator, cfg, ctx, dtype=dtype)
    else:
        p["moe"] = init_moe(generator, cfg, ctx, dtype)
    return p


def block_specs(kind: str, cfg, ctx):
    """How each leaf of a block lies over the mesh (the norms replicated)."""
    _check_kind(kind)
    if kind == "ssm":
        return {"norm1": PS(None), "ssm": ssm_specs(cfg, ctx)}
    if kind == "rec":
        return {"norm1": PS(None), "rec": rglru_specs(cfg, ctx), "norm2": PS(None),
                "mlp": mlp_specs(cfg, ctx)}
    sp = {"norm1": PS(None), "attn": attention_specs(cfg, ctx), "norm2": PS(None)}
    if kind == "attn":
        sp["mlp"] = mlp_specs(cfg, ctx)
    else:
        sp["moe"] = moe_specs(cfg, ctx)
    return sp


def apply_block(p, kind: str, x, cfg, ctx, *, use_kernel=None):
    """One block over x, (B, S, D) at tp = 1 or (P, B, S/P, D) at tp > 1;
    returns (x, the block's load-balancing loss).  ``use_kernel`` goes to
    the attention (kernel E) or the SSD scan (kernel F)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        x = x + apply_ssm(p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, ctx,
                          use_kernel=use_kernel)
        return x, aux
    if kind == "rec":
        x = x + apply_rglru(p["rec"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, ctx)
        return x + apply_mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg, ctx), aux
    x = x + apply_attention(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, ctx,
                            use_kernel=use_kernel)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind == "attn":
        return x + apply_mlp(p["mlp"], h, cfg, ctx), aux
    y, aux = apply_moe(p["moe"], h, cfg, ctx)
    return x + y, aux


def init_block_cache(kind: str, cfg, B: int, capacity: int, ctx, dtype, device=None):
    """A block's decode cache; a windowed attention layer keeps at most its
    window, padded up to a multiple of tp (the reference's cap), of the
    ``capacity`` slots."""
    _check_kind(kind)
    if kind == "ssm":
        return init_ssm_cache(cfg, B, ctx, dtype, device)
    if kind == "rec":
        return init_rglru_cache(cfg, B, ctx, dtype, device)
    cap = capacity if cfg.local_window is None else min(
        capacity, _pow2_pad(cfg.local_window, ctx.tp))
    return init_kv_cache(cfg, B, cap, ctx, dtype, device)


def _pow2_pad(w: int, tp: int) -> int:
    """``w`` rounded up to a multiple of ``tp`` (the reference's name)."""
    return ((w + tp - 1) // tp) * tp


def block_cache_specs(kind: str, ctx, shard_batch: bool = True):
    """How a block's decode cache lies over the mesh."""
    _check_kind(kind)
    if kind == "ssm":
        return ssm_cache_specs(ctx, shard_batch)
    if kind == "rec":
        return rglru_cache_specs(ctx, shard_batch)
    return kv_cache_specs(ctx, shard_batch)


def decode_block(p, kind: str, x, cache, pos, cfg, ctx):
    _check_kind(kind)
    if kind == "ssm":
        y, cache = decode_ssm(p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps), cache, cfg, ctx)
        return x + y, cache
    if kind == "rec":
        y, cache = decode_rglru(p["rec"], rms_norm(x, p["norm1"], cfg.norm_eps), cache, cfg,
                                ctx)
        x = x + y
        return x + apply_mlp_replicated(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg,
                                        ctx), cache
    y, cache = decode_attention(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cache, pos,
                                cfg, ctx)
    x = x + y
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind == "attn":
        return x + apply_mlp_replicated(p["mlp"], h, cfg, ctx), cache
    y, _ = apply_moe_replicated(p["moe"], h, cfg, ctx)
    return x + y, cache


# ------------------------------------------------------------ stacked form


def _layout(cfg):
    period = len(cfg.pattern)
    return cfg.pattern, period, cfg.n_layers // period, cfg.n_layers % period


def _layer(stacked, i: int):
    return tree_map(lambda t: t[i], stacked)


def init_stack(generator, cfg, ctx, dtype=None):
    """``{"periods", "rem"}`` params.  Each layer is drawn in float32 and
    copied into its slot of the stacked leaves (cast to ``dtype``), so the
    peak is one layer above the stack."""
    pattern, period, n_full, rem = _layout(cfg)
    stacked = None
    for i in range(n_full):
        blocks = tuple(init_block(generator, pattern[j], cfg, ctx, dtype) for j in range(period))
        if stacked is None:
            stacked = tree_map(lambda t: torch.empty((n_full,) + tuple(t.shape), dtype=t.dtype,
                                                     device=t.device), blocks)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, blocks)
        del blocks
    remainder = tuple(init_block(generator, pattern[j], cfg, ctx, dtype) for j in range(rem))
    return {"periods": stacked, "rem": remainder}


def stack_specs(cfg, ctx):
    """``{"periods", "rem"}`` specs; a period's leaves gain the leading
    (unsharded) layer dimension."""
    pattern, period, n_full, rem = _layout(cfg)

    def prepend(tree):
        return tree_map(lambda sp: PS(None, *sp), tree)

    stacked = (tuple(prepend(block_specs(pattern[j], cfg, ctx)) for j in range(period))
               if n_full > 0 else None)
    return {"periods": stacked, "rem": tuple(block_specs(pattern[j], cfg, ctx)
                                             for j in range(rem))}


def _period_specs(cfg, ctx):
    """One layer's specs at each period position (the leaves' model
    layout, which an FSDP gather reads)."""
    return tuple(block_specs(kind, cfg, ctx) for kind in cfg.pattern)


def _gathered(blocks, plan, specs, ctx):
    """``blocks`` with their FSDP leaves gathered for ``ctx``'s data group
    (no plan: as they are)."""
    if plan is None:
        return blocks
    from ..mesh.api import fsdp_gather

    return fsdp_gather(blocks, plan, ctx, specs)


def apply_stack(params, x, cfg, ctx, *, use_kernel=None, remat: str = "dots",
                fsdp_plan=None):
    """Every layer over x; returns (x, the layers' load-balancing losses
    summed).  ``remat`` other than ``"none"`` recomputes each period in the
    backward pass under that policy (:func:`recomputed`), as the
    reference's ``jax.checkpoint`` around its period body; the remainder
    layers are not recomputed there either.  ``fsdp_plan`` (the params'
    ``stack`` subtree of :func:`~repro_torch.mesh.api.build_fsdp_plan`)
    gathers each layer's FSDP leaves over the data ring as the layer runs
    (inside the recomputed period, so the recompute gathers again)."""
    from ..mesh.api import _shift_plan

    check_remat(remat)
    pattern, period, n_full, _ = _layout(cfg)
    plan = fsdp_plan
    period_plan = (_shift_plan(plan["periods"])
                   if plan is not None and plan["periods"] is not None else None)
    specs = _period_specs(cfg, ctx) if plan is not None else None

    def period_fn(x, i):
        blocks = _gathered(tuple(_layer(params["periods"][j], i) for j in range(period)),
                           period_plan, specs, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(period):
            x, a = apply_block(blocks[j], pattern[j], x, cfg, ctx, use_kernel=use_kernel)
            aux = aux + a
        return x, aux

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_full if params["periods"] is not None else 0):
        x, aux = (period_fn(x, i) if remat == "none"
                  else recomputed(period_fn, x, i, remat=remat, tp=ctx.tp))
        aux_total = aux_total + aux
    for j, p in enumerate(params["rem"]):
        p = _gathered(p, None if plan is None else plan["rem"][j],
                      None if specs is None else specs[j], ctx)
        x, aux = apply_block(p, pattern[j], x, cfg, ctx, use_kernel=use_kernel)
        aux_total = aux_total + aux
    return x, aux_total


def init_stack_cache(cfg, B: int, capacity: int, ctx, dtype, device=None):
    pattern, period, n_full, rem = _layout(cfg)
    stacked = None
    if n_full > 0:
        stacked = tuple(
            tree_map(lambda t: t.unsqueeze(0).repeat((n_full,) + (1,) * t.dim()),
                     init_block_cache(pattern[j], cfg, B, capacity, ctx, dtype, device))
            for j in range(period))
    remainder = tuple(init_block_cache(pattern[j], cfg, B, capacity, ctx, dtype, device)
                      for j in range(rem))
    return {"periods": stacked, "rem": remainder}


def stack_cache_specs(cfg, ctx, shard_batch: bool = True):
    """``{"periods", "rem"}`` cache specs; a period's leaves gain the
    leading (unsharded) layer dimension."""
    pattern, period, n_full, rem = _layout(cfg)

    def prepend(tree):
        return tree_map(lambda sp: PS(None, *sp), tree)

    stacked = (tuple(prepend(block_cache_specs(pattern[j], ctx, shard_batch))
                     for j in range(period)) if n_full > 0 else None)
    return {"periods": stacked, "rem": tuple(block_cache_specs(pattern[j], ctx, shard_batch)
                                             for j in range(rem))}


def decode_stack(params, caches, x, pos, cfg, ctx, *, fsdp_plan=None):
    """One decode step through every layer; each layer's cache is a view of
    the stacked cache and is updated in place.  ``fsdp_plan`` (the
    ``stack`` subtree) gathers each layer's FSDP leaves over the data ring
    before it runs.  Returns (x, caches)."""
    from ..mesh.api import _shift_plan

    pattern, period, n_full, _ = _layout(cfg)
    plan = fsdp_plan
    period_plan = (_shift_plan(plan["periods"])
                   if plan is not None and plan["periods"] is not None else None)
    specs = _period_specs(cfg, ctx) if plan is not None else None
    for i in range(n_full if params["periods"] is not None else 0):
        blocks = _gathered(tuple(_layer(params["periods"][j], i) for j in range(period)),
                           period_plan, specs, ctx)
        for j in range(period):
            x, _ = decode_block(blocks[j], pattern[j], x, _layer(caches["periods"][j], i), pos,
                                cfg, ctx)
    for j, p in enumerate(params["rem"]):
        p = _gathered(p, None if plan is None else plan["rem"][j],
                      None if specs is None else specs[j], ctx)
        x, _ = decode_block(p, pattern[j], x, caches["rem"][j], pos, cfg, ctx)
    return x, caches
