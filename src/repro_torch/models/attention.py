"""GQA attention (``repro.models.attention``): prefill through kernel E at
any tensor-parallel degree, ring-attention prefill, and decode over a
sequence-sharded ring-buffer KV cache.

Tensor-parallel layout (the reference's): ``wq``/``wo`` are head-sharded,
the head count padded up to a multiple of tp and the padded heads
hard-masked; ``wk``/``wv`` are replicated; the residual stream is
sequence-sharded.  Prefill runs Q through the column-parallel GEMM, gathers
the sequence for K/V, expands each rank's KV heads to its query heads
(``take(kv_idx)``) and runs kernel E over the P·B·H_loc query rows of all
ranks in one launch, then the out-projection through the row-parallel GEMM.
At tp = 1 the same steps collapse to plain products.

``opt_ring_attn`` keeps the sequence sharded instead: the head-sharded
``wq``/``wo`` are gathered once, every rank computes all heads of its
shard, and the K/V blocks stream around the ring
(:func:`apply_attention_ring`, plain PyTorch as the reference's ``jnp``).

Decode (the reference's distributed flash-decode, plain PyTorch as there):
the KV cache is sharded over the model axis on the sequence, rank r
holding the global ring slots ``[r*cap_loc, (r+1)*cap_loc)``; the query
heads are gathered (tiny), every rank scans its cache slice for all heads,
and the softmax is combined across ranks (a tagged ``pmax`` and three
``psum`` s); the out-projection takes the rank's own head slice, then a
``psum``.  At tp = 1 the same code is one rank's.  Unlike the reference,
:func:`decode_attention` writes the new key and value into the cache in
place (JAX returns a new cache; PyTorch saves the copy) and returns the
same cache dict.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from ..mesh.api import PartitionSpec as PS
from ..parallel import (
    column_parallel_linear,
    gather_sequence,
    pmax_tagged,
    psum_tagged,
    ring_attention,
    row_parallel_linear,
)
from .common import rms_norm, rope, rope_batched, trunc_normal


def _pad_heads(H: int, tp: int) -> int:
    return ((H + tp - 1) // tp) * tp


def init_attention(generator, cfg, ctx, dtype=None):
    """Global-shape attention params: ``wq`` (D, Hp*hd), ``wk``/``wv`` (D,
    Hkv*hd), ``wo`` (Hp*hd, D), the qkv biases and q/k norms where the
    config has them, with the head count padded to ``Hp``, a multiple of
    ``ctx.tp`` (the padded heads are masked); float32 unless ``dtype`` names
    another."""
    D, hd = cfg.d_model, cfg.hd
    H = _pad_heads(cfg.n_heads, ctx.tp)
    dev = generator.device
    dt = torch.float32 if dtype is None else dtype
    s_in = D ** -0.5
    p = {
        "wq": trunc_normal(generator, (D, H * hd), s_in, dt),
        "wk": trunc_normal(generator, (D, cfg.n_kv_heads * hd), s_in, dt),
        "wv": trunc_normal(generator, (D, cfg.n_kv_heads * hd), s_in, dt),
        "wo": trunc_normal(generator, (H * hd, D), (H * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def attention_specs(cfg, ctx):
    """How each attention leaf lies over the mesh: Q and the out-projection
    split by heads, K and V replicated."""
    m = ctx.model_axis
    sp = {"wq": PS(None, m), "wk": PS(None, None), "wv": PS(None, None), "wo": PS(m, None)}
    if cfg.qkv_bias:
        sp.update(bq=PS(m), bk=PS(None), bv=PS(None))
    if cfg.qk_norm:
        sp.update(q_norm=PS(None), k_norm=PS(None))
    return sp


def _head_mask_and_kv_map(cfg, ctx):
    """Every rank's ``(P, H_loc)`` mask of real heads (1.0, 0.0 for the
    padded ones) and KV head index per local head."""
    Hp = _pad_heads(cfg.n_heads, ctx.tp)
    H_loc = Hp // ctx.tp
    g = max(cfg.n_heads // cfg.n_kv_heads, 1)
    r = ctx.rank(2)
    gh = r * H_loc + torch.arange(H_loc, device=r.device)           # global head ids
    return (gh < cfg.n_heads).float(), (gh // g).clamp(0, cfg.n_kv_heads - 1)


def kv_idx_full(cfg, Hp: int, device=None) -> torch.Tensor:
    """The KV head each of the ``Hp`` query heads reads."""
    g = max(cfg.n_heads // cfg.n_kv_heads, 1)
    return (torch.arange(Hp, device=device) // g).clamp(0, cfg.n_kv_heads - 1)


def mask_full(cfg, Hp: int, device=None) -> torch.Tensor:
    """1.0 for the real query heads, 0.0 for the heads padded up to tp."""
    return (torch.arange(Hp, device=device) < cfg.n_heads).float()


def apply_attention(p, x, cfg, ctx, *, use_kernel=None):
    """Prefill.  x: (B, S, D) at tp = 1, the sequence-sharded (P, B, S/P, D)
    at tp = P > 1; returns the same shape.  ``use_kernel`` goes to
    :func:`flash_attention` (``None``: kernel E on the card, the refs on the
    CPU).  At tp > 1 ``ctx.opt_ring_attn`` runs :func:`apply_attention_ring`
    (at tp = 1 the reference's ring path is this one's arithmetic)."""
    if ctx.opt_ring_attn and ctx.tp > 1:
        return apply_attention_ring(p, x, cfg, ctx)
    if ctx.tp > 1:
        return _apply_attention_tp(p, x, cfg, ctx, use_kernel=use_kernel)
    B, S, D = x.shape
    hd = cfg.hd
    H = p["wq"].shape[1] // hd

    x2d = x.reshape(B * S, D)
    if ctx.opt_shared_gather:
        q, xf = column_parallel_linear(x2d, p["wq"], ctx, tag="tp.attn.qkv",
                                       return_gathered=True)
    else:
        q = column_parallel_linear(x2d, p["wq"], ctx, tag="tp.attn.qkv")
        xf = gather_sequence(x2d, ctx, tag="tp.attn.kv")
    k = xf @ p["wk"]
    v = xf @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    pos = torch.arange(S, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    # each query head attends its mapped KV head (expanded once)
    kv_idx = kv_idx_full(cfg, H, x.device)
    o = flash_attention(q, k.index_select(2, kv_idx), v.index_select(2, kv_idx), causal=True,
                        window=cfg.local_window, use_kernel=use_kernel)
    o = o * mask_full(cfg, H, x.device)[None, None, :, None].to(o.dtype)
    y = row_parallel_linear(o.reshape(B * S, H * hd), p["wo"], ctx, tag="tp.attn.out")
    return y.reshape(B, S, D)


def _apply_attention_tp(p, x, cfg, ctx, *, use_kernel=None):
    """Prefill at tp = P > 1 over the rank-stacked (P, B, S_loc, D)."""
    P, B, S_loc, D = x.shape
    S = S_loc * P
    hd = cfg.hd
    H_loc = p["wq"].shape[-1] // hd
    if p["wq"].shape[-1] % hd or H_loc * P != _pad_heads(cfg.n_heads, P):
        raise ValueError(f"each of the {P} ranks needs whole heads: draw the global params "
                         f"with the TP context (init_lm(..., ctx=)), which pads "
                         f"{cfg.n_heads} heads to a multiple of {P}")
    mask, kv_idx = _head_mask_and_kv_map(cfg, ctx)                  # (P, H_loc) each

    x2d = x.reshape(P, B * S_loc, D)
    # column-parallel Q (head-sharded); replicated K and V of the gathered rows
    if ctx.opt_shared_gather:
        q, xf = column_parallel_linear(x2d, p["wq"], ctx, tag="tp.attn.qkv",
                                       return_gathered=True)
    else:
        q = column_parallel_linear(x2d, p["wq"], ctx, tag="tp.attn.qkv")  # (P, P*B*S_loc, ..)
        xf = gather_sequence(x2d, ctx, tag="tp.attn.kv")
    k = xf @ p["wk"]
    v = xf @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"][:, None, :]
        k = k + p["bk"]
        v = v + p["bv"]

    def to_bshd(t, H):
        """Gathered rows, shard-major (P_src, B, S_loc), to (B, S) order."""
        return t.reshape(P, P, B, S_loc, H, hd).transpose(1, 2).reshape(P, B, S, H, hd)

    q = to_bshd(q, H_loc)
    k = to_bshd(k, cfg.n_kv_heads)
    v = to_bshd(v, cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    pos = torch.arange(S, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    # each rank's local query heads attend their mapped KV heads
    idx = kv_idx.view(P, 1, 1, H_loc, 1).expand(P, B, S, H_loc, hd)
    k_sel = torch.gather(k, 3, idx)
    v_sel = torch.gather(v, 3, idx)
    # kernel E over every rank's rows at once: the ranks join the batch
    o = flash_attention(q.reshape(P * B, S, H_loc, hd), k_sel.reshape(P * B, S, H_loc, hd),
                        v_sel.reshape(P * B, S, H_loc, hd), causal=True,
                        window=cfg.local_window, use_kernel=use_kernel)
    o = o.reshape(P, B, S, H_loc, hd) * mask.view(P, 1, 1, H_loc, 1).to(o.dtype)
    # row-parallel out-projection, reduce-scattered back to sequence shards
    o2d = o.reshape(P, B, P, S_loc, H_loc * hd).transpose(1, 2).reshape(P, P * B * S_loc, -1)
    y = row_parallel_linear(o2d, p["wo"], ctx, tag="tp.attn.out")    # (P, B*S_loc, D)
    return y.reshape(P, B, S_loc, D)


def apply_attention_ring(p, x, cfg, ctx):
    """Ring-attention prefill at tp = P > 1 (the reference's beyond-paper
    option): the sequence stays sharded and the (small, GQA) K/V blocks
    stream around the ring instead of the activations.  The head-sharded
    ``wq``/``wo`` (and ``bq``) are gathered over the model ring first (tags
    ``tp.attn.qkv`` and ``tp.attn.out``); each rank then computes all heads
    of its own sequence shard, so the output needs no reduce-scatter.
    x: (P, B, S/P, D) -> the same."""
    P, B, S_loc, D = x.shape
    hd = cfg.hd
    # the head-sharded weights gathered over the model ring (a few MB)
    wq = gather_sequence(p["wq"].transpose(-1, -2), ctx, tag="tp.attn.qkv").transpose(-1, -2)
    wo = gather_sequence(p["wo"], ctx, tag="tp.attn.out")             # (P, Hp*hd, D)
    Hp = wq.shape[-1] // hd
    x2d = x.reshape(P, B * S_loc, D)
    q, k, v = x2d @ wq, x2d @ p["wk"], x2d @ p["wv"]
    if cfg.qkv_bias:
        q = q + gather_sequence(p["bq"], ctx, tag="tp.attn.qkv")[:, None, :]
        k, v = k + p["bk"], v + p["bv"]
    q = q.reshape(P, B, S_loc, Hp, hd)
    k = k.reshape(P, B, S_loc, cfg.n_kv_heads, hd)
    v = v.reshape(P, B, S_loc, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    # every rank's positions: rank r's shard starts at r * S_loc
    pos = (ctx.rank(2) * S_loc + torch.arange(S_loc, device=x.device)).unsqueeze(1)  # (P, 1, S)
    q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    o = ring_attention(q, k, v, ctx, tag="tp.attn.ring", causal=True,
                       local_window=cfg.local_window)                # (P, B, S_loc, Hp, hd)
    o = o * mask_full(cfg, Hp, x.device)[:, None].to(o.dtype)
    y = o.reshape(P, B * S_loc, Hp * hd) @ wo                          # local rows: no scatter
    return y.reshape(P, B, S_loc, D)


# ------------------------------------------------------------------ decode


def init_kv_cache(cfg, B: int, capacity: int, ctx, dtype, device=None):
    """Sequence-sharded ring cache: k, v ``(B, cap_loc, Hkv, hd)`` zeros and
    ``slot_pos`` ``(B, cap_loc)`` int32 -1 (no entry), ``cap_loc =
    capacity // tp``; at tp = P > 1 every leaf gains the leading rank
    dimension, rank r holding the global slots ``[r*cap_loc,
    (r+1)*cap_loc)``."""
    lead = (ctx.tp,) if ctx.tp > 1 else ()
    shape = lead + (B, capacity // ctx.tp, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full(shape[:-2], -1, dtype=torch.int32, device=device),
    }


def kv_cache_specs(ctx, shard_batch: bool = True):
    """How the KV cache lies over the mesh: the sequence (slot) dimension
    split over the model axis, the batch over the data axes when
    ``shard_batch``."""
    m = ctx.model_axis
    b = None
    if shard_batch and ctx.batch_axes:
        b = ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
    return {"k": PS(b, m, None, None), "v": PS(b, m, None, None), "slot_pos": PS(b, m)}


def decode_attention(p, x, cache, pos, cfg, ctx):
    """One decode step.  x: (B, 1, D), at tp = P > 1 the rank-stacked
    (P, B, 1, D) of the replicated rows; ``pos`` is the absolute position
    of the new token, a scalar (wave decoding) or a (B,) int vector (one
    per slot).  Writes the new key and value at global slot ``pos %
    capacity`` of each row, into the rank that owns it, in place, and
    returns (y like x, cache)."""
    lead, B = x.shape[:-3], x.shape[-3]
    tp = ctx.tp
    hd = cfg.hd
    H_loc = p["wq"].shape[-1] // hd
    Hp = H_loc * tp
    dev = x.device
    cap_loc = cache["k"].shape[-3]
    capacity = cap_loc * tp
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)

    x2d = x.reshape(lead + (B, x.shape[-1]))
    q = x2d @ p["wq"]
    k_new = x2d @ p["wk"]
    v_new = x2d @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].unsqueeze(-2)
        k_new = k_new + p["bk"]
        v_new = v_new + p["bv"]
    q = q.reshape(lead + (B, 1, H_loc, hd))
    k_new = k_new.reshape(lead + (B, 1, cfg.n_kv_heads, hd))
    v_new = v_new.reshape(lead + (B, 1, cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, p["k_norm"], cfg.norm_eps)
    q = rope_batched(q, pos_b, cfg.rope_theta).reshape(lead + (B, H_loc * hd))
    k_new = rope_batched(k_new, pos_b, cfg.rope_theta)

    # gather all query heads (tiny) so that every rank scans its cache slice
    if tp > 1:
        q = gather_sequence(q[:, None], ctx, tag="tp.attn.qkv")          # (P, P, B, H_loc*hd)
        q = q.reshape(tp, tp, B, H_loc, hd).transpose(1, 2)
    q = q.reshape(lead + (B, Hp, hd))

    # ring-buffer write, per batch row: global slot pos % capacity, in the
    # rank that owns it (rank r: slots [r*cap_loc, (r+1)*cap_loc))
    rows = torch.arange(B, device=dev)
    g_slot = (pos_b % capacity).long()
    at = (torch.div(g_slot, cap_loc, rounding_mode="floor"), rows) if lead else (rows,)
    l_slot = g_slot % cap_loc
    cache["k"][at + (l_slot,)] = k_new[at + (0,)].to(cache["k"].dtype)
    cache["v"][at + (l_slot,)] = v_new[at + (0,)].to(cache["v"].dtype)
    cache["slot_pos"][at + (l_slot,)] = pos_b
    slot_pos = cache["slot_pos"]

    # partial attention over the local cache slice, all heads
    kv_idx = kv_idx_full(cfg, Hp, dev)
    k_sel = cache["k"].index_select(-2, kv_idx).float()                # (.., B, cap_loc, Hp, hd)
    v_sel = cache["v"].index_select(-2, kv_idx).float()
    s = torch.einsum("...bhd,...bkhd->...bhk", q.float() * hd ** -0.5, k_sel)
    valid = (slot_pos >= 0) & (slot_pos <= pos_b[:, None])            # (.., B, cap_loc)
    if cfg.local_window is not None:
        valid = valid & (slot_pos > pos_b[:, None] - cfg.local_window)
    valid = valid.unsqueeze(-2)
    s = torch.where(valid, s, -1e30)
    m = pmax_tagged(s.amax(dim=-1), ctx, "tp.attn.out")                # (.., B, Hp)
    pexp = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = psum_tagged(pexp.sum(dim=-1), ctx, "tp.attn.out")
    o = psum_tagged(torch.einsum("...bhk,...bkhd->...bhd", pexp, v_sel), ctx, "tp.attn.out")
    o = o / l.clamp_min(1e-30)[..., None]                              # (.., B, Hp, hd)
    o = o * mask_full(cfg, Hp, dev)[:, None]

    # row-parallel out-projection: the rank's own head slice, then the psum
    if tp > 1:
        ranks = torch.arange(tp, device=dev)
        o = o.reshape(tp, B, tp, H_loc, hd)[ranks, :, ranks]           # (P, B, H_loc, hd)
    y = psum_tagged(o.reshape(lead + (B, H_loc * hd)).to(x.dtype) @ p["wo"], ctx, "tp.attn.out")
    return y.reshape(lead + (B, 1, -1)), cache
