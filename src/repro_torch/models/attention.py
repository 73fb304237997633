"""GQA attention (``repro.models.attention``): prefill through kernel E at
any tensor-parallel degree, decode over a ring-buffer KV cache at tp = 1.

Tensor-parallel layout (the reference's): ``wq``/``wo`` are head-sharded,
the head count padded up to a multiple of tp and the padded heads
hard-masked; ``wk``/``wv`` are replicated; the residual stream is
sequence-sharded.  Prefill runs Q through the column-parallel GEMM, gathers
the sequence for K/V, expands each rank's KV heads to its query heads
(``take(kv_idx)``) and runs kernel E over the P·B·H_loc query rows of all
ranks in one launch, then the out-projection through the row-parallel GEMM.
At tp = 1 the same steps collapse to plain products.

Decode is a plain masked softmax over the cache at tp = 1.  Unlike the
reference, :func:`decode_attention` writes the new key and value into the
cache in place (JAX returns a new cache; PyTorch saves the copy) and
returns the same cache dict.
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
    CPU)."""
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


# ------------------------------------------------------------------ decode


def init_kv_cache(cfg, B: int, capacity: int, ctx, dtype, device=None):
    """Ring cache: k, v (B, capacity, Hkv, hd) zeros, ``slot_pos`` (B,
    capacity) int32 -1 (no entry)."""
    shape = (B, capacity, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((B, capacity), -1, dtype=torch.int32, device=device),
    }


def decode_attention(p, x, cache, pos, cfg, ctx):
    """One decode step.  x: (B, 1, D); ``pos`` is the absolute position of
    the new token, a scalar (wave decoding) or a (B,) int vector (one per
    slot).  Writes the new key and value at slot ``pos % capacity`` of each
    row, in place, and returns (y (B, 1, D), cache)."""
    B = x.shape[0]
    hd = cfg.hd
    H = p["wq"].shape[1] // hd
    dev = x.device
    capacity = cache["k"].shape[1]
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)

    x2d = x.reshape(B, -1)
    q = x2d @ p["wq"]
    k_new = x2d @ p["wk"]
    v_new = x2d @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k_new = k_new + p["bk"]
        v_new = v_new + p["bv"]
    q = q.reshape(B, 1, H, hd)
    k_new = k_new.reshape(B, 1, cfg.n_kv_heads, hd)
    v_new = v_new.reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, p["k_norm"], cfg.norm_eps)
    q = rope_batched(q, pos_b, cfg.rope_theta).reshape(B, H, hd)
    k_new = rope_batched(k_new, pos_b, cfg.rope_theta)

    # ring-buffer write, per batch row: slot = pos % capacity
    rows = torch.arange(B, device=dev)
    slot = (pos_b % capacity).long()
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][rows, slot] = pos_b
    slot_pos = cache["slot_pos"]

    kv_idx = kv_idx_full(cfg, H, dev)
    k_sel = cache["k"].index_select(2, kv_idx).float()               # (B, cap, H, hd)
    v_sel = cache["v"].index_select(2, kv_idx).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float() * hd ** -0.5, k_sel)
    valid = (slot_pos >= 0) & (slot_pos <= pos_b[:, None])           # (B, cap)
    if cfg.local_window is not None:
        valid = valid & (slot_pos > pos_b[:, None] - cfg.local_window)
    s = torch.where(valid[:, None, :], s, -1e30)
    m = pmax_tagged(s.amax(dim=-1), ctx, "tp.attn.out")              # (B, H)
    pexp = torch.where(valid[:, None, :], torch.exp(s - m[..., None]), 0.0)
    l = psum_tagged(pexp.sum(dim=-1), ctx, "tp.attn.out")
    o = psum_tagged(torch.einsum("bhk,bkhd->bhd", pexp, v_sel), ctx, "tp.attn.out")
    o = o / l.clamp_min(1e-30)[..., None]                             # (B, H, hd)
    o = o * mask_full(cfg, H, dev)[None, :, None]
    y = psum_tagged(o.reshape(B, H * hd).to(x.dtype) @ p["wo"], ctx, "tp.attn.out")
    return y.reshape(B, 1, -1), cache
