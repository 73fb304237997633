"""Plain PyTorch oracles of ``repro.kernels.flash_attention.ref``: dense
masked softmax attention (small S) and a chunked online-softmax attention
over blocks of 512 keys (bounded memory; the dispatch for long sequences).

Both right-align the queries: query ``i`` sits at position ``i + Skv - Sq``
(decode-safe).  Kernel E and :func:`~.kernel.flash_attention_plain` count
both positions from 0 instead; the two agree when ``Sq == Skv``.
"""

from __future__ import annotations

import torch


def _expand_kv(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * g, D) float32, each KV head repeated
    for its ``g`` query heads (``jnp.repeat(..., g, axis=2)``)."""
    return torch.repeat_interleave(t.float(), g, dim=2)


def attention_ref(q, k, v, *, scale=None, causal=True, window=None):
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    kf, vf = _expand_kv(k, g), _expand_kv(v, g)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)  # right-aligned
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = qpos >= kpos
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def attention_chunked_ref(q, k, v, *, scale=None, causal=True, window=None,
                          block_k: int = 512):
    """Online-softmax attention, a loop over blocks of ``block_k`` keys:
    O(Sq * block_k) live scores instead of O(Sq * Skv).  Masked scores are
    -1e30 (not -inf) and the normaliser is clamped at 1e-30, as in the
    reference."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    q_pos = torch.arange(Sq, device=q.device) + (Skv - Sq)  # right-aligned
    m_i = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=q.device)
    l_i = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for j in range(0, Skv, block_k):
        # a short last block stands for the reference's zero padding: its
        # padded keys are masked, so they add nothing to m, l or acc
        kf = _expand_kv(k[:, j:j + block_k], g)
        vf = _expand_kv(v[:, j:j + block_k], g)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        kv_pos = j + torch.arange(kf.shape[1], device=q.device)
        mask = torch.ones((Sq, kf.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        corr = torch.exp(m_i - m_new)
        l_i = l_i * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf)
        m_i = m_new
    out = acc / l_i.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
