"""The public flash-attention entry point: layout, padding, dispatch
(``repro.kernels.flash_attention.ops``), and the autograd Function that
carries gradients through kernel E."""

from __future__ import annotations

import functools

import torch

from ..common import RecomputeFn, pad_to
from .kernel import flash_attention_kernel
from .ref import attention_chunked_ref, attention_ref


def _plain(q, k, v, *, causal, window, scale):
    """The refs' dispatch: :func:`attention_ref` up to ``Sq * Skv =
    2048**2``, :func:`attention_chunked_ref` beyond, as in the reference."""
    if q.shape[1] * k.shape[1] > 2048 * 2048:
        return attention_chunked_ref(q, k, v, scale=scale, causal=causal, window=window)
    return attention_ref(q, k, v, scale=scale, causal=causal, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None, block_q: int = 128,
                    block_k: int = 128, use_kernel: bool | None = None) -> torch.Tensor:
    """Multi-head attention with GQA; q ``(B, Sq, H, D)``, k/v ``(B, Skv,
    Hkv, D)``, output ``(B, Sq, H, D)``.

    ``use_kernel`` mirrors the reference's ``use_pallas``: ``None`` launches
    kernel E on CUDA tensors and runs the refs on CPU tensors; ``True`` on
    CPU tensors raises (kernel E has no CPU mode); ``False`` runs the refs
    anywhere, which on the card is for comparisons only.  The refs are
    :func:`attention_ref` up to ``Sq * Skv = 2048**2`` and
    :func:`attention_chunked_ref` beyond, as in the reference.

    On the card kernel E launches through :class:`RecomputeFn`: its
    backward recomputes the refs under autograd.  Kernel E counts query
    positions from 0 and the refs right-align them, so a gradient is taken
    only where the two agree, ``Sq == Skv`` (every model call); otherwise
    it raises."""
    on_cuda = q.device.type == "cuda"
    if use_kernel is None:
        use_kernel = on_cuda
    plain = functools.partial(_plain, causal=causal, window=window, scale=scale)
    if not use_kernel:
        return plain(q, k, v)
    if not on_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors: kernel E has no CPU mode")
    if block_q % 64 or block_k % 64:
        raise ValueError(f"block_q and block_k must be multiples of 64, not {block_q}, {block_k}")
    if torch.is_grad_enabled() and q.shape[1] != k.shape[1] \
            and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(f"kernel E's gradient is its refs', which align queries otherwise "
                         f"when Sq ({q.shape[1]}) != Skv ({k.shape[1]})")
    kernel = functools.partial(_kernel, causal=causal, window=window, scale=scale,
                               block_q=block_q, block_k=block_k)
    return RecomputeFn.apply(kernel, plain, q, k, v)


def _kernel(q, k, v, *, causal, window, scale, block_q, block_k):
    """Kernel E on the padded ``(B*H, S, D)`` layout, back to ``(B, Sq, H,
    D)``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qf = q.transpose(1, 2).reshape(B * H, Sq, D)
    kf = k.transpose(1, 2).reshape(B * Hkv, Skv, D)
    vf = v.transpose(1, 2).reshape(B * Hkv, Skv, D)
    qf, _ = pad_to(qf, block_q, 1)
    kf, _ = pad_to(kf, block_k, 1)
    vf, _ = pad_to(vf, block_k, 1)
    out = flash_attention_kernel(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                                 n_q_heads=H, n_kv_heads=Hkv, scale=scale, causal=causal,
                                 window=window, skv_actual=Skv)
    return out[:, :Sq].reshape(B, H, Sq, D).transpose(1, 2)
