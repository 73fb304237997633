"""The public flash-attention entry point: layout, padding, dispatch
(``repro.kernels.flash_attention.ops``), and the autograd Function that
carries gradients through kernel E."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

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
    it raises.  On the ``meta`` device (the dry run, ``launch/dryrun.py``)
    it goes through :class:`RecomputeFn` and :data:`flash_attention_op` as
    on the card, shapes only, so that a dispatch mode counts kernel E's own
    work and traffic in the forward and the refs' in the backward."""
    on_card = q.device.type in ("cuda", "meta")
    if use_kernel is None:
        use_kernel = on_card
    plain = functools.partial(_plain, causal=causal, window=window, scale=scale)
    if not use_kernel:
        return plain(q, k, v)
    if not on_card:
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
    launch = flash_attention_op if qf.is_meta else flash_attention_kernel
    out = launch(qf.contiguous(), kf.contiguous(), vf.contiguous(), n_q_heads=H, n_kv_heads=Hkv,
                 scale=scale, causal=causal, window=window, skv_actual=Skv)
    return out[:, :Sq].reshape(B, H, Sq, D).transpose(1, 2)


def visible_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs one head of kernel E computes: query ``i``
    (counted from 0) sees the keys ``j < skv`` with ``j <= i`` and ``j > i
    - window`` when causal, all ``skv`` otherwise."""
    if not causal:
        return sq * skv
    n = sq if window is None else min(sq, skv + window - 1)    # rows that see a key
    m = min(n, skv)
    t = 0 if window is None else max(0, n - window)
    return m * (m + 1) // 2 + max(0, n - skv) * skv - t * (t + 1) // 2


#: kernel E on the ``meta`` device as the dispatcher op
#: ``repro_torch::flash_attention_e`` (Meta: the output's shape; it has no
#: other implementation: the card launches :func:`flash_attention_kernel`
#: directly), so that the dry run's dispatch modes see one op moving q, k,
#: v and the output, and count its operations by :func:`_flash_flops`
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_e(Tensor q, Tensor k, Tensor v, *, int n_q_heads, int n_kv_heads, "
            "float scale, bool causal, int? window, int skv_actual) -> Tensor")
_LIB.impl("flash_attention_e", lambda q, k, v, **_: torch.empty_like(q), "Meta")
flash_attention_op = torch.ops.repro_torch.flash_attention_e.default


@register_flop_formula(torch.ops.repro_torch.flash_attention_e)
def _flash_flops(q_shape, k_shape, v_shape, *, causal, window, skv_actual, out_shape=None,
                 **_) -> int:
    """Kernel E's operations for ``torch.utils.flop_counter``: two products
    (scores and scores x values) of two a multiply-add over every visible
    pair of each of the ``BH`` query rows' heads."""
    BH, Sq, D = q_shape
    return 4 * D * BH * visible_pairs(Sq, skv_actual, causal, window)
