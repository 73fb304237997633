"""The public matmul entry point: layout, checks, dispatch
(``repro.kernels.matmul.ops``), and the autograd Function that carries
gradients through kernel D."""

from __future__ import annotations

import torch

from .kernel import MATMUL_DTYPES, WGMMA, launch_matmul
from .ref import matmul_ref


class MatmulFn(torch.autograd.Function):
    """``forward_fn(x, w, out_dtype)`` (kernel D's launch on the card, or
    any version of the product) with the product's backward computed by
    ``forward_fn`` too: ``dX = dY Wᵀ`` and ``dW = Xᵀ dY`` (summed over the
    batch when one ``(K, N)`` weight serves a ``(Bt, M, K)`` batch), each
    rounded to its operand's dtype.  On the card the backward's products
    are kernel D's launches, counted in ``matmul.launches``.  The
    transposed operands are copied contiguous first (kernel D reads
    row-major operands)."""

    @staticmethod
    def forward(ctx, forward_fn, x, w, out_dtype):
        ctx.forward_fn = forward_fn
        ctx.save_for_backward(x, w)
        return forward_fn(x, w, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mm = ctx.forward_fn
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[1]:
            gx = mm(g, w.transpose(-1, -2), x.dtype)
        if ctx.needs_input_grad[2]:
            if w.dim() == 2 and x.dim() == 3:   # one weight for the whole batch
                gw = mm(x.flatten(0, 1).transpose(0, 1), g.flatten(0, 1), w.dtype)
            else:
                gw = mm(x.transpose(-1, -2), g, w.dtype)
        return None, gx, gw, None


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
           use_kernel: bool | None = None) -> torch.Tensor:
    """``(M, K) @ (K, N) -> (M, N)``, or one launch over a leading batch
    dimension: ``(Bt, M, K) @ (Bt, K, N)`` or ``(Bt, M, K) @ (K, N)`` ->
    ``(Bt, M, N)``; any sizes (nothing is padded).  Float32 accumulation,
    the result in ``out_dtype`` (x's dtype unless named).

    ``use_kernel`` mirrors the reference's ``use_pallas``: ``None`` launches
    kernel D on CUDA tensors and runs :func:`matmul_ref` on CPU tensors;
    ``True`` on CPU tensors raises (kernel D has no CPU mode); ``False``
    runs :func:`matmul_ref` anywhere, which on the card is for comparisons
    only.  On the card the launch goes through :class:`MatmulFn`, so
    gradients pass, their products on kernel D too.  ``matmul.launches``
    counts kernel launches, and ``matmul.wgmma_launches`` those that took
    the wgmma path (:func:`~.kernel.matmul_path`)."""
    on_cuda = x.is_cuda
    if use_kernel is None:
        use_kernel = on_cuda
    if not use_kernel:
        return matmul_ref(x, w, out_dtype=out_dtype)
    if not on_cuda or w.device != x.device:
        raise ValueError(f"kernel D runs on one CUDA device (it has no CPU mode); got x on "
                         f"{x.device}, w on {w.device}")
    out_dtype = out_dtype or x.dtype
    if x.dtype not in MATMUL_DTYPES or w.dtype != x.dtype or out_dtype not in MATMUL_DTYPES:
        raise TypeError(f"kernel D takes float32 or bfloat16 operands alike and gives float32 "
                        f"or bfloat16, not {x.dtype} @ {w.dtype} -> {out_dtype}")
    if x.dim() not in (2, 3) or w.dim() not in (2, x.dim()) or x.shape[-1] != w.shape[-2] \
            or (w.dim() == 3 and w.shape[0] != x.shape[0]):
        raise ValueError(f"kernel D takes (M, K) @ (K, N), (Bt, M, K) @ (Bt, K, N) or "
                         f"(Bt, M, K) @ (K, N); got {tuple(x.shape)} @ {tuple(w.shape)}")
    return MatmulFn.apply(_matmul_launch, x, w, out_dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of kernel D on checked CUDA operands (made contiguous)."""
    x3 = (x if x.dim() == 3 else x.unsqueeze(0)).contiguous()
    w3 = (w if w.dim() == 3 else w.unsqueeze(0)).contiguous()
    out = torch.empty(x.shape[:-1] + (w3.shape[2],), dtype=out_dtype, device=x.device)
    if out.numel():
        path = launch_matmul(x3, w3, out if x.dim() == 3 else out.unsqueeze(0))
        matmul.launches += 1
        matmul.wgmma_launches += int(path == WGMMA)
    return out


def _plain(x, w, out_dtype):
    return matmul_ref(x, w, out_dtype=out_dtype)


#: kernel D as the dispatcher op ``repro_torch::matmul_d`` (CUDA: the
#: launch; CPU: :func:`matmul_ref`; Meta: the shape), so that a dispatch
#: mode sees it as a matrix product: a selective-checkpoint policy
#: (``models/transformer.py recomputed``) saves its outputs, and a product
#: it saves is not launched again in the recompute.  Registered without a
#: Python wrapper: one call costs the dispatcher's hop into Python.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("matmul_d(Tensor x, Tensor w, ScalarType out_dtype) -> Tensor")
_LIB.impl("matmul_d", _launch, "CUDA")
_LIB.impl("matmul_d", _plain, "CPU")
_LIB.impl("matmul_d", lambda x, w, out_dtype: x.new_empty(x.shape[:-1] + (w.shape[-1],),
                                                          dtype=out_dtype), "Meta")

#: kernel D's dispatcher op (what a remat policy names)
matmul_op = torch.ops.repro_torch.matmul_d.default


def _matmul_launch(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel D's product as :class:`MatmulFn` runs it: through
    :data:`matmul_op` while a dispatch mode is active (a selective-checkpoint
    policy, or a test counting products), else straight to its kernel for
    the operands' device, which skips the dispatcher's cost on every launch
    that no mode looks at (the serving and prefill paths)."""
    if torch._C._len_torch_dispatch_stack():
        return matmul_op(x, w, out_dtype)
    return (_launch if x.is_cuda else _plain)(x, w, out_dtype)


matmul.launches = 0
matmul.wgmma_launches = 0
