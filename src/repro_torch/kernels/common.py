"""Shared kernel utilities: padding to a block multiple, ceiling division
(the parts of ``repro.kernels.common`` the port's wrappers use), the
16-byte alignment TMA needs, the plain versions' CPU transcendentals
on the calling thread, and the autograd Function whose backward is a plain
version's (kernels E and F)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to(x: torch.Tensor, multiple: int, axis: int) -> tuple[torch.Tensor, int]:
    """Zero-pad ``axis`` up to a multiple; returns (padded, original_size).
    An ``x`` already at a multiple comes back as it is, not copied."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, size
    axis = axis % x.dim()
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]  # F.pad lists the last dim first
    return F.pad(x, widths), size


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on 16 bytes (a
    view into another tensor): TMA reads and writes 16-byte-aligned bases."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


#: elements below which ATen runs a CPU elementwise op on the calling thread
#: (its vectorised-math loops split work over the OpenMP workers from 2,048)
SERIAL_ELEMS = 1024


def on_calling_thread(op, t: torch.Tensor) -> torch.Tensor:
    """``op(t)`` for an elementwise ``op`` (``torch.exp``, ``torch.erfinv``)
    evaluated, on a CPU tensor, in pieces of :data:`SERIAL_ELEMS` that ATen
    runs on the calling thread.  Split over the OpenMP workers, such an op
    can return one worker's share at about 1.5e-4 relative error on that
    worker's first call in a process (a different share each time, more
    often under load); on the calling thread alone the result has the same
    bits on every call.  On CUDA it is one call."""
    if t.device.type != "cpu" or t.numel() <= SERIAL_ELEMS:
        return op(t)
    return torch.cat([op(p) for p in t.reshape(-1).split(SERIAL_ELEMS)]).view(t.shape)


class RecomputeFn(torch.autograd.Function):
    """``forward_fn(*inputs)`` (a kernel's launch on the card, or any
    version of the function) whose backward recomputes ``plain_fn(*inputs)``
    under autograd and takes its gradients: the reference defines no
    backward kernel for its Pallas kernels, so the backward of kernels E
    and F is their plain version's.  Every input is a tensor; those that
    need no gradient get ``None``."""

    @staticmethod
    def forward(ctx, forward_fn, plain_fn, *inputs):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*inputs)
        return forward_fn(*inputs)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            out = ctx.plain_fn(*leaves)
        wanted = [t for t, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (None, None) + tuple(next(got) if n else None for n in need)
