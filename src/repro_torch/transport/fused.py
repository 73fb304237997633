"""Fused transport: static schedules whose folds run on a CUDA add kernel.

The ring collectives' hot path is ``acc = shift(acc) + partial`` repeated
P-1 times, and the rooted reductions fold each arrival the same way.  On
this backend each ring step is ONE pass over device memory,
:func:`fused_shift_accumulate` (``out[r] = x[src[r]] + addend[r]``: the
shift is a gather of another rank's row, read inside the add, so the
shifted copy is never written), and every other plain-add fold goes through
:func:`fused_accumulate`.  Both are the hand-written CUDA kernel
``csrc/accumulate.cu`` on a CUDA tensor and their plain PyTorch versions
(:func:`shift_accumulate_plain`, :func:`accumulate_plain`) on a CPU tensor.
Kernel and plain version are equal bit for bit, and the stats tally what
the static backend tallies, so results and counters match it exactly.
Operands go through ``.contiguous()`` (a no-op on the ring's own tensors).

On the card each entry point launches through a ``torch.autograd.Function``
(:class:`AccumulateFn`, :class:`ShiftAccumulateFn`), whose backward routes
the gradient as the add and the gather do: the kernel writes into a
``torch.empty``, which autograd would otherwise cut from the graph.  On the
CPU the plain version carries autograd by itself.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..kernels.build import DTYPE_CODES, check_launch, current_stream, library
from .registry import register_transport
from .static import StaticTransport


def accumulate_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``a + b``."""
    return a + b


class AccumulateFn(torch.autograd.Function):
    """``forward_fn(a, b)`` (kernel A's launch on the card, or any version
    of ``a + b``) with the add's backward: the gradient to both operands."""

    @staticmethod
    def forward(ctx, forward_fn, a, b):
        return forward_fn(a, b)

    @staticmethod
    def backward(ctx, g):
        return None, g, g


def fused_accumulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` elementwise: the CUDA kernel on a CUDA tensor (through
    :class:`AccumulateFn`, so gradients pass), the plain version on a CPU
    tensor.

    Takes contiguous tensors of one shape and dtype (float32, bfloat16,
    float16 or int32) on one device; raises on anything else, and on a
    failed launch.  ``fused_accumulate.launches`` counts kernel launches.
    """
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(
            f"fused_accumulate needs operands of one shape, dtype and device; got "
            f"{tuple(a.shape)}/{a.dtype}/{a.device} and {tuple(b.shape)}/{b.dtype}/{b.device}"
        )
    if a.device.type == "cpu":
        return accumulate_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fused_accumulate runs on cuda or cpu, not {a.device}")
    return AccumulateFn.apply(_accumulate_kernel, a, b)


def _accumulate_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the add kernel on CUDA operands of one shape."""
    if a.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_accumulate kernel does not take {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_accumulate kernel needs contiguous operands")
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(a.device):
        err = lib.smi_accumulate(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                                 DTYPE_CODES[a.dtype], current_stream(a))
    check_launch(err, "accumulate")
    fused_accumulate.launches += 1
    return out


fused_accumulate.launches = 0


@functools.lru_cache(maxsize=512)
def source_index(pairs: tuple, n: int, device: torch.device) -> torch.Tensor:
    """The ``(n,)`` int32 source rank of every rank under the partial
    permutation ``pairs`` (-1 for a rank that receives nothing), made once
    per (pairs, n, device): a copy from host memory to the card would
    synchronise every ring step."""
    src = [-1] * n
    for s, d in pairs:
        if src[d] != -1:
            raise ValueError(f"rank {d} receives twice in {list(pairs)}")
        src[d] = s
    return torch.tensor(src, dtype=torch.int32, device=device)


def shift_accumulate_plain(x: torch.Tensor, addend: torch.Tensor,
                           src_idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the gather-fused kernel, ``ppermute``
    then add written out: row ``r`` is ``x[src_idx[r]] + addend[r]``, and
    ``0 + addend[r]`` (a real add of zero, so -0.0 becomes +0.0) where
    ``src_idx[r] < 0`` (selected without a boolean mask, whose size
    would depend on the data: the meta device runs it too)."""
    recv = (src_idx >= 0).view((-1,) + (1,) * (x.dim() - 1))
    shifted = torch.where(recv, x.index_select(0, src_idx.clamp_min(0).long()),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    return shifted + addend


class ShiftAccumulateFn(torch.autograd.Function):
    """``forward_fn(x, addend, src_idx)`` (kernel A's gather-fused launch on
    the card, or any version of ``out[r] = x[src_idx[r]] + addend[r]``) with
    the backward of the gather and the add: ``addend`` takes the gradient as
    it is, and row ``s`` of ``x`` the gradient of the row it was sent to
    (zero for a rank that sends nothing).  ``src_idx`` is a partial
    permutation, so each source row has at most one destination; the
    inverse is built on the device, without a host read."""

    @staticmethod
    def forward(ctx, forward_fn, x, addend, src_idx):
        ctx.save_for_backward(src_idx)
        return forward_fn(x, addend, src_idx)

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        grad_x = None
        if ctx.needs_input_grad[1]:
            P = src.shape[0]
            ranks = torch.arange(P, device=src.device)
            # dst[s]: the rank that received row s, or -1; every rank that
            # receives nothing writes the spare slot P
            dst = torch.full((P + 1,), -1, dtype=torch.long, device=src.device)
            dst.scatter_(0, torch.where(src >= 0, src.long(), P), ranks)
            dst = dst[:P]
            sent = (dst >= 0).reshape((P,) + (1,) * (g.dim() - 1))
            grad_x = torch.where(sent, g[dst.clamp_min(0)], torch.zeros((), dtype=g.dtype,
                                                                       device=g.device))
        return None, grad_x, g, None


def fused_shift_accumulate(x: torch.Tensor, addend: torch.Tensor,
                           src_idx: torch.Tensor) -> torch.Tensor:
    """``out[r] = x[src_idx[r]] + addend[r]`` over the rank-stacked ``(P,
    ...)`` operands, zeros in place of ``x``'s row where ``src_idx[r] < 0``:
    one launch of the CUDA kernel on CUDA tensors (through
    :class:`ShiftAccumulateFn`, so gradients pass), the plain version on CPU
    tensors.

    Takes contiguous ``x`` and ``addend`` of one shape and dtype (float32,
    bfloat16, float16 or int32) and a ``(P,)`` int32 ``src_idx``, all on one
    device; raises on anything else, and on a failed launch.
    ``fused_shift_accumulate.launches`` counts kernel launches.
    """
    if x.shape != addend.shape or x.dtype != addend.dtype or x.device != addend.device:
        raise ValueError(
            f"fused_shift_accumulate needs operands of one shape, dtype and device; got "
            f"{tuple(x.shape)}/{x.dtype}/{x.device} and "
            f"{tuple(addend.shape)}/{addend.dtype}/{addend.device}")
    if x.dim() == 0 or src_idx.shape != (x.shape[0],) or src_idx.device != x.device:
        raise ValueError(f"fused_shift_accumulate needs a ({x.shape[0] if x.dim() else 0},) "
                         f"src_idx on {x.device}, got {tuple(src_idx.shape)} on {src_idx.device}")
    if x.device.type == "cpu":
        return shift_accumulate_plain(x, addend, src_idx)
    if x.device.type != "cuda":
        raise ValueError(f"fused_shift_accumulate runs on cuda or cpu, not {x.device}")
    return ShiftAccumulateFn.apply(_shift_accumulate_kernel, x, addend, src_idx)


def _shift_accumulate_kernel(x: torch.Tensor, addend: torch.Tensor,
                             src_idx: torch.Tensor) -> torch.Tensor:
    """One launch of the gather-fused kernel on checked CUDA operands."""
    if x.dtype not in DTYPE_CODES or src_idx.dtype != torch.int32:
        raise TypeError(f"fused_shift_accumulate kernel does not take {x.dtype} operands "
                        f"with a {src_idx.dtype} src_idx")
    if not (x.is_contiguous() and addend.is_contiguous() and src_idx.is_contiguous()):
        raise ValueError("fused_shift_accumulate kernel needs contiguous operands")
    P = x.shape[0]
    if P > 65535:
        raise ValueError(f"fused_shift_accumulate kernel takes at most 65535 ranks, not {P}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.smi_shift_accumulate(x.data_ptr(), addend.data_ptr(), src_idx.data_ptr(),
                                       out.data_ptr(), P, x.numel() // P, DTYPE_CODES[x.dtype],
                                       current_stream(x))
    check_launch(err, "shift_accumulate")
    fused_shift_accumulate.launches += 1
    return out


fused_shift_accumulate.launches = 0


@register_transport("fused")
@dataclass
class FusedTransport(StaticTransport):
    """Static schedules with each ring step on the gather-fused kernel and
    every other plain-add fold on the add kernel."""

    def accumulate(self, a, b):
        """Every reduction-combine the collective layer routes through
        :meth:`Transport.accumulate` (the rooted folds) lands on the add
        kernel (the plain add on the dry run's ``meta`` tensors, shapes
        only: the kernel has no meta mode)."""
        self._check(a)
        if a.is_meta:
            return accumulate_plain(a, b)
        return fused_accumulate(a.contiguous(), b.contiguous())

    def shift_accumulate(self, x, addend, comm, step: int = 1):
        """``shift(x) + addend`` in one launch: tallies one step carrying one
        rank row of ``x``, as :meth:`StaticTransport.permute` does for the
        shift, so the stats equal the static backend's (the plain version on
        ``meta`` tensors)."""
        self._check(x)
        self.account(x)
        src = source_index(tuple(comm.ring_perm(step)), x.shape[0], x.device)
        if x.is_meta:
            return shift_accumulate_plain(x, addend, src)
        return fused_shift_accumulate(x.contiguous(), addend.contiguous(), src)
