"""Fused transport: static schedules whose folds run on a CUDA add kernel.

The ring collectives' hot path is ``acc = shift(acc) + partial`` repeated
P-1 times, and the rooted reductions fold each arrival the same way.  On
this backend every such plain-add fold goes through :func:`fused_accumulate`
— the hand-written CUDA kernel ``csrc/accumulate.cu`` on a CUDA tensor, its
plain PyTorch version :func:`accumulate_plain` on a CPU tensor.  The two are
equal bit for bit, so results match the static backend exactly.  Fusing the
rank-shift gather into the add (one pass over device memory instead of two)
is later work.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.build import DTYPE_CODES, check_launch, current_stream, library
from .registry import register_transport
from .static import StaticTransport


def accumulate_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``a + b``."""
    return a + b


def fused_accumulate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` elementwise: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor.

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


@register_transport("fused")
@dataclass
class FusedTransport(StaticTransport):
    """Static schedules with every plain-add fold on the add kernel
    (``shift_accumulate`` = ``accumulate(shift(x), addend)``, inherited)."""

    def accumulate(self, a, b):
        """Every reduction-combine the collective layer routes through
        :meth:`Transport.accumulate` lands on the kernel, not just the
        shift-adjacent one."""
        self._check(a)
        return fused_accumulate(a.contiguous(), b.contiguous())
