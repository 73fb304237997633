"""Kernel B: the 4-point stencil sweep (the paper's §5.4.2 application).

:func:`stencil_sweep` launches the CUDA kernel ``csrc/stencil.cu`` on a
CUDA tensor and runs :func:`stencil_sweep_plain` on a CPU tensor.  It
replaces the Pallas kernel ``stencil_pallas`` of
``src/repro/kernels/stencil/kernel.py``; that kernel streamed row slabs
through VMEM, while this one takes the whole (P, M, N) tile stack in one
launch, one thread per output point, and is bound by one read and one
write of the stack (see the source's note).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..build import DTYPE_CODES, check_launch, current_stream, library

#: dtypes the kernel takes (f32 math inside, rounded once to the input type)
SWEEP_DTYPES = (torch.float32, torch.bfloat16)


def stencil_sweep_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one zero-boundary sweep of each (M, N)
    tile of ``x`` ((M, N) or (P, M, N)), ``0.25 * (n + s + w + e)`` in
    float32, rounded once to ``x.dtype``."""
    q = F.pad(x.float(), (1, 1, 1, 1))
    out = 0.25 * (q[..., :-2, 1:-1] + q[..., 2:, 1:-1] + q[..., 1:-1, :-2] + q[..., 1:-1, 2:])
    return out.to(x.dtype)


def stencil_sweep(x: torch.Tensor) -> torch.Tensor:
    """One zero-boundary sweep of each tile of ``x`` ((M, N) or (P, M, N),
    float32 or bfloat16): the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor.  Raises on anything the kernel does not take
    and on a failed launch.  ``stencil_sweep.launches`` counts launches."""
    if x.dim() not in (2, 3):
        raise ValueError(f"stencil_sweep takes (M, N) or (P, M, N), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return stencil_sweep_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_sweep runs on cuda or cpu, not {x.device}")
    if x.dtype not in SWEEP_DTYPES:
        raise TypeError(f"stencil_sweep kernel does not take {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stencil_sweep kernel needs a contiguous tensor")
    P, M, N = (1,) * (3 - x.dim()) + tuple(x.shape)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.smi_stencil_sweep(x.data_ptr(), out.data_ptr(), P, M, N,
                                    DTYPE_CODES[x.dtype], current_stream(x))
    check_launch(err, "stencil_sweep")
    stencil_sweep.launches += 1
    return out


stencil_sweep.launches = 0
