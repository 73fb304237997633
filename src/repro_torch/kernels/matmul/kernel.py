"""Kernel D's launch: the per-chunk GEMM of the overlap engine
(``csrc/matmul.cu``).

It replaces the Pallas kernel ``matmul_pallas`` of
``src/repro/kernels/matmul/kernel.py`` and computes the same function: the
product of bfloat16 or float32 operands accumulated in float32, rounded
once to the output dtype.  Nothing is padded.  Two kernels compute it, and
:func:`matmul_path` picks one by dtype and shape alone:

* ``"wgmma"``: bfloat16 operands whose K and N are multiples of 8, on
  Hopper's wgmma fed by TMA (the tensor map strides rows in 16-byte steps,
  so K and N must be; ragged edges are TMA's zero fill);
* ``"mma_sync"``: every other shape, and float32 operands, on the mma.sync
  kernel (bfloat16 on the tensor cores, float32 as float32 FMAs, no TF32;
  ragged edges guarded inside the kernel).

The pick is not a fallback: a call the dispatch sends to a path launches
that path's kernel or raises.
"""

from __future__ import annotations

import torch

from ..build import DTYPE_CODES, check_launch, current_stream, library
from ..common import aligned16

#: operand dtypes the kernel takes; the output may be either
MATMUL_DTYPES = (torch.float32, torch.bfloat16)
WGMMA, MMA_SYNC = "wgmma", "mma_sync"
#: the wgmma path's grid: one CTA an SM walking the output tiles (else one
#: CTA a tile, which ``chip_smoke.py`` phase 18 times beside it)
WGMMA_PERSISTENT = True


def matmul_path(K: int, N: int, dtype: torch.dtype) -> str:
    """Which kernel D runs ``(.., M, K) @ (.., K, N)`` on ``dtype`` operands:
    :data:`WGMMA` for bfloat16 with ``K`` and ``N`` positive multiples of 8,
    else :data:`MMA_SYNC`."""
    if dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0:
        return WGMMA
    return MMA_SYNC


def launch_matmul(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *,
                  path: str | None = None, persistent: bool = WGMMA_PERSISTENT) -> str:
    """One launch of kernel D: ``out[b] = x[b] @ w[b]`` for contiguous
    ``x`` (Bt, M, K), ``out`` (Bt, M, N) and ``w`` (Bt, K, N), or ``w``
    (1, K, N) shared by every ``b``.  ``path`` names the kernel (default
    :func:`matmul_path`'s pick; the mma.sync kernel takes every shape, which
    ``chip_smoke.py`` times beside the wgmma one); ``persistent`` chooses
    the wgmma path's grid.  Returns the path taken; raises on a failed
    launch."""
    Bt, M, K = x.shape
    N = w.shape[2]
    shared = w.shape[0] == 1
    lib = library()
    path = path or matmul_path(K, N, x.dtype)
    if path not in (WGMMA, MMA_SYNC):
        raise ValueError(f"kernel D has the paths {WGMMA!r} and {MMA_SYNC!r}, not {path!r}")
    with torch.cuda.device(x.device):
        if path == WGMMA:
            x, w = aligned16(x), aligned16(w)
            err = lib.smi_matmul_wgmma(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), Bt, M, N, K, int(not shared),
                DTYPE_CODES[out.dtype], int(persistent), current_stream(x))
        else:
            err = lib.smi_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), Bt, M, N, K, M * K,
                                 0 if shared else K * N, DTYPE_CODES[x.dtype],
                                 DTYPE_CODES[out.dtype], current_stream(x))
    check_launch(err, f"matmul ({path})")
    return path
