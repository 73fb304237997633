"""Kernel D's launch: the per-chunk GEMM of the overlap engine
(``csrc/matmul.cu``).

It replaces the Pallas kernel ``matmul_pallas`` of
``src/repro/kernels/matmul/kernel.py`` and computes the same function: the
product of bfloat16 or float32 operands accumulated in float32, rounded
once to the output dtype.  Ragged edges are guarded inside the kernel, so
nothing is padded; bfloat16 runs on the tensor cores, float32 as float32
FMAs (no TF32).
"""

from __future__ import annotations

import torch

from ..build import DTYPE_CODES, check_launch, current_stream, library

#: operand dtypes the kernel takes; the output may be either
MATMUL_DTYPES = (torch.float32, torch.bfloat16)


def launch_matmul(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor):
    """One launch of kernel D: ``out[b] = x[b] @ w[b]`` for contiguous
    ``x`` (Bt, M, K), ``out`` (Bt, M, N) and ``w`` (Bt, K, N), or ``w``
    (1, K, N) shared by every ``b``.  Raises on a failed launch."""
    Bt, M, K = x.shape
    N = w.shape[2]
    w_stride = 0 if w.shape[0] == 1 else K * N
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.smi_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), Bt, M, N, K, M * K,
                             w_stride, DTYPE_CODES[x.dtype], DTYPE_CODES[out.dtype],
                             current_stream(x))
    check_launch(err, "matmul")
