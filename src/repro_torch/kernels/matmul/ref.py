"""The plain PyTorch version of kernel D (``repro.kernels.matmul.ref``):
the product accumulated in float32, cast once to ``out_dtype`` (x's dtype
unless named)."""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ w`` with float32 accumulation; batched operands broadcast as
    ``torch.matmul`` broadcasts them."""
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)
