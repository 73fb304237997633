"""Shared kernel utilities: padding to a block multiple, ceiling division
(the parts of ``repro.kernels.common`` the port's wrappers use), and the
16-byte alignment TMA needs."""

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
