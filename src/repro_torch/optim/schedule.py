"""Learning-rate schedules (``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, base_lr, warmup_steps, total_steps, min_ratio=0.1):
    """A linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``; ``step`` an integer
    tensor, the rate a float32 0-dim tensor on its device."""
    t = torch.as_tensor(step).float()
    warm = base_lr * torch.clamp(t / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((t - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(t < warmup_steps, warm, base_lr * cos)
