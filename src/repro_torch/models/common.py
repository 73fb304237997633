"""Shared model pieces (``repro.models.common``): initialisation, norms,
RoPE, activations, and the small pytree helpers the port uses in place of
``jax.tree_util`` (nested dicts and tuples; dict keys in sorted order, as
JAX flattens them)."""

from __future__ import annotations

import math

import torch

from ..kernels.common import on_calling_thread


def trunc_normal(generator: torch.Generator, shape, scale: float, dtype=torch.float32):
    """``scale`` times a standard normal truncated to [-2, 2], drawn on the
    generator's device by inverting the normal CDF over the uniform band
    that maps onto [-2, 2] (on the CPU, on the calling thread: the same bits
    on every call)."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    x = on_calling_thread(torch.erfinv, u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(scale).to(dtype)


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def _rope_freqs(D: int, theta: float, device) -> torch.Tensor:
    half = D // 2
    return torch.pow(theta, -torch.arange(0, half, dtype=torch.float32, device=device) / half)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def rope(x, pos, theta: float = 10_000.0):
    """Rotate-half RoPE.  x: (..., S, H, D); pos: (S,) absolute positions."""
    ang = pos.float()[:, None] * _rope_freqs(x.shape[-1], theta, x.device)[None, :]  # (S, half)
    return _rotate(x, torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :])


def rope_batched(x, pos, theta: float = 10_000.0):
    """Rotate-half RoPE for single-token decode with a per-row position.
    x: (B, 1, H, D); pos: (B,).  Equal to :func:`rope` when every row sits
    at the same position (the wave-decoding case)."""
    ang = pos.float()[:, None] * _rope_freqs(x.shape[-1], theta, x.device)[None, :]  # (B, half)
    return _rotate(x, torch.cos(ang)[:, None, None, :], torch.sin(ang)[:, None, None, :])


def silu(x):
    return x * torch.sigmoid(x)


# -------------------------------------------------------------- pytrees


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and tuples (``None`` stays)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path=()):
    """``[(path, leaf), ...]`` in JAX's flatten order: dict keys sorted,
    tuples by index; a path holds the keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree) for kv in tree_leaves_with_path(t, path + (i,))]
    return [] if tree is None else [(path, tree)]
