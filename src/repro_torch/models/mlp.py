"""Feed-forward blocks (``repro.models.mlp``): SwiGLU and GELU, as
column- then row-parallel projections (one matrix product each at tp = 1)."""

from __future__ import annotations

import torch.nn.functional as F

from ..parallel import all_reduce, column_parallel_linear, row_parallel_linear
from .common import silu, trunc_normal


def init_mlp(generator, cfg, ctx, d_ff: int | None = None, dtype=None):
    """MLP params: ``w_gate`` (SwiGLU only), ``w_up`` (D, ff), ``w_down``
    (ff, D), float32 unless ``dtype`` names another."""
    D = cfg.d_model
    ff = d_ff or cfg.d_ff
    kw = {} if dtype is None else {"dtype": dtype}
    p = {}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = trunc_normal(generator, (D, ff), D ** -0.5, **kw)
    p["w_up"] = trunc_normal(generator, (D, ff), D ** -0.5, **kw)
    p["w_down"] = trunc_normal(generator, (ff, D), ff ** -0.5, **kw)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def apply_mlp(p, x, cfg, ctx):
    """x: (B, S, D) -> same."""
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    if cfg.mlp_type == "swiglu":
        g = column_parallel_linear(x2d, p["w_gate"], ctx, tag="tp.mlp.up")
        u = column_parallel_linear(x2d, p["w_up"], ctx, tag="tp.mlp.up")
        h = silu(g) * u
    else:
        h = _gelu(column_parallel_linear(x2d, p["w_up"], ctx, tag="tp.mlp.up"))
    y = row_parallel_linear(h, p["w_down"], ctx, tag="tp.mlp.down")
    return y.reshape(B, S, D)


def apply_mlp_replicated(p, x, cfg, ctx):
    """Decode path: x (B, 1, D)."""
    B = x.shape[0]
    x2d = x.reshape(B, -1)
    if cfg.mlp_type == "swiglu":
        h = silu(x2d @ p["w_gate"]) * (x2d @ p["w_up"])
    else:
        h = _gelu(x2d @ p["w_up"])
    y = all_reduce(h @ p["w_down"], ctx, tag="tp.mlp.down")
    return y.reshape(B, 1, -1)
