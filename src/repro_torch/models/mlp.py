"""Feed-forward blocks (``repro.models.mlp``): SwiGLU and GELU, as
column- then row-parallel projections with the collectives streamed through
the GEMMs (one matrix product each at tp = 1).  The up-projections are split
by columns of ``d_ff``, the down-projection by rows."""

from __future__ import annotations

import torch.nn.functional as F

from ..mesh.api import PartitionSpec as PS
from ..parallel import all_reduce, column_parallel_linear, row_parallel_linear
from .common import silu, trunc_normal


def init_mlp(generator, cfg, ctx, d_ff: int | None = None, dtype=None):
    """Global-shape MLP params: ``w_gate`` (SwiGLU only), ``w_up`` (D, ff),
    ``w_down`` (ff, D), float32 unless ``dtype`` names another; ``ff`` must
    divide by the TP degree."""
    D = cfg.d_model
    ff = d_ff or cfg.d_ff
    if ff % ctx.tp:
        raise ValueError(f"d_ff={ff} not divisible by tp={ctx.tp}")
    kw = {} if dtype is None else {"dtype": dtype}
    p = {}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = trunc_normal(generator, (D, ff), D ** -0.5, **kw)
    p["w_up"] = trunc_normal(generator, (D, ff), D ** -0.5, **kw)
    p["w_down"] = trunc_normal(generator, (ff, D), ff ** -0.5, **kw)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_specs(cfg, ctx):
    m = ctx.model_axis
    sp = {"w_up": PS(None, m), "w_down": PS(m, None)}
    if cfg.mlp_type == "swiglu":
        sp["w_gate"] = PS(None, m)
    return sp


def apply_mlp(p, x, cfg, ctx):
    """x: (B, S, D) at tp = 1, the sequence-sharded (P, B, S/P, D) at
    tp = P > 1 -> the same shape."""
    lead, (B, S, D) = x.shape[:-3], x.shape[-3:]
    x2d = x.reshape(lead + (B * S, D))
    if cfg.mlp_type == "swiglu":
        if ctx.opt_shared_gather:
            g, xf = column_parallel_linear(x2d, p["w_gate"], ctx, tag="tp.mlp.up",
                                           return_gathered=True)
            u = xf @ p["w_up"]  # ring-free: reuse the gathered input
        else:
            g = column_parallel_linear(x2d, p["w_gate"], ctx, tag="tp.mlp.up")
            u = column_parallel_linear(x2d, p["w_up"], ctx, tag="tp.mlp.up")
        h = silu(g) * u
    else:
        h = _gelu(column_parallel_linear(x2d, p["w_up"], ctx, tag="tp.mlp.up"))
    y = row_parallel_linear(h, p["w_down"], ctx, tag="tp.mlp.down")
    return y.reshape(lead + (B, S, D))


def apply_mlp_replicated(p, x, cfg, ctx):
    """Decode path: x (B, 1, D), at tp = P > 1 the rank-stacked (P, B, 1, D)
    of the replicated rows.  Each rank's partial down-projection is summed
    by a ring all-reduce over the tagged ``tp.mlp.down`` channel (kernel A
    folds its reduce-scatter steps on the ``fused`` wire).

    The ring all-reduce sums each of its P chunks of the flattened payload
    in another rank order.  The reference flattens (B, D), so a row's sums
    depend on its slot, and a request's tokens on where it was admitted
    (in bfloat16, near-ties flip).  The port hands the ring (D, B): every
    row's element d then lies in the same chunk whatever its slot, and the
    step is row-independent, with the reference's bytes and steps."""
    x2d = x.reshape(x.shape[:-2] + (x.shape[-1],))
    if cfg.mlp_type == "swiglu":
        h = silu(x2d @ p["w_gate"]) * (x2d @ p["w_up"])
    else:
        h = _gelu(x2d @ p["w_up"])
    y = all_reduce((h @ p["w_down"]).transpose(-1, -2), ctx, tag="tp.mlp.down")
    return y.transpose(-1, -2).unsqueeze(-2)
