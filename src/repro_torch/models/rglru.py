"""The RG-LRU recurrent block of RecurrentGemma / Griffin
(``repro.models.rglru``) at any tensor-parallel degree.

Block: x -> [linear -> causal conv -> RG-LRU] * gelu(linear) -> out
projection.  The gates are per channel (diagonal), as in the reference.
The linear recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * u_t)``
runs over the gathered sequence as the odd/even recursion that
``jax.lax.associative_scan`` computes (:func:`linear_scan`): log2(S) levels
of whole-tensor slices and combines, in float32, with the reference's
association order.  A log-space cumulative sum would overflow (``log a``
reaches about -10 a step) and a loop over positions would launch once a
position.

Tensor-parallel layout (the reference's): the recurrence width
``lru_width`` is column-sharded (``w_branch``, ``w_gate``, ``conv`` and the
gate vectors; ``w_out`` by rows).  Prefill runs the two column-parallel
``ssm.in`` rings (or, with ``opt_shared_gather``, one ring and the gate
projection from its gathered rows), reorders the gathered
``(P_src, B, S_loc)`` rows into ``(B, S)``, and returns to sequence shards
through the row-parallel ``ssm.out``.  At tp = 1 the same code runs with a
rank stack of one.

Decode carries the conv window ``conv`` (B, K-1, W_loc) in the model dtype
and the state ``h`` (B, W_loc) in float32, both rank-stacked at tp > 1 and
updated in place.  The row-parallel ``ssm.out`` sums each rank's partial
over the ring all-reduce as ``(D, B)`` (see ``models/mlp.py
apply_mlp_replicated``): a row's sums do not depend on its slot.  The
reference all-reduces the flattened ``(B, D)``, whose ring sums a row in an
order that follows its slot.
"""

from __future__ import annotations

import torch

from ..mesh.api import PartitionSpec as PS
from ..parallel import all_reduce, column_parallel_linear, row_parallel_linear
from .common import trunc_normal
from .mlp import _gelu
from .ssm import _bax, _causal_conv, softplus

#: Griffin's fixed gate sharpness
_C_GATE = 8.0


def _w_loc(cfg, tp: int) -> int:
    w = cfg.lru_width or cfg.d_model
    if w % tp:
        raise ValueError(f"lru_width {w} not divisible by tp={tp}")
    return w // tp


def init_rglru(generator, cfg, ctx, dtype=None):
    """Global-shape RG-LRU params, the reference's keys and shapes: the
    in-projections ``w_branch``/``w_gate`` (D, W), the conv ``conv`` (K, W),
    the decay ``lam`` 1 and the gate vectors ``wa``, ``ba``, ``wi``, ``bi``
    0 (W,), the out-projection ``w_out`` (W, D).  float32 unless ``dtype``
    names another."""
    D, K = cfg.d_model, cfg.ssm_conv
    W = cfg.lru_width or D
    _w_loc(cfg, ctx.tp)
    dt = torch.float32 if dtype is None else dtype
    dev = generator.device
    s = D ** -0.5
    p = {
        "w_branch": trunc_normal(generator, (D, W), s, dt),
        "w_gate": trunc_normal(generator, (D, W), s, dt),
        "conv": trunc_normal(generator, (K, W), K ** -0.5, dt),
        "lam": torch.ones((W,), dtype=dt, device=dev),
    }
    for k in ("wa", "ba", "wi", "bi"):
        p[k] = torch.zeros((W,), dtype=dt, device=dev)
    p["w_out"] = trunc_normal(generator, (W, D), W ** -0.5, dt)
    return p


def rglru_specs(cfg, ctx):
    """How each RG-LRU leaf lies over the mesh: the recurrence width split
    over the model axis (``w_out`` by rows)."""
    m = ctx.model_axis
    sp = {k: PS(m) for k in ("lam", "wa", "ba", "wi", "bi")}
    sp.update(w_branch=PS(None, m), w_gate=PS(None, m), conv=PS(None, m), w_out=PS(m, None))
    return sp


def _gates(p, u):
    """u: (P, ..., W_loc) float32 conv output.  Returns (a, b) of
    ``h = a h_prev + b``, float32."""
    def vec(k):
        v = p[k]
        return v.reshape(v.shape[:1] + (1,) * (u.dim() - 2) + v.shape[-1:])

    r = torch.sigmoid(vec("wa") * u + vec("ba"))
    i = torch.sigmoid(vec("wi") * u + vec("bi"))
    log_a = -_C_GATE * softplus(vec("lam")) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u)
    return a, b


def linear_scan(a, b, dim: int = -2):
    """``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``) along ``dim``, as
    ``jax.lax.associative_scan(combine, (a, b), axis=dim)[1]`` computes it
    with ``combine((a_l, b_l), (a_r, b_r)) = (a_l a_r, a_r b_l + b_r)``: the
    same pairs combined in the same order, one level of the recursion at a
    time over whole tensors."""
    dim = dim % a.dim()

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    def combine(left, right):
        (al, bl), (ar, br) = left, right
        return al * ar, ar * bl + br

    def interleave(even, odd):
        n = even.shape[dim] + odd.shape[dim]
        out = even.new_empty(even.shape[:dim] + (n,) + even.shape[dim + 1:])
        out[(slice(None),) * dim + (slice(0, None, 2),)] = even
        out[(slice(None),) * dim + (slice(1, None, 2),)] = odd
        return out

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        odd = scan(combine([sl(e, 0, -1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems]))
        left = odd if n % 2 else [sl(e, 0, -1) for e in odd]
        even = combine(left, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
        return [interleave(e, o) for e, o in zip(even, odd)]

    return scan([a, b])[1]


def _rank_stacked(tree, ctx):
    """``tree`` with a rank stack of one on every leaf at tp = 1 (every
    RG-LRU param and cache leaf is sharded); as given at tp > 1, where
    :func:`~repro_torch.interop.shard_params` laid it so."""
    return tree if ctx.tp > 1 else {k: v.unsqueeze(0) for k, v in tree.items()}


def apply_rglru(p, x, cfg, ctx):
    """Prefill.  x: (B, S, D) at tp = 1, the sequence-sharded (P, B, S/P, D)
    at tp = P > 1 -> the same shape."""
    p, P = _rank_stacked(p, ctx), ctx.tp
    xs = x if ctx.tp > 1 else x.unsqueeze(0)
    _, B, S_loc, D = xs.shape

    x2d = xs.reshape(P, B * S_loc, D)
    if ctx.opt_shared_gather:
        br, xf = column_parallel_linear(x2d, p["w_branch"], ctx, tag="ssm.in",
                                        return_gathered=True)
        gt = xf @ p["w_gate"]                                       # ring-free
    else:
        br = column_parallel_linear(x2d, p["w_branch"], ctx, tag="ssm.in")
        gt = column_parallel_linear(x2d, p["w_gate"], ctx, tag="ssm.in")

    def to_bsc(t):
        """Gathered rows, shard-major (P_src, B, S_loc), to (.., B, S) order."""
        return t.unflatten(-2, (P, B, S_loc)).transpose(-4, -3).flatten(-3, -2)

    br, gt = to_bsc(br), to_bsc(gt)                                 # (P, B, S, W_loc)
    u = _causal_conv(br, p["conv"])
    a, b = _gates(p, u.float())
    h = linear_scan(a, b, dim=-2)
    y = h.to(x.dtype) * _gelu(gt)
    # row-parallel out-projection over the (P_dst, B, S_loc) row order
    y2d = y.unflatten(-2, (P, S_loc)).transpose(1, 2).reshape(P, P * B * S_loc, -1)
    out = row_parallel_linear(y2d, p["w_out"], ctx, tag="ssm.out").reshape(P, B, S_loc, D)
    return out if ctx.tp > 1 else out[0]


# ------------------------------------------------------------------ decode


def init_rglru_cache(cfg, B: int, ctx, dtype, device=None):
    """The conv window ``conv`` (B, K-1, W_loc) in ``dtype`` and the state
    ``h`` (B, W_loc) in float32; zeros.  At tp = P > 1 each leaf gains the
    leading rank dimension."""
    W_loc = _w_loc(cfg, ctx.tp)
    lead = (ctx.tp,) if ctx.tp > 1 else ()
    return {
        "conv": torch.zeros(lead + (B, cfg.ssm_conv - 1, W_loc), dtype=dtype, device=device),
        "h": torch.zeros(lead + (B, W_loc), dtype=torch.float32, device=device),
    }


def rglru_cache_specs(ctx, shard_batch: bool = True):
    """How the RG-LRU decode cache lies over the mesh: the width split over
    the model axis, the batch over the data axes when ``shard_batch``."""
    m = ctx.model_axis
    b = _bax(ctx) if shard_batch else None
    return {"conv": PS(b, None, m), "h": PS(b, m)}


def decode_rglru(p, x, cache, cfg, ctx):
    """One decode step.  x: (B, 1, D), at tp = P > 1 the rank-stacked
    (P, B, 1, D) of the replicated rows.  Shifts the new input into the conv
    window and advances the state, in place; returns (y like x, cache)."""
    p, c, P = _rank_stacked(p, ctx), _rank_stacked(cache, ctx), ctx.tp
    B = x.shape[-3]
    x2d = x.reshape(P, B, x.shape[-1])
    br = x2d @ p["w_branch"]
    gt = x2d @ p["w_gate"]
    cx = torch.cat([c["conv"], br[:, :, None]], dim=2)               # (P, B, K, W_loc)
    u = torch.einsum("pbkc,pkc->pbc", cx, p["conv"])
    a, b = _gates(p, u.float())
    h = a * c["h"] + b
    y = h.to(x.dtype) * _gelu(gt)
    # each rank's partial out-projection, summed over the ring as (D, B)
    out = all_reduce((y @ p["w_out"]).transpose(-1, -2), ctx, tag="ssm.out").transpose(-1, -2)
    c["conv"].copy_(cx[:, :, 1:])
    c["h"].copy_(h)
    return out.reshape(x.shape[:-1] + (out.shape[-1],)), cache
