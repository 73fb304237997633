"""The Mamba2 (SSD) mixer block (``repro.models.ssm``) at any
tensor-parallel degree: prefill through kernel F, decode over a (conv
window, SSD state) cache.

Tensor-parallel layout (the reference's): the inner width and its heads are
column-sharded (``w_z``, ``w_x``, ``w_dt``, ``conv_x``, the per-head
``dt_bias``/``A_log``/``D_skip``; ``w_out`` by rows), B and C (``ngroups =
1``) replicated (``w_bc``, ``conv_bc``, the grouped norm ``gn``).  Prefill
runs on the sequence-gathered view: the two column-parallel ``ssm.in``
rings give every rank the full sequence of its z and x columns, the
``ssm.gather`` ring (or, with ``opt_shared_gather``, the ``ssm.in`` ring's
own gathered rows) feeds the B/C/dt projections, the causal convs and the
scan; the output returns to sequence shards through the row-parallel
``ssm.out``.  At tp = 1 the same code runs with a rank stack of one.

B and C are shared by every head of a sequence: the reference broadcasts
them to each head before its scan, while the port hands kernel F one row
per sequence, which the kernel reads for each of the sequence's
``BH / G`` consecutive heads (the same function).  At tp = P > 1 the head
rows are ``(P, B, nh_loc)`` flattened, so that row ``i`` belongs to
sequence row ``i // nh_loc`` of the ``(P, B)`` B/C rows.  Softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus`` is (PyTorch's ``softplus``
turns into the identity above 20).

Decode takes the replicated rows (``(P, B, 1, D)`` at tp > 1).  Every cache
leaf carries the rank dimension at tp > 1 (``conv_bc`` replicated on each
rank, as the reference's device-local caches hold it), so that a slot's
image a rank has the reference's bytes.  The row-parallel ``ssm.out`` sums
each rank's partial over the ring all-reduce as ``(D, B)`` (see
``models/mlp.py apply_mlp_replicated``): a row's sums do not depend on its
slot.  Unlike the reference, :func:`decode_ssm` writes the new conv window
and state into the cache in place and returns the same cache dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_decode_step, ssd_scan
from ..mesh.api import ParallelCtx
from ..mesh.api import PartitionSpec as PS
from ..parallel import all_reduce, column_parallel_linear, gather_sequence, row_parallel_linear
from .common import first_replica, rms_norm, silu, trunc_normal

#: rows per chunk of the prefill's SSD scan (the reference's default)
SSD_CHUNK = 128


def _dims(cfg, tp: int):
    """(inner width, heads, local heads, local inner width)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_headdim
    if not (nh % tp == 0 or tp == 1):
        raise ValueError(f"{nh} ssm heads vs tp={tp}")
    nh_loc = nh // tp if tp > 1 else nh
    return d_in, nh, nh_loc, nh_loc * cfg.ssm_headdim


def softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_ssm(generator, cfg, ctx, dtype=None):
    """Global-shape SSM params, the reference's keys and shapes: the
    in-projections ``w_z``/``w_x`` (D, d_in), ``w_bc`` (D, 2 Dst), ``w_dt``
    (D, nh); per head ``dt_bias`` 0, ``A_log`` 0 (A = -1), ``D_skip`` 1; the
    conv weights ``conv_x`` (K, d_in), ``conv_bc`` (K, 2 Dst); the grouped
    norm ``gn`` (headdim,); ``w_out`` (d_in, D).  float32 unless ``dtype``
    names another."""
    D, Dst, K = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    d_in, nh, _, _ = _dims(cfg, ctx.tp)
    dt = torch.float32 if dtype is None else dtype
    dev = generator.device
    s = D ** -0.5
    return {
        "w_z": trunc_normal(generator, (D, d_in), s, dt),
        "w_x": trunc_normal(generator, (D, d_in), s, dt),
        "w_bc": trunc_normal(generator, (D, 2 * Dst), s, dt),
        "w_dt": trunc_normal(generator, (D, nh), s, dt),
        "dt_bias": torch.zeros((nh,), dtype=dt, device=dev),
        "A_log": torch.zeros((nh,), dtype=dt, device=dev),
        "D_skip": torch.ones((nh,), dtype=dt, device=dev),
        "conv_x": trunc_normal(generator, (K, d_in), K ** -0.5, dt),
        "conv_bc": trunc_normal(generator, (K, 2 * Dst), K ** -0.5, dt),
        "gn": torch.ones((cfg.ssm_headdim,), dtype=dt, device=dev),
        "w_out": trunc_normal(generator, (d_in, D), d_in ** -0.5, dt),
    }


def ssm_specs(cfg, ctx):
    """How each SSM leaf lies over the mesh: the inner width and its heads
    split over the model axis, B/C and the grouped norm replicated."""
    m = ctx.model_axis
    return {
        "w_z": PS(None, m), "w_x": PS(None, m), "w_bc": PS(None, None),
        "w_dt": PS(None, m), "dt_bias": PS(m), "A_log": PS(m), "D_skip": PS(m),
        "conv_x": PS(None, m), "conv_bc": PS(None, None), "gn": PS(None),
        "w_out": PS(m, None),
    }


#: the leaves :func:`ssm_specs` splits over the model axis (named here, as a
#: tp = 1 context names none)
_SHARDED = frozenset(k for k, spec in ssm_specs(None, ParallelCtx(model_axis="model")).items()
                     if "model" in spec)


def _rank_stacked(p, ctx):
    """The params with a rank dimension on every sharded leaf: at tp = 1 a
    view with a rank stack of one; at tp > 1 as :func:`shard_params` lays
    them.  Returns (params, P)."""
    if ctx.tp > 1:
        return p, ctx.tp
    return {k: v.unsqueeze(0) if k in _SHARDED else v for k, v in p.items()}, 1


def _per_head(v, P: int, B: int):
    """A per-head ``(P, nh_loc)`` leaf for every ``(P, B, nh_loc)`` head row,
    as a column ``(P*B*nh_loc, 1)``."""
    return v[:, None, :].expand(P, B, v.shape[-1]).reshape(-1, 1)


def _causal_conv(x, w):
    """Depthwise causal conv.  x: (..., B, S, C), w: (K, C) or the
    rank-stacked (P, K, C) against x (P, B, S, C)."""
    K, S = w.shape[-2], x.shape[-2]
    xp = F.pad(x, (0, 0, K - 1, 0))
    taps = w.unsqueeze(-2).unsqueeze(-2) if w.dim() == 3 else w[:, None, None, :]
    return sum(xp[..., i:i + S, :] * taps.select(-4, i) for i in range(K))


def apply_ssm(p, x, cfg, ctx, *, use_kernel=None):
    """Prefill.  x: (B, S, D) at tp = 1, the sequence-sharded (P, B, S/P, D)
    at tp = P > 1 -> the same shape.  ``use_kernel`` goes to
    :func:`~repro_torch.kernels.ssd.ssd_scan` (``None``: kernel F on the
    card, the plain chunked scan on the CPU); kernel F runs once over every
    rank's P*B*nh_loc head rows."""
    p, P = _rank_stacked(p, ctx)
    xs = x if ctx.tp > 1 else x.unsqueeze(0)
    _, B, S_loc, D = xs.shape
    S = S_loc * P
    _, _, nh, d_in = _dims(cfg, ctx.tp)
    hd, Dst = cfg.ssm_headdim, cfg.ssm_state

    x2d = xs.reshape(P, B * S_loc, D)
    if ctx.opt_shared_gather:
        # one ring for the whole mixer: z overlapped, x/B/C/dt from the copy
        z, xf = column_parallel_linear(x2d, p["w_z"], ctx, tag="ssm.in", return_gathered=True)
        xin = xf @ p["w_x"]
    else:
        z = column_parallel_linear(x2d, p["w_z"], ctx, tag="ssm.in")   # (P, P*B*S_loc, d_in)
        xin = column_parallel_linear(x2d, p["w_x"], ctx, tag="ssm.in")
        xf = gather_sequence(x2d, ctx, tag="ssm.gather")
    # B/C are replicated: every rank's gathered view is the same, so once
    bc = first_replica(xf) @ p["w_bc"]                              # (P*B*S_loc, 2 Dst)
    dt_raw = xf @ p["w_dt"]                                         # (P, P*B*S_loc, nh)

    def to_bsc(t):
        """Gathered rows, shard-major (P_src, B, S_loc), to (.., B, S) order."""
        return t.unflatten(-2, (P, B, S_loc)).transpose(-4, -3).flatten(-3, -2)

    z, xin, dt_raw = to_bsc(z), to_bsc(xin), to_bsc(dt_raw)         # (P, B, S, ..)
    bc = silu(_causal_conv(to_bsc(bc), p["conv_bc"]))               # (B, S, 2 Dst)
    xin = silu(_causal_conv(xin, p["conv_x"]))
    dt = softplus(dt_raw + p["dt_bias"][:, None, None, :])          # (P, B, S, nh)

    # per-head SSD scan over (P, B, nh) head rows; B and C one row per (P, B)
    # sequence, shared by its heads
    xh = xin.unflatten(-1, (nh, hd)).permute(0, 1, 3, 2, 4).reshape(P * B * nh, S, hd)
    dth = dt.permute(0, 1, 3, 2).reshape(P * B * nh, S)
    Bm = bc[..., :Dst].expand(P, B, S, Dst).reshape(P * B, S, Dst)
    Cm = bc[..., Dst:].expand(P, B, S, Dst).reshape(P * B, S, Dst)
    Ah = _per_head(-torch.exp(p["A_log"]), P, B)
    y = ssd_scan(xh, dth, Bm, Cm, Ah, chunk=SSD_CHUNK, use_kernel=use_kernel)
    # per-head skip connection
    y = y + _per_head(p["D_skip"], P, B)[..., None] * xh
    y = rms_norm(y.reshape(P, B, nh, S, hd), p["gn"], cfg.norm_eps)  # grouped norm per head
    y = y.permute(0, 1, 3, 2, 4).reshape(P, B, S, d_in) * silu(z)
    # row-parallel out-projection, reduce-scattered back to sequence shards
    y2d = y.reshape(P, B, P, S_loc, d_in).transpose(1, 2).reshape(P, P * B * S_loc, d_in)
    out = row_parallel_linear(y2d, p["w_out"], ctx, tag="ssm.out").reshape(P, B, S_loc, D)
    return out if ctx.tp > 1 else out[0]


# ------------------------------------------------------------------ decode


def init_ssm_cache(cfg, B: int, ctx, dtype, device=None):
    """The conv windows ``conv_x`` (B, K-1, d_in_loc) and ``conv_bc`` (B,
    K-1, 2 Dst) in ``dtype``, the SSD ``state`` (B, nh_loc, Dst, headdim) in
    float32; zeros.  At tp = P > 1 every leaf gains the leading rank
    dimension (``conv_bc`` a replica a rank)."""
    _, _, nh, d_in = _dims(cfg, ctx.tp)
    K = cfg.ssm_conv
    lead = (ctx.tp,) if ctx.tp > 1 else ()
    return {
        "conv_x": torch.zeros(lead + (B, K - 1, d_in), dtype=dtype, device=device),
        "conv_bc": torch.zeros(lead + (B, K - 1, 2 * cfg.ssm_state), dtype=dtype,
                               device=device),
        "state": torch.zeros(lead + (B, nh, cfg.ssm_state, cfg.ssm_headdim),
                             dtype=torch.float32, device=device),
    }


def _bax(ctx):
    """The batch axes of a leaf split over the data axes, or ``None``."""
    if not ctx.batch_axes:
        return None
    return ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]


def ssm_cache_specs(ctx, shard_batch: bool = True):
    """How the SSM decode cache lies over the mesh: ``conv_x`` split by
    channels and ``state`` by heads over the model axis, ``conv_bc``
    replicated; the batch over the data axes when ``shard_batch``."""
    m = ctx.model_axis
    b = _bax(ctx) if shard_batch else None
    return {"conv_x": PS(b, None, m), "conv_bc": PS(b, None, None),
            "state": PS(b, m, None, None)}


def decode_ssm(p, x, cache, cfg, ctx):
    """One decode step.  x: (B, 1, D), at tp = P > 1 the rank-stacked
    (P, B, 1, D) of the replicated rows.  Shifts the new token's inputs into
    the conv windows and advances the state, in place; returns (y like x,
    cache)."""
    p, P = _rank_stacked(p, ctx)
    c = cache if ctx.tp > 1 else {k: v.unsqueeze(0) for k, v in cache.items()}
    B = x.shape[-3]
    _, _, nh, d_in = _dims(cfg, ctx.tp)
    hd, Dst = cfg.ssm_headdim, cfg.ssm_state

    x2d = x.reshape(P, B, x.shape[-1])
    z = x2d @ p["w_z"]
    xin = x2d @ p["w_x"]
    bc = x2d @ p["w_bc"]
    dt_raw = x2d @ p["w_dt"]

    cx = torch.cat([c["conv_x"], xin[:, :, None]], dim=2)            # (P, B, K, d_in)
    cb = torch.cat([c["conv_bc"], bc[:, :, None]], dim=2)
    xin_c = silu(torch.einsum("pbkc,pkc->pbc", cx, p["conv_x"]))
    bc_c = silu(torch.einsum("pbkc,kc->pbc", cb, p["conv_bc"]))
    dt = softplus(dt_raw + p["dt_bias"][:, None, :])                 # (P, B, nh)

    xh = xin_c.reshape(P * B * nh, hd)
    Bh = bc_c[..., None, :Dst].expand(P, B, nh, Dst).reshape(P * B * nh, Dst)
    Ch = bc_c[..., None, Dst:].expand(P, B, nh, Dst).reshape(P * B * nh, Dst)
    Ah = _per_head(-torch.exp(p["A_log"]), P, B)
    state, y = ssd_decode_step(c["state"].reshape(P * B * nh, Dst, hd), xh, dt.reshape(-1), Bh,
                               Ch, Ah)
    y = y + _per_head(p["D_skip"], P, B) * xh
    y = rms_norm(y.reshape(P, B, nh, hd), p["gn"], cfg.norm_eps)
    y = y.reshape(P, B, d_in) * silu(z)
    # each rank's partial out-projection, summed over the ring as (D, B)
    out = all_reduce((y @ p["w_out"]).transpose(-1, -2), ctx, tag="ssm.out").transpose(-1, -2)
    c["conv_x"].copy_(cx[:, :, 1:])
    c["conv_bc"].copy_(cb[:, :, 1:])
    c["state"].copy_(state.reshape(P, B, nh, Dst, hd))
    return out.reshape(x.shape[:-1] + (out.shape[-1],)), cache
