"""The Mamba2 (SSD) mixer block (``repro.models.ssm``) at tensor-parallel
degree 1: prefill through kernel F, decode over a (conv window, SSD state)
cache.

B and C (``ngroups = 1``, as in the reference) are shared by every head of
a sequence: the reference broadcasts them to each head before its scan,
while the port hands kernel F the one row per sequence, which the kernel
reads for each of the sequence's heads (the same function).  Softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus`` is (PyTorch's ``softplus``
turns into the identity above 20).  Unlike the reference, :func:`decode_ssm`
writes the new conv window and state into the cache in place and returns
the same cache dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_decode_step, ssd_scan
from ..parallel import all_reduce, column_parallel_linear, gather_sequence, row_parallel_linear
from .common import rms_norm, silu, trunc_normal

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
    """SSM params, the reference's keys and shapes: the in-projections
    ``w_z``/``w_x`` (D, d_in), ``w_bc`` (D, 2 Dst), ``w_dt`` (D, nh); per
    head ``dt_bias`` 0, ``A_log`` 0 (A = -1), ``D_skip`` 1; the conv weights
    ``conv_x`` (K, d_in), ``conv_bc`` (K, 2 Dst); the grouped norm ``gn``
    (headdim,); ``w_out`` (d_in, D).  float32 unless ``dtype`` names
    another."""
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


def _causal_conv(x, w):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))


def apply_ssm(p, x, cfg, ctx, *, use_kernel=None):
    """Prefill.  x: (B, S, D) -> same.  ``use_kernel`` goes to
    :func:`~repro_torch.kernels.ssd.ssd_scan` (``None``: kernel F on the
    card, the plain chunked scan on the CPU)."""
    B, S, D = x.shape
    _, _, nh, d_in = _dims(cfg, ctx.tp)
    hd, Dst = cfg.ssm_headdim, cfg.ssm_state

    x2d = x.reshape(B * S, D)
    z = column_parallel_linear(x2d, p["w_z"], ctx, tag="ssm.in").reshape(B, S, d_in)
    xin = column_parallel_linear(x2d, p["w_x"], ctx, tag="ssm.in").reshape(B, S, d_in)
    xf = gather_sequence(x2d, ctx, tag="ssm.gather")
    bc = (xf @ p["w_bc"]).reshape(B, S, 2 * Dst)
    dt_raw = (xf @ p["w_dt"]).reshape(B, S, nh)

    xin = silu(_causal_conv(xin, p["conv_x"]))
    bc = silu(_causal_conv(bc, p["conv_bc"]))
    dt = softplus(dt_raw + p["dt_bias"])                           # (B, S, nh)

    # per-head SSD scan; B and C one row per sequence, shared by its heads
    xh = xin.reshape(B, S, nh, hd).transpose(1, 2).reshape(B * nh, S, hd)
    dth = dt.transpose(1, 2).reshape(B * nh, S)
    A = -torch.exp(p["A_log"])                                     # (nh,)
    Ah = A[None, :].expand(B, nh).reshape(B * nh, 1)
    y = ssd_scan(xh, dth, bc[..., :Dst], bc[..., Dst:], Ah, chunk=SSD_CHUNK,
                 use_kernel=use_kernel)
    # per-head skip connection
    y = y + p["D_skip"][None, :].expand(B, nh).reshape(B * nh, 1, 1) * xh
    y = rms_norm(y.reshape(B, nh, S, hd), p["gn"], cfg.norm_eps)   # grouped norm per head
    y = y.transpose(1, 2).reshape(B, S, d_in) * silu(z)
    out = row_parallel_linear(y.reshape(B * S, d_in), p["w_out"], ctx, tag="ssm.out")
    return out.reshape(B, S, D)


# ------------------------------------------------------------------ decode


def init_ssm_cache(cfg, B: int, ctx, dtype, device=None):
    """The conv windows ``conv_x`` (B, K-1, d_in) and ``conv_bc`` (B, K-1,
    2 Dst) in ``dtype``, the SSD ``state`` (B, nh, Dst, headdim) in float32;
    zeros."""
    _, _, nh, d_in = _dims(cfg, ctx.tp)
    K = cfg.ssm_conv
    return {
        "conv_x": torch.zeros((B, K - 1, d_in), dtype=dtype, device=device),
        "conv_bc": torch.zeros((B, K - 1, 2 * cfg.ssm_state), dtype=dtype, device=device),
        "state": torch.zeros((B, nh, cfg.ssm_state, cfg.ssm_headdim), dtype=torch.float32,
                             device=device),
    }


def decode_ssm(p, x, cache, cfg, ctx):
    """One decode step.  x: (B, 1, D).  Shifts the new token's inputs into
    the conv windows and advances the state, in place; returns (y (B, 1, D),
    cache)."""
    B = x.shape[0]
    _, _, nh, d_in = _dims(cfg, ctx.tp)
    hd, Dst = cfg.ssm_headdim, cfg.ssm_state

    x2d = x.reshape(B, -1)
    z = x2d @ p["w_z"]
    xin = x2d @ p["w_x"]
    bc = x2d @ p["w_bc"]
    dt_raw = x2d @ p["w_dt"]

    cx = torch.cat([cache["conv_x"], xin[:, None]], dim=1)        # (B, K, d_in)
    cb = torch.cat([cache["conv_bc"], bc[:, None]], dim=1)
    xin_c = silu(torch.einsum("bkc,kc->bc", cx, p["conv_x"]))
    bc_c = silu(torch.einsum("bkc,kc->bc", cb, p["conv_bc"]))
    Bm, Cm = bc_c[..., :Dst], bc_c[..., Dst:]
    dt = softplus(dt_raw + p["dt_bias"])                           # (B, nh)

    xh = xin_c.reshape(B * nh, hd)
    Bh = Bm[:, None].expand(B, nh, Dst).reshape(B * nh, Dst)
    Ch = Cm[:, None].expand(B, nh, Dst).reshape(B * nh, Dst)
    Ah = (-torch.exp(p["A_log"]))[None, :].expand(B, nh).reshape(B * nh, 1)
    state, y = ssd_decode_step(cache["state"].reshape(B * nh, Dst, hd), xh, dt.reshape(B * nh),
                               Bh, Ch, Ah)
    y = y + p["D_skip"][None, :].expand(B, nh).reshape(B * nh, 1) * xh
    y = rms_norm(y.reshape(B, nh, 1, hd), p["gn"], cfg.norm_eps)
    y = y.reshape(B, d_in) * silu(z)
    out = all_reduce(y @ p["w_out"], ctx, tag="ssm.out")
    cache["conv_x"].copy_(cx[:, 1:])
    cache["conv_bc"].copy_(cb[:, 1:])
    cache["state"].copy_(state.reshape(B, nh, Dst, hd))
    return out.reshape(B, 1, -1), cache
