"""Mixture-of-Experts with expert parallelism over the model axis
(``repro.models.moe``).

The experts are sharded over the model axis (``E_loc = E / tp`` a rank).
The MoE runs on the replicated token view (decode) or the sequence-gathered
one (prefill: the ``ep.dispatch`` ring gathers the sequence-sharded stream).
Each rank routes every token it sees (the router replicated), dispatches
the tokens that chose its experts into an ``(E_loc, C, D)`` buffer by
capacity (overflowing tokens are dropped, the standard MoE trade-off),
runs its expert GEMMs and combines the weighted outputs into a partial
``(T, D)``; one reduction over the model axis merges the partials (prefill:
the ``ep.combine`` reduce-scatter back onto sequence shards; decode: the
``ep.combine`` all-reduce).

Rank-stacked, the per-rank routing of the reference is computed once: every
rank's gathered view holds the same bits (asserted on the device by
:func:`~repro_torch.models.common.first_replica`), so every rank would make
the same top-k choice for every token, and a token's place in its expert's queue
(its arrival among the tokens that chose that expert) does not depend on
which rank owns the expert.  The P ranks' ``(E_loc, C, D)`` buffers are
then the one ``(E, C, D)`` buffer of all experts, split by rank, which the
``(P, E_loc, ...)`` expert weights of :func:`~repro_torch.interop.
shard_params` multiply without a copy.

Two orders are fixed, on the CPU and on the card alike.  A token's
contributions are summed in ascending expert order (the reference's stable
sort by expert), one add at a time in the activation dtype, each rank over
its own experts; atomics (``index_add_``) would make the bits vary run to
run.  The decode all-reduce sums each rank's partial as ``(D, B)`` (see
``models/mlp.py apply_mlp_replicated``), so that a row's sums do not depend
on its slot.
"""

from __future__ import annotations

import torch

from ..mesh.api import PartitionSpec as PS
from ..parallel import all_reduce, moe_combine, moe_dispatch
from .common import first_replica, silu, trunc_normal
from .mlp import apply_mlp, apply_mlp_replicated, init_mlp, mlp_specs


def _e_loc(E: int, tp: int) -> int:
    """Experts a rank holds."""
    if not (E % tp == 0 or tp == 1):
        raise ValueError(f"{E} experts not divisible by tp={tp}")
    return E // tp if tp > 1 else E


def init_moe(generator, cfg, ctx, dtype=None):
    """Global-shape MoE params: ``router`` (D, E), the experts' ``w_gate``
    and ``w_up`` (E, D, ffe) and ``w_down`` (E, ffe, D), and the ``shared``
    expert (an MLP of ``d_ff``) where the config has one; float32 unless
    ``dtype`` names another (each leaf drawn in float32 and cast)."""
    D, E, ffe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    _e_loc(E, ctx.tp)
    kw = {} if dtype is None else {"dtype": dtype}
    p = {
        "router": trunc_normal(generator, (D, E), D ** -0.5, **kw),
        "w_gate": trunc_normal(generator, (E, D, ffe), D ** -0.5, **kw),
        "w_up": trunc_normal(generator, (E, D, ffe), D ** -0.5, **kw),
        "w_down": trunc_normal(generator, (E, ffe, D), ffe ** -0.5, **kw),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(generator, cfg, ctx, d_ff=cfg.d_ff, dtype=dtype)
    return p


def moe_specs(cfg, ctx):
    """How each MoE leaf lies over the mesh: the experts split over the
    model axis, the router replicated, the shared expert as an MLP."""
    m = ctx.model_axis
    sp = {"router": PS(None, None), "w_gate": PS(m, None, None), "w_up": PS(m, None, None),
          "w_down": PS(m, None, None)}
    if cfg.shared_expert:
        sp["shared"] = mlp_specs(cfg, ctx)
    return sp


def capacity(cfg, T: int) -> int:
    """Tokens an expert takes from ``T`` (the reference's ``C``)."""
    return int(max(8, round(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts)))


def route(router, xf, cfg):
    """Top-k routing of the token view ``xf`` (T, D): the renormalised gate
    values (T, k) float32, the chosen experts (T, k) and the Switch-style
    load-balancing loss ``E * sum_e f_e p_e``."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax((xf @ router).float(), dim=-1)             # (T, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # each expert's share of the choices; counted by an add of ones (exact in
    # float32), as ``bincount`` would need the host to read the largest index
    ones = torch.ones(T * k, dtype=torch.float32, device=xf.device)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, gate_idx.reshape(-1), ones) / (T * k)
    aux = E * (probs.mean(dim=0) * ce).sum()
    return gate_vals, gate_idx, aux


def _dispatch_compute(p, xf, cfg, ctx):
    """xf: the token view (T, D), at tp = P > 1 every rank's copy (P, T, D).
    Returns every rank's expert-group partial output, (T, D) at tp = 1,
    (P, T, D) at tp > 1, and the load-balancing loss."""
    tp = ctx.tp
    x0 = first_replica(xf) if tp > 1 else xf
    T, D = x0.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = _e_loc(E, tp)
    C = capacity(cfg, T)
    dev = x0.device

    gate_vals, gate_idx, aux = route(p["router"], x0, cfg)

    # each assignment's place in its expert's queue, by arrival (token-major)
    e_flat = gate_idx.reshape(-1)                                    # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev, dtype=e_sorted.dtype))
    pos = torch.empty_like(e_flat)
    pos[order] = torch.arange(T * k, device=dev) - starts[e_sorted]
    keep = pos < C
    slot = torch.where(keep, e_flat * C + pos, E * C)                # overflow -> dump row
    t_flat = torch.arange(T * k, device=dev) // k

    # dispatch: the slots are unique apart from the dump row
    buf = x0.new_zeros((E * C + 1, D))
    buf[slot] = x0[t_flat]
    ein = buf[:-1].reshape(p["w_gate"].shape[:-2] + (C, D))     # (E, C, D) or (P, E_loc, C, D)
    h = silu(ein @ p["w_gate"]) * (ein @ p["w_up"])
    eout = torch.cat([(h @ p["w_down"]).reshape(E * C, D), x0.new_zeros((1, D))])

    weights = torch.where(keep, gate_vals.reshape(-1), 0.0)[:, None]
    y = combine((eout[slot] * weights).to(x0.dtype), gate_idx, E_loc, tp)
    return (y if tp > 1 else y[0]), aux


def combine(tok_out, gate_idx, E_loc: int, tp: int):
    """Every rank's partial ``(tp, T, D)`` of the weighted expert outputs
    ``tok_out`` (T*k, D), whose rows are token-major in ``gate_idx``'s (T, k)
    order: each token's contributions added one at a time in ascending
    expert order, in ``tok_out``'s dtype, each into the rank that owns the
    expert (rank ``e // E_loc``).  Indexed writes of distinct rows: the same
    bits on every run."""
    T, k = gate_idx.shape
    D = tok_out.shape[-1]
    by_e = gate_idx.argsort(dim=-1)
    contrib = tok_out.reshape(T, k, D).gather(1, by_e[..., None].expand(T, k, D))
    owner = gate_idx.gather(1, by_e) // E_loc                        # (T, k) rank of each
    rows = torch.arange(T, device=tok_out.device)
    y = tok_out.new_zeros((tp, T, D))
    for j in range(k):
        at = (owner[:, j], rows)
        y[at] = y[at] + contrib[:, j]
    return y


def apply_moe(p, x, cfg, ctx):
    """Prefill.  x: (B, S, D) at tp = 1, the sequence-sharded (P, B, S/P, D)
    at tp = P > 1 -> (the same shape, the load-balancing loss)."""
    lead, (B, S_loc, D) = x.shape[:-3], x.shape[-3:]
    x2d = x.reshape(lead + (B * S_loc, D))
    xf = moe_dispatch(x2d, ctx)                                      # (.., T, D)
    y_part, aux = _dispatch_compute(p, xf, cfg, ctx)
    # merge the expert groups' partials AND return to sequence shards in one RS
    y = moe_combine(y_part, ctx).reshape(x.shape)
    if cfg.shared_expert:
        y = y + apply_mlp(p["shared"], x, cfg, ctx)
    return y, aux


def apply_moe_replicated(p, x, cfg, ctx):
    """Decode: x (B, 1, D), at tp = P > 1 the rank-stacked (P, B, 1, D) of
    the replicated rows -> (the same shape, the load-balancing loss)."""
    x2d = x.reshape(x.shape[:-2] + (x.shape[-1],))
    y_part, aux = _dispatch_compute(p, x2d, cfg, ctx)
    y = all_reduce(y_part.transpose(-1, -2), ctx, tag="ep.combine").transpose(-1, -2)
    y = y.unsqueeze(-2)
    if cfg.shared_expert:
        y = y + apply_mlp_replicated(p["shared"], x, cfg, ctx)
    return y, aux
