"""AdamW (``repro.optim.adamw``) on trees of tensors.

The moments are float32 and the step an int32 counter, as the reference's.
The update works leaf by leaf, so it runs on the rank-stacked leaves of a
tensor-parallel or FSDP-stored state as it is and needs no collective:
each rank's block of a sharded leaf is its own, and a replicated leaf is
stored once.  :func:`opt_specs` is the reference's ZeRO-1 layout of the
moments over a data axis.
"""

from __future__ import annotations

import torch

from ..models.common import tree_flatten, tree_map


def opt_specs(param_specs, mesh, params_shape, data_axes=("data",)) -> dict:
    """ZeRO-1 (the reference's ``opt_specs``): each moment split over the
    data axes on the first dimension its param spec leaves unsharded whose
    size the data axis divides; ``{"m", "v", "step"}`` specs."""
    from ..mesh.api import PartitionSpec, mesh_sizes

    sizes = mesh_sizes(None if mesh is None else tuple(int(n) for n in mesh))
    dp = 1
    for a in data_axes:
        dp *= sizes.get(a, 1)
    ax = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]

    def spec_for(ps, shape_leaf):
        dims = tuple(ps) + (None,) * (len(shape_leaf.shape) - len(tuple(ps)))
        for i, (d, s) in enumerate(zip(dims, shape_leaf.shape)):
            if d is None and s % dp == 0 and s > 0 and dp > 1:
                return PartitionSpec(*dims[:i], ax, *dims[i + 1:])
        return PartitionSpec(*dims)

    moments = tree_map(spec_for, param_specs, params_shape)
    return {"m": moments, "v": moments, "step": PartitionSpec()}


def adamw_init(params) -> dict:
    """Zero float32 moments shaped as ``params`` and a zero int32 step."""
    any_leaf = tree_flatten(params)[0]
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "step": torch.zeros((), dtype=torch.int32, device=any_leaf.device)}


@torch.no_grad()
def adamw_update(params, grads, opt, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step, the reference's arithmetic in float32: ``m = b1 m +
    (1 - b1) g``, ``v = b2 v + (1 - b2) g g``, bias-corrected, and ``p -=
    lr (m̂ / (sqrt(v̂) + eps) + weight_decay p)``, the result cast to the
    param's dtype.  ``params``, the moments and the step are updated in
    place (the reference returns new trees; in place saves a copy of the
    state) and returned as ``(params, opt)``."""
    step = opt["step"].add_(1)
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for p, g, m, v in zip(tree_flatten(params), tree_flatten(grads), tree_flatten(opt["m"]), tree_flatten(opt["v"]),
                          strict=True):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        new_p = p.float() - lr * ((m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float())
        p.copy_(new_p)
    return params, opt
