"""Elastic scaling (``repro.ft.elastic``): re-mesh to the surviving device
set.  The routing tables are regenerated for the new topology (the paper's
route regeneration), and the state, checkpointed global, is laid onto the
new mesh's rank stack."""

from __future__ import annotations

import torch

from ..core import Topology, compute_route_table


def best_mesh_shape(n_devices: int, *, prefer_model: int = 4) -> tuple[int, int]:
    """The largest usable ``(data, model)`` grid for ``n_devices``."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return (n_devices // model, model)


def elastic_restart_plan(old_n: int, new_n: int, *, prefer_model: int = 4) -> dict:
    """The new mesh shape and fresh routing tables for the new world:
    ``{"mesh_shape", "topology", "route_table"}``."""
    shape = best_mesh_shape(new_n, prefer_model=prefer_model)
    topo = Topology.torus(shape)
    return {"mesh_shape": shape, "topology": topo, "route_table": compute_route_table(topo)}


def reshard_state(host_state, like, cfg, ctx, fsdp_plan=None):
    """A global host training state (a checkpoint's numpy tree) as
    ``ctx``'s stacked state (FSDP-stored by ``fsdp_plan``, ``build_train``'s
    ``plan``), each leaf on the device and in the dtype of ``like``'s
    matching leaf (a state of the same structure, such as
    ``build_train``'s ``init_state()``); params come back requiring
    gradients, as the training step takes them."""
    from ..interop import shard_train_state
    from ..models.common import tree_flatten, tree_unflatten

    leaves = [torch.from_numpy(a).to(device=r.device, dtype=r.dtype)
              for a, r in zip(tree_flatten(host_state), tree_flatten(like), strict=True)]
    state = shard_train_state(tree_unflatten(like, leaves), cfg, ctx, fsdp_plan)
    for p in tree_flatten(state["params"]):
        p.requires_grad_(True)
    return state
