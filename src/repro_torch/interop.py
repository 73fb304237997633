"""Carry state across from the reference package, with plain types only.

The helpers take what ``repro`` hands out as JSON strings and numpy
arrays, so the port and the reference can start from the same state
without the port importing anything of ``repro``.  They also move trees of
leaves between the global layout (the reference's arrays, a checkpoint's)
and the rank-stacked one of a tensor-parallel context (:func:`shard_tree`,
:func:`unshard_tree`), and carry a training state (``{"params", "opt":
{"m", "v", "step"}}``) both ways.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .core.comm import Communicator
from .core.topology import Topology
from .models.common import tree_map_specs


def communicator_from_reference(topology_json: str, axis_names, axis_sizes,
                                transport: str = "static", device=None) -> Communicator:
    """Rebuild a :class:`Communicator` from ``repro``'s
    ``Topology.to_json()`` string.

    The JSON carries edges, not torus coordinates: when its edges are
    exactly those of the torus over ``axis_sizes``, the torus is rebuilt
    with its coordinates (so routing is dimension-order, as in the
    reference); any other graph routes breadth-first over its edges, in the
    JSON's order."""
    spec = json.loads(topology_json)
    sizes = tuple(int(s) for s in (axis_sizes if not isinstance(axis_sizes, int)
                                   else (axis_sizes,)))
    torus = Topology.torus(sizes)
    if json.loads(torus.to_json())["edges"] == spec["edges"] \
            and torus.n_ranks == int(spec["n_ranks"]):
        topo = torus._replace_name(spec.get("name", torus.name))
    else:
        topo = Topology.from_json(topology_json)
    return Communicator.create(axis_names, sizes, topology=topo, transport=transport,
                               device=device)


def tiles_from_reference(np_tiles, device=None) -> torch.Tensor:
    """The reference's ``(P, nx, ny)`` tile stack (or any per-rank shard
    stack, rank first) as the port's rank-stacked tensor on ``device``
    (``cuda`` unless named).  The data is copied; the numpy array is not
    shared."""
    from .core.comm import resolve_device

    arr = np.array(np_tiles, copy=True)
    return torch.from_numpy(arr).to(resolve_device(device))


def router_inputs_from_reference(route_tbl, inq_pay, inq_dst, inq_len, device=None):
    """The reference's router inputs as the port's tensors on ``device``
    (``cuda`` unless named): the ``(n, n)`` route table of
    ``repro.core.router.make_router_tables`` and the staged
    ``(P, n_ports, fifo_cap, E)`` payloads, ``(P, n_ports, fifo_cap)``
    destinations and ``(P, n_ports)`` lengths, numpy arrays with the rank
    first.  Returns ``(route_tbl, inq_pay, inq_dst, inq_len)``: int32,
    float32, int32, int32, contiguous copies."""
    from .core.comm import resolve_device

    dev = resolve_device(device)
    conv = [(route_tbl, np.int32), (inq_pay, np.float32), (inq_dst, np.int32),
            (inq_len, np.int32)]
    return tuple(torch.from_numpy(np.array(a, dtype=dt, copy=True)).to(dev) for a, dt in conv)


def _leaf_from_reference(a, dev) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: cross as the bit pattern
        bits = np.array(arr.view(np.uint16), copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def _tree_from_reference(t, dev):
    if isinstance(t, dict):
        return {k: _tree_from_reference(v, dev) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return tuple(_tree_from_reference(v, dev) for v in t)
    return None if t is None else _leaf_from_reference(t, dev)


def params_from_reference(np_params, cfg, device=None):
    """The reference's ``init_lm`` tree as the port's params on ``device``
    (``cuda`` unless named): the same nesting of dicts and tuples, with the
    ``periods`` leaves stacked over layers, each leaf a copy with the same
    bits (``np_params`` is ``jax.tree.map(numpy.asarray, params)``).  The
    embedding (each codebook's, for a codebook model) must have ``cfg``'s
    padded vocabulary."""
    from .core.comm import resolve_device

    params = _tree_from_reference(np_params, resolve_device(device))
    key, want = "embed", (cfg.padded_vocab, cfg.d_model)
    if cfg.n_codebooks > 1:
        key, want = "embed_cb", (cfg.n_codebooks,) + want
    if tuple(params[key].shape) != want:
        raise ValueError(f"{key} {tuple(params[key].shape)} is not {cfg.name}'s {want}")
    return params


def train_state_from_reference(np_state, cfg, device=None):
    """The reference's training state (``build_train``'s ``{"params",
    "opt": {"m", "v", "step"}}``, as numpy) as the port's global state on
    ``device`` (``cuda`` unless named), every leaf with the same bits;
    :func:`shard_train_state` lays it over a tensor-parallel context."""
    from .core.comm import resolve_device

    dev = resolve_device(device)
    opt = np_state["opt"]
    return {"params": params_from_reference(np_state["params"], cfg, dev),
            "opt": {"m": _tree_from_reference(opt["m"], dev),
                    "v": _tree_from_reference(opt["v"], dev),
                    "step": _leaf_from_reference(opt["step"], dev)}}


def train_state_to_numpy(state, cfg, ctx, fsdp_plan=None):
    """A training state of ``ctx``'s layout (tensor-parallel, and FSDP by
    ``fsdp_plan``) as the global numpy tree the reference holds
    (``{"params", "opt": {"m", "v", "step"}}``, the same nesting):
    stacked leaves joined (:func:`unshard_train_state`), each copied to the
    host, bfloat16 leaves widened to float32 exactly."""
    from .models.common import tree_map

    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                    .detach().cpu().numpy().copy(),
                    unshard_train_state(state, cfg, ctx, fsdp_plan))


def _stored(ctx, fsdp_plan) -> bool:
    return ctx.tp > 1 or fsdp_plan is not None


def param_specs(cfg, ctx, fsdp_plan=None):
    """How each leaf of the params lies over the mesh: the model specs
    (:func:`~repro_torch.models.lm_specs`), with the data axis at each
    leaf's FSDP dim when a plan is given (``mesh.api.fsdp_storage_specs``)."""
    from .models.model import lm_specs

    sp = lm_specs(cfg, ctx)
    if fsdp_plan is None:
        return sp
    from .mesh.api import fsdp_storage_specs

    return fsdp_storage_specs(sp, fsdp_plan, ctx.batch_axes)


def train_state_specs(cfg, ctx, fsdp_plan=None):
    """How each leaf of a training state lies over the mesh: the moments
    as their params (FSDP-stored with them under a plan), the step counter
    replicated."""
    from .mesh.api import PartitionSpec

    sp = param_specs(cfg, ctx, fsdp_plan)
    return {"params": sp, "opt": {"m": sp, "v": sp, "step": PartitionSpec()}}


def shard_train_state(state, cfg, ctx, fsdp_plan=None):
    """A global training state laid over ``ctx`` (:func:`shard_tree`); at
    tp = 1 without a plan it comes back as it is."""
    if not _stored(ctx, fsdp_plan):
        return state
    return shard_tree(state, train_state_specs(cfg, ctx, fsdp_plan), ctx)


def unshard_train_state(state, cfg, ctx, fsdp_plan=None):
    """The global training state of a stacked one (:func:`unshard_tree`);
    at tp = 1 without a plan it comes back as it is."""
    if not _stored(ctx, fsdp_plan):
        return state
    return unshard_tree(state, train_state_specs(cfg, ctx, fsdp_plan), ctx)


def shard_params(params, cfg, ctx, fsdp_plan=None):
    """Global params (the port's ``init_lm``, or :func:`params_from_reference`'s)
    as the stacked params of ``ctx``: rank-stacked over the model axis by
    :func:`~repro_torch.models.lm_specs`, and each leaf ``fsdp_plan``
    shards stored as its blocks over the data axis (:func:`shard_tree`).
    At tp = 1 without a plan the params come back as they are."""
    if not _stored(ctx, fsdp_plan):
        return params
    return shard_tree(params, param_specs(cfg, ctx, fsdp_plan), ctx)


def unshard_params(params, cfg, ctx, fsdp_plan=None):
    """The global params of :func:`shard_params`' (or of their gradients)."""
    if not _stored(ctx, fsdp_plan):
        return params
    return unshard_tree(params, param_specs(cfg, ctx, fsdp_plan), ctx)


def _axes(ctx):
    """The stacked mesh axes of ``ctx``, innermost first, with their sizes:
    the model axis's P ranks, then the data axis's groups in front of them."""
    out = []
    if ctx.tp > 1:
        out.append((ctx.model_axis, ctx.tp))
    out.extend((a, ctx.dp) for a in ctx.batch_axes if ctx.dp > 1)
    return out


def _split_dim(dims, axis) -> int | None:
    hits = [i for i, d in enumerate(dims) if d == axis]
    if len(hits) > 1:
        raise ValueError(f"a spec {dims} splits two dimensions over {axis!r}")
    return hits[0] if hits else None


def shard_tree(tree, specs, ctx):
    """A tree of global leaves as ``ctx``'s stacked leaves, by the matching
    tree of specs.  A leaf split over the model axis along one dimension
    becomes its P blocks stacked on a new leading rank dimension; a leaf
    split over the data axis too (an FSDP leaf) becomes its ``dp`` blocks
    stacked in front of that, ``(dp, P, ...)`` -- both after the layer
    dimension for the leaves of a period (under a ``"periods"`` key), so
    they lie ``(L, [dp,] [P,] ...)`` and a layer's slice is stacked.  A
    replicated leaf stays the one global copy (broadcasting hands it to
    every rank).  A leaf split over the model axis along its first
    dimension after the layers (the experts of an MoE block, ``(L, E, D,
    f)`` -> ``(L, P, E/P, D, f)``) is a view of the global leaf, and so is
    every split over the data axis: no copy; the other model splits are
    copies, contiguous per rank."""
    axes = _axes(ctx)

    def split(t, spec, stacked):
        dims = tuple(spec) + (None,) * (t.dim() - len(tuple(spec)))
        s, n_in = int(stacked), 0
        for axis, n in axes:
            d = _split_dim(dims, axis)
            if d is None:
                continue
            cd = d + n_in                # the dim among the rank dims already inserted
            if t.shape[cd] % n:
                raise ValueError(f"dimension {d} of a {tuple(t.shape)} leaf does not split "
                                 f"into {n} ranks")
            t = t.unflatten(cd, (n, t.shape[cd] // n)).movedim(cd, s)
            if axis == ctx.model_axis and d != s:
                t = t.contiguous()
            n_in += 1
        return t

    return tree_map_specs(split, tree, specs)


def unshard_tree(tree, specs, ctx):
    """The inverse of :func:`shard_tree`: a tree of ``ctx``'s stacked
    leaves (params, their gradients, optimiser moments) as global leaves,
    each rank's block put back in its place along the dimension its spec
    splits; replicated leaves come back as they are.  A stacked gradient
    then compares with a tp = 1 one, and a checkpoint holds the same arrays
    whatever the mesh."""
    axes = _axes(ctx)

    def join(t, spec, stacked):
        present = [(a, n) for a, n in axes if a in tuple(spec)]
        dims = tuple(spec) + (None,) * (t.dim() - len(present) - len(tuple(spec)))
        s = int(stacked)
        n_in = len(present)
        for axis, n in reversed(present):
            d = _split_dim(dims, axis)
            if t.shape[s] != n:
                raise ValueError(f"a {tuple(t.shape)} leaf has no rank dimension of {n} at {s}")
            t = t.movedim(s, d + n_in - 1).flatten(d + n_in - 1, d + n_in)
            n_in -= 1
        return t

    return tree_map_specs(join, tree, specs)
