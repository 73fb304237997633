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


def train_state_to_numpy(state, cfg, ctx):
    """A training state of ``ctx``'s tensor-parallel degree as the global
    numpy tree the reference holds (``{"params", "opt": {"m", "v",
    "step"}}``, the same nesting): rank-stacked leaves joined
    (:func:`unshard_train_state`), each copied to the host, bfloat16 leaves
    widened to float32 exactly."""
    from .models.common import tree_map

    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                    .detach().cpu().numpy().copy(), unshard_train_state(state, cfg, ctx))


def train_state_specs(cfg, ctx):
    """How each leaf of a training state lies over the mesh: the moments
    as their params, the step counter replicated."""
    from .mesh.api import PartitionSpec
    from .models.model import lm_specs

    sp = lm_specs(cfg, ctx)
    return {"params": sp, "opt": {"m": sp, "v": sp, "step": PartitionSpec()}}


def shard_train_state(state, cfg, ctx):
    """A global training state laid over ``ctx``'s tensor-parallel degree
    (:func:`shard_tree`); at tp = 1 it comes back as it is."""
    return state if ctx.tp == 1 else shard_tree(state, train_state_specs(cfg, ctx), ctx)


def unshard_train_state(state, cfg, ctx):
    """The global training state of a rank-stacked one
    (:func:`unshard_tree`); at tp = 1 it comes back as it is."""
    return state if ctx.tp == 1 else unshard_tree(state, train_state_specs(cfg, ctx), ctx)


def shard_params(params, cfg, ctx):
    """Global params (the port's ``init_lm``, or :func:`params_from_reference`'s)
    as the rank-stacked params of ``ctx``'s tensor-parallel degree P, by
    :func:`~repro_torch.models.lm_specs` (:func:`shard_tree`).  At tp = 1
    the params come back as they are."""
    if ctx.tp == 1:
        return params
    from .models.model import lm_specs

    return shard_tree(params, lm_specs(cfg, ctx), ctx)


def shard_tree(tree, specs, ctx):
    """A tree of global leaves as ``ctx``'s rank-stacked leaves, by the
    matching tree of specs: a leaf split over the model axis along one
    dimension becomes its P blocks stacked on a new leading rank dimension
    -- after the layer dimension for the leaves of a period (under a
    ``"periods"`` key), so they lie
    ``(L, P, ...)`` and a layer's slice is rank-stacked.  A replicated leaf
    stays the one global copy (broadcasting hands it to every rank).  A leaf
    split along its first dimension after the layers (the experts of an MoE
    block, ``(L, E, D, f)`` -> ``(L, P, E/P, D, f)``) is a view of the
    global leaf: no copy; the rest are copies, contiguous per rank."""
    P, m = ctx.tp, ctx.model_axis

    def split(t, spec, stacked):
        dims = tuple(spec) + (None,) * (t.dim() - len(tuple(spec)))
        axes = [i for i, d in enumerate(dims) if d == m]
        if not axes:
            return t
        (d,) = axes
        if t.shape[d] % P:
            raise ValueError(f"dimension {d} of a {tuple(t.shape)} leaf does not split "
                             f"into {P} ranks")
        return t.unflatten(d, (P, t.shape[d] // P)).movedim(d, int(stacked)).contiguous()

    def walk(t, spec, stacked):
        if isinstance(t, dict):
            return {k: walk(v, spec[k], stacked or k == "periods") for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(walk(v, s, stacked) for v, s in zip(t, spec, strict=True))
        return None if t is None else split(t, spec, stacked)

    return walk(tree, specs, False)


def unshard_tree(tree, specs, ctx):
    """The inverse of :func:`shard_tree`: a tree of ``ctx``'s rank-stacked
    leaves (params, their gradients, optimiser moments) as global leaves,
    each rank's block put back in its place along the dimension its spec
    splits; replicated leaves come back as they are.  A rank-stacked
    gradient then compares with a tp = 1 one, and a checkpoint holds the
    same arrays whatever the tp."""
    P, m = ctx.tp, ctx.model_axis

    def join(t, spec, stacked):
        dims = tuple(spec) + (None,) * (t.dim() - 1 - len(tuple(spec)))
        axes = [i for i, d in enumerate(dims) if d == m]
        if not axes:
            return t
        (d,) = axes
        s = int(stacked)
        if t.shape[s] != P:
            raise ValueError(f"a {tuple(t.shape)} leaf has no rank dimension of {P} at {s}")
        return t.movedim(s, d).flatten(d, d + 1)

    def walk(t, spec, stacked):
        if isinstance(t, dict):
            return {k: walk(v, spec[k], stacked or k == "periods") for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(walk(v, s, stacked) for v, s in zip(t, spec, strict=True))
        return None if t is None else join(t, spec, stacked)

    return walk(tree, specs, False)
