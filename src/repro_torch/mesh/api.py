"""Parallelism context: how model code talks to the mesh
(``repro.mesh.api``).

The context selects

* ``comm_mode="smi"`` — the paper's streaming collectives: ring schedules
  overlapped with the per-chunk GEMMs (``core/overlap.py``).  A suffix picks
  the transport backend: ``"smi:static"``, ``"smi:fused"`` (kernel A folds
  the reduce-scatters), ``"smi:packet"``;
* ``comm_mode="bulk"`` — bulk collectives over the rank stack (a gather or
  a sum in one pass), the paper's host-orchestrated baseline;
* ``comm_mode="none"`` — one device, tensor-parallel degree 1.

A mesh is the tuple of its axis sizes, right-aligned to :data:`MESH_AXES`:
``(model,)``, ``(data, model)`` or ``(pod, data, model)`` (the reference's
multi-pod layout, ``repro.launch.mesh``).  Its model axis becomes a :class:`~repro_torch.core.Communicator` of P
ranks on a ring, stacked on one card as the leading dimension of every
tensor (``core/comm.py``).  Sharding layout (TP over the model axis,
Megatron-style with sequence parallelism): the residual stream is
sequence-sharded, ``(P, B, S/P, D)``; column-parallel projections consume an
all-gather streamed through the GEMM, row-parallel ones emit a
reduce-scatter streamed through it.  ``matmul_fn`` puts kernel D on those
GEMMs (``make_ctx(..., matmul_fn=repro_torch.kernels.matmul.matmul)``).

``plan`` is the layers' default tuning plan (``"auto"``: the netsim tuning
table picks each layer call's backend; a launch's bare ``"smi"`` passes a
config's ``comm_plan``).

The batch axes, ``"pod"`` and ``"data"`` where the mesh has them
(:func:`batch_axes_of`), carry the data groups, ``dp`` their product: the
``"dp"`` communicator is their torus, ``(pod, data)``, as the reference's
``_dp_comm`` builds it.  More than one data group splits the batch
over them (``build_serve``, ``build_prefill``) or the serving slots are
replicated over them (``build_continuous_serve``).  On one card the groups
run beside the model-axis rank stack, one after another, each on its own
rows (:func:`over_data_groups`); the ledger records the first group's
traffic, as the reference's records the one device program every group
runs.  ``opt_ring_attn`` streams the K/V blocks around the model ring in
the prefill (``models/attention.py apply_attention_ring``).

FSDP over the data axis (``repro.mesh.api``'s ZeRO-3 weight streaming):
:func:`build_fsdp_plan` names, for each leaf, the first dimension the model
spec leaves whole whose size the data axis divides (``-1``: replicated;
dim 0 of a ``"periods"`` leaf, the layer dimension, never).  A sharded leaf
is stored as its ``dp`` blocks stacked on a leading data-rank dimension
(``interop.shard_params``); :func:`fsdp_gather` streams them around a ring
over the ``"dp"`` communicator (:attr:`ParallelCtx.data_comm`, one rank a
data group) under the ``fsdp.gather`` tag and hands the calling data group
(:attr:`ParallelCtx.data_group`) its copy.  Autograd transposes the ring:
the groups' gradients of a gathered leaf sum into the owners' blocks.
:func:`grad_sync` and :func:`grad_sync_fsdp` ring the gradients of the
leaves stored whole over a ``"grad"`` channel (the int8 wire with
``compressed=True``).  ``comm_mode="bulk"`` gathers and averages in one
pass, untallied, as the reference's ``lax.all_gather``/``lax.pmean`` do.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..core.comm import Communicator
from ..transport.registry import resolve_comm_mode

#: the mesh axes, outermost first; a shorter mesh tuple names the last ones
MESH_AXES = ("pod", "data", "model")
#: the axes that carry data groups (the reference's ``batch_axes_of``)
BATCH_AXES = ("pod", "data")


class PartitionSpec:
    """A leaf's layout over the mesh (``jax.sharding.PartitionSpec``): for
    each leading dimension, the mesh axis it is split over, or ``None``."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"PartitionSpec{self.dims!r}"


@dataclass(frozen=True)
class ParallelCtx:
    """Everything model code needs to know about the mesh."""

    model_axis: str | None = None          # TP/SP axis name
    batch_axes: tuple[str, ...] = ()       # DP axes
    model_comm: Communicator | None = None
    comm_mode: str = "none"                # smi | bulk | none (base mode)
    transport: str = "static"              # smi backend: static|fused|packet
    matmul_fn: Callable | None = None      # kernel D injection
    mesh: tuple | None = None
    opt_shared_gather: bool = False        # beyond-paper: one seq ring a block
    opt_ring_attn: bool = False            # beyond-paper: KV-streaming attention
    #: a persistent ChannelPool (serving); None = the transient lifecycle
    channels: object = field(default=None, compare=False)
    #: default tuning plan of the layer channels (None: the pinned wire)
    plan: object = field(default=None, compare=False)
    #: the ``"dp"`` ring over the data groups (an smi mode on a data axis of
    #: more than one rank; None: bulk, or no data axis)
    data_comm: Communicator | None = None
    #: the data group a model call computes: an FSDP gather hands it its copy
    data_group: int = 0

    @property
    def is_smi(self) -> bool:
        return self.comm_mode == "smi"

    @property
    def tp(self) -> int:
        return self.model_comm.size if self.model_comm is not None else 1

    @property
    def dp(self) -> int:
        """The number of data groups: the product of the batch axes' sizes."""
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in self.batch_axes:
            n *= sizes.get(a, 1)
        return n

    def rank(self, ndim: int = 1):
        """This rank's index along the model axis: 0 at tp = 1; at tp > 1
        every stacked rank's, ``arange(P)`` shaped ``(P, 1, ..., 1)`` with
        ``ndim`` dims to broadcast against a rank-stacked tensor."""
        return self.model_comm.rank(ndim) if self.model_comm is not None else 0


def make_ctx(mesh=None, *, model_axis: str | None = "model",
             batch_axes: tuple[str, ...] | None = None, comm_mode: str = "bulk",
             matmul_fn=None, opt_shared_gather: bool = False, opt_ring_attn: bool = False,
             plan=None, device=None) -> ParallelCtx:
    """The context of a launch.  With no mesh, or a model axis of one rank,
    it is the tensor-parallel-degree-1 context whatever the comm mode (the
    reference's, which drops ``matmul_fn`` there too).  ``batch_axes``
    defaults to every batch axis the mesh has (:func:`batch_axes_of`); more
    than one data group gets its ``"dp"`` communicator in an smi mode, the
    torus of those axes.  A model axis of P > 1 ranks gives a ring
    communicator of P ranks stacked on ``device`` (``cuda`` unless named)."""
    base_mode, transport = resolve_comm_mode(comm_mode)
    mesh = None if mesh is None else tuple(int(n) for n in mesh)
    if mesh is not None and not 1 <= len(mesh) <= len(MESH_AXES):
        raise ValueError(f"mesh {mesh}: give (pod, data, model), (data, model) or (model,) "
                         f"sizes")
    sizes = mesh_sizes(mesh)
    if batch_axes is None:
        batch_axes = batch_axes_of(mesh)
    batch = tuple(a for a in batch_axes if a in sizes and a != model_axis)
    dp = 1
    for a in batch:
        dp *= sizes[a]
    data_comm = None
    if dp > 1 and base_mode == "smi":
        data_comm = Communicator.create(batch, tuple(sizes[a] for a in batch), name="dp",
                                        transport=transport, device=device)
    tp = sizes.get(model_axis, 1) if model_axis is not None else 1
    if tp == 1:
        # a mesh's model axis of one rank still names the specs' model dims
        # (the reference's layout, which the FSDP plan reads)
        return ParallelCtx(model_axis=model_axis if model_axis in sizes else None,
                           batch_axes=batch, comm_mode="none", transport=transport, mesh=mesh,
                           opt_shared_gather=opt_shared_gather, opt_ring_attn=opt_ring_attn,
                           plan=plan, data_comm=data_comm)
    comm = Communicator.create(model_axis, (tp,), name=f"tp_{model_axis}",
                               transport=transport, device=device)
    return ParallelCtx(
        model_axis=model_axis,
        batch_axes=batch,
        model_comm=comm,
        comm_mode=base_mode,
        transport=transport,
        matmul_fn=matmul_fn,
        mesh=mesh,
        opt_shared_gather=opt_shared_gather,
        opt_ring_attn=opt_ring_attn,
        plan=plan,
        data_comm=data_comm,
    )


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh tuple, right-aligned to
    :data:`MESH_AXES`."""
    return {} if mesh is None else dict(zip(MESH_AXES[-len(mesh):], mesh))


def batch_axes_of(mesh) -> tuple[str, ...]:
    """The mesh's batch axes, outermost first: every one of ``"pod"`` and
    ``"data"`` that it has (the reference's ``batch_axes_of``)."""
    return tuple(a for a in BATCH_AXES if a in mesh_sizes(mesh))


def data_groups(mesh) -> int:
    """The number of data groups of a mesh: the product of its batch axes."""
    sizes = mesh_sizes(mesh)
    n = 1
    for a in batch_axes_of(mesh):
        n *= sizes[a]
    return n


def check_fsdp(fsdp, mesh, param_count: int) -> bool:
    """The reference's FSDP switch for a step builder on ``mesh``, resolved:
    ``"auto"`` turns it on where one model shard's bfloat16 weights pass
    10 GB (counted from the config, ``param_count``; the reference's own
    count wraps in int32 on the largest leaves, ROADMAP.md §3).  FSDP
    shards over the batch axes, so it is off where they hold one group."""
    mesh = None if mesh is None else tuple(int(n) for n in mesh)
    sizes = mesh_sizes(mesh)
    if fsdp == "auto":
        fsdp = (param_count / sizes.get("model", 1)) * 2 > 10e9
    return bool(fsdp) and data_groups(mesh) > 1


#: a stand-in for running the data groups, ``runner(n, fn)`` returning the
#: ``n`` groups' results (:func:`group_runner`); None runs them all
_GROUP_RUNNER = None


@contextlib.contextmanager
def group_runner(runner):
    """Within the block, :func:`run_groups` hands its groups to
    ``runner(n, fn)``; ``None`` restores its own way."""
    global _GROUP_RUNNER
    prev, _GROUP_RUNNER = _GROUP_RUNNER, runner
    try:
        yield
    finally:
        _GROUP_RUNNER = prev


def run_groups(n: int, fn) -> list:
    """``[fn(0), ..., fn(n - 1)]``: each data group's program, one after
    another.  Only the first group tallies into an active ledger capture:
    every group runs the same program, whose traffic the reference's
    ledger records once."""
    if _GROUP_RUNNER is not None:
        return _GROUP_RUNNER(n, fn)
    from ..parallel import ledger

    out = [fn(0)]
    with ledger.paused():
        out.extend(fn(g) for g in range(1, n))
    return out


def over_data_groups(ctx, n_rows: int, fn):
    """Run ``fn(g, rows)`` for each of ``ctx.dp`` data groups ``g``,
    ``rows`` the group's ``slice`` of ``n_rows`` batch rows (the whole
    batch, once, by group 0, when it does not split evenly: the reference
    then replicates it), and return the list of results
    (:func:`run_groups`)."""
    dp = ctx.dp if n_rows % ctx.dp == 0 else 1
    m = n_rows // dp
    return run_groups(dp, lambda g: fn(g, slice(g * m, (g + 1) * m)))


# --------------------------------------------------------------------- FSDP


def fsdp_dim_for(shape, model_spec, dp: int, *, skip_dim0: bool = False) -> int:
    """The reference's FSDP rule: the first dimension the model spec leaves
    unsharded whose size the data axis divides; ``-1`` stores the leaf
    replicated.  ``skip_dim0`` keeps a layer-stack dimension whole."""
    dims = tuple(model_spec) + (None,) * (len(shape) - len(tuple(model_spec)))
    for i, (d, s) in enumerate(zip(dims, shape)):
        if skip_dim0 and i == 0:
            continue
        if d is None and s % dp == 0 and s >= dp and dp > 1:
            return i
    return -1


def build_fsdp_plan(param_shapes, param_specs, mesh, batch_axes=None):
    """A tree of FSDP dims (int; ``-1`` replicated) shaped as the params:
    ``param_shapes`` the global leaves (tensors, or anything with a
    ``shape``, e.g. :func:`~repro_torch.models.param_shapes`'), their
    ``param_specs`` the model layout, sharded over ``batch_axes`` (the
    mesh's, :func:`batch_axes_of`, unless named).  A ``"periods"`` leaf's
    dim 0 is the layer dimension and is never sharded."""
    from ..models.common import tree_map_specs

    mesh = None if mesh is None else tuple(int(n) for n in mesh)
    if batch_axes is None:
        batch_axes = batch_axes_of(mesh)
    sizes = mesh_sizes(mesh)
    dp = 1
    for a in batch_axes:
        dp *= sizes.get(a, 1)
    return tree_map_specs(lambda sh, sp, stacked: fsdp_dim_for(tuple(sh.shape), sp, dp,
                                                               skip_dim0=stacked),
                          param_shapes, param_specs)


def fsdp_storage_specs(param_specs, fsdp_plan, batch_axes=("data",)):
    """The storage layout: each model spec with the batch axes at its FSDP
    dim."""
    from ..models.common import tree_map

    ax = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]

    def one(sp, dim):
        if dim < 0:
            return sp
        dims = list(sp) + [None] * (dim + 1 - len(tuple(sp)))
        dims[dim] = ax
        return PartitionSpec(*dims)

    return tree_map(one, param_specs, fsdp_plan)


def _shift_plan(plan):
    """A ``"periods"`` subtree's FSDP dims as one layer's (the layer
    dimension stripped)."""
    from ..models.common import tree_map

    return tree_map(lambda d: d - 1 if d > 0 else -1, plan)


def fsdp_gather(params, fsdp_plan, ctx: ParallelCtx, specs, *, tag: str = "fsdp.gather"):
    """The calling data group's copy of every FSDP-stored leaf of
    ``params`` (one layer's, or the top-level leaves): each ``(dp, ...)``
    block stack is all-gathered along its FSDP dim (``fsdp_plan``, the
    leaf's own dims as :func:`build_fsdp_plan` gives them) over the
    ``"dp"`` ring, tallied under ``tag``, and row ``ctx.data_group`` kept.
    ``specs`` are the leaves' model specs: a leaf split over the model axis
    at tp > 1 is rank-stacked behind the data rank, so its blocks carry
    every model rank's (the ring tallies one device's bytes).  Leaves stored
    whole pass through.  Autograd takes the gradient back through the
    transposed ring to the owners' blocks.  ``comm_mode="bulk"`` joins the
    blocks in one pass."""
    from ..models.common import tree_map

    if ctx.dp == 1:
        return params

    def one(p, dim, sp):
        if dim < 0:
            return p
        lanes = _lanes(ctx, sp)
        d = dim + (lanes > 1)            # the dim in a block, after its model rank dim
        if ctx.data_comm is None:
            return torch.cat(p.unbind(0), dim=d)
        from ..parallel import fsdp_allgather

        return fsdp_allgather(p, ctx.data_comm, d, tag=tag, lanes=lanes)[ctx.data_group]

    return tree_map(one, params, fsdp_plan, specs)


def _lanes(ctx: ParallelCtx, spec) -> int:
    """The model ranks a leaf is stacked over (1 for a leaf stored whole on
    the model axis)."""
    return ctx.tp if ctx.tp > 1 and spec is not None and ctx.model_axis in tuple(spec) else 1


def grad_sync(grads, ctx: ParallelCtx, *, compressed: bool = False, tag: str = "grad",
              transport=None, specs=None):
    """The data-parallel gradient mean of a tree of ``(dp, ...)`` stacks
    (row ``g`` data group ``g``'s gradient): a ring all-reduce a tensor over
    a fresh ``"grad"`` channel on the ``"dp"`` ring (the int8 wire with
    ``compressed=True``), divided by ``dp``; every row holds its rank's
    result.  A leaf rank-stacked over the model axis (``specs``, the
    leaves' model specs) rings each model rank's block on its own, as each
    device does; the ledger tallies the first's.  ``comm_mode="bulk"``: the
    mean in one pass, untallied (the reference's ``lax.pmean``)."""
    from ..models.common import tree_map, tree_map_specs

    n = ctx.dp
    if n == 1:
        return grads
    if ctx.data_comm is None:
        return tree_map(lambda g: (g.sum(0, keepdim=True) / n).expand_as(g), grads)
    from ..parallel import grad_allreduce, ledger

    wire = "int8" if compressed else "raw"

    def ring(g):
        return grad_allreduce(g, ctx.data_comm, tag=tag, wire=wire, transport=transport) / n

    def one(g, sp, stacked):
        if _lanes(ctx, sp) == 1:
            return ring(g)
        ld = 1 + int(stacked)            # the model rank dim, behind the data rank's
        out = [ring(g.select(ld, 0))]
        with ledger.paused():
            out.extend(ring(g.select(ld, r)) for r in range(1, g.shape[ld]))
        return torch.stack(out, ld)

    if specs is None:
        specs = tree_map(lambda _: None, grads)
    return tree_map_specs(one, grads, specs)


def grad_sync_fsdp(grads, fsdp_plan, ctx: ParallelCtx, *, compressed: bool = False,
                   tag: str = "grad", specs=None):
    """The data-parallel gradient mean under FSDP: an FSDP leaf's gradient
    arrives summed into its owners' blocks (the gather's transpose) and is
    divided by ``dp``; a leaf stored whole arrives as the groups' ``(dp,
    ...)`` stack and rings over a ``"grad"`` channel (:func:`grad_sync`,
    ``specs`` the leaves' model specs)."""
    from ..models.common import tree_map

    dp = ctx.dp
    if dp == 1:
        return grads
    if specs is None:
        specs = tree_map(lambda _: None, grads)
    whole = grad_sync(tree_map(lambda g, d: None if d >= 0 else g, grads, fsdp_plan), ctx,
                      compressed=compressed, tag=tag, specs=specs)
    return tree_map(lambda g, d, w: g / dp if d >= 0 else w, grads, fsdp_plan, whole)
