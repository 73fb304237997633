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

A mesh is the tuple of its axis sizes, ``(data, model)`` (or ``(model,)``).
Its model axis becomes a :class:`~repro_torch.core.Communicator` of P
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

Not in the port yet, each raising ``NotImplementedError`` rather than
running something else in its stead: a data axis of more than one rank,
ring attention (``opt_ring_attn``), and decode and serving at tp > 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..core.comm import Communicator
from ..transport.registry import resolve_comm_mode

#: what tensor-parallel decode and serving raise with
TP_ROADMAP = ("tensor-parallel decode and serving (tp > 1) wait for the rest of the TP slice "
              "(ROADMAP.md §1, item 9)")
#: what ring attention raises with
RING_ATTN_ROADMAP = "opt_ring_attn (ring attention) waits for its slice (ROADMAP.md §1, item 9)"
#: what a mesh with a data axis of more than one rank raises with
DATA_AXIS_ROADMAP = ("a data axis of more than one rank (data parallelism, FSDP) waits for "
                     "its slice (ROADMAP.md §1, item 9)")
#: the mesh axes, outermost first
MESH_AXES = ("data", "model")


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
    #: a persistent ChannelPool (serving); None = the transient lifecycle
    channels: object = field(default=None, compare=False)
    #: default tuning plan of the layer channels (None: the pinned wire)
    plan: object = field(default=None, compare=False)

    @property
    def is_smi(self) -> bool:
        return self.comm_mode == "smi"

    @property
    def tp(self) -> int:
        return self.model_comm.size if self.model_comm is not None else 1

    def rank(self, ndim: int = 1):
        """This rank's index along the model axis: 0 at tp = 1; at tp > 1
        every stacked rank's, ``arange(P)`` shaped ``(P, 1, ..., 1)`` with
        ``ndim`` dims to broadcast against a rank-stacked tensor."""
        return self.model_comm.rank(ndim) if self.model_comm is not None else 0


def make_ctx(mesh=None, *, model_axis: str | None = "model",
             batch_axes: tuple[str, ...] = ("data",), comm_mode: str = "bulk",
             matmul_fn=None, opt_shared_gather: bool = False, opt_ring_attn: bool = False,
             plan=None, device=None) -> ParallelCtx:
    """The context of a launch.  With no mesh, or a model axis of one rank,
    it is the tensor-parallel-degree-1 context whatever the comm mode (the
    reference's, which drops ``matmul_fn`` there too).  A model axis of P > 1
    ranks gives a ring communicator of P ranks stacked on ``device``
    (``cuda`` unless named)."""
    base_mode, transport = resolve_comm_mode(comm_mode)
    if opt_ring_attn:
        raise NotImplementedError(RING_ATTN_ROADMAP)
    mesh = None if mesh is None else tuple(int(n) for n in mesh)
    if mesh is not None and not 1 <= len(mesh) <= len(MESH_AXES):
        raise ValueError(f"mesh {mesh}: give (data, model) or (model,) sizes")
    sizes = {} if mesh is None else dict(zip(MESH_AXES[-len(mesh):], mesh))
    if any(sizes.get(a, 1) > 1 for a in batch_axes if a != model_axis):
        raise NotImplementedError(f"mesh {mesh}: {DATA_AXIS_ROADMAP}")
    tp = sizes.get(model_axis, 1) if model_axis is not None else 1
    if tp == 1:
        return ParallelCtx(comm_mode="none", transport=transport, mesh=mesh,
                           opt_shared_gather=opt_shared_gather, plan=plan)
    comm = Communicator.create(model_axis, (tp,), name=f"tp_{model_axis}",
                               transport=transport, device=device)
    return ParallelCtx(
        model_axis=model_axis,
        batch_axes=tuple(a for a in batch_axes if a in sizes),
        model_comm=comm,
        comm_mode=base_mode,
        transport=transport,
        matmul_fn=matmul_fn,
        mesh=mesh,
        opt_shared_gather=opt_shared_gather,
        plan=plan,
    )
