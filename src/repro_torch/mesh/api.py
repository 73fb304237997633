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

A data axis of more than one rank carries data groups: the batch is split
over them (``build_serve``, ``build_prefill``) or the serving slots are
replicated over them (``build_continuous_serve``).  On one card the groups
run beside the model-axis rank stack, one after another, each on its own
rows (:func:`over_data_groups`); the ledger records the first group's
traffic, as the reference's records the one device program every group
runs.  ``opt_ring_attn`` streams the K/V blocks around the model ring in
the prefill (``models/attention.py apply_attention_ring``).  FSDP over the
data axis is not in the port and raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..core.comm import Communicator
from ..transport.registry import resolve_comm_mode

#: what FSDP over a data axis of more than one rank raises with
DATA_AXIS_ROADMAP = ("FSDP (weights sharded over a data axis of more than one rank) and the "
                     "gradient sync over such an axis wait for the second half of the training "
                     "slice (ROADMAP.md §1, item 13)")
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
    opt_ring_attn: bool = False            # beyond-paper: KV-streaming attention
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
             batch_axes: tuple[str, ...] = ("data",), comm_mode: str = "bulk",
             matmul_fn=None, opt_shared_gather: bool = False, opt_ring_attn: bool = False,
             plan=None, device=None) -> ParallelCtx:
    """The context of a launch.  With no mesh, or a model axis of one rank,
    it is the tensor-parallel-degree-1 context whatever the comm mode (the
    reference's, which drops ``matmul_fn`` there too).  A model axis of P > 1
    ranks gives a ring communicator of P ranks stacked on ``device``
    (``cuda`` unless named)."""
    base_mode, transport = resolve_comm_mode(comm_mode)
    mesh = None if mesh is None else tuple(int(n) for n in mesh)
    if mesh is not None and not 1 <= len(mesh) <= len(MESH_AXES):
        raise ValueError(f"mesh {mesh}: give (data, model) or (model,) sizes")
    sizes = mesh_sizes(mesh)
    batch = tuple(a for a in batch_axes if a in sizes and a != model_axis)
    tp = sizes.get(model_axis, 1) if model_axis is not None else 1
    if tp == 1:
        return ParallelCtx(batch_axes=batch, comm_mode="none", transport=transport, mesh=mesh,
                           opt_shared_gather=opt_shared_gather, opt_ring_attn=opt_ring_attn,
                           plan=plan)
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
    )


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``(data, model)`` or ``(model,)`` mesh."""
    return {} if mesh is None else dict(zip(MESH_AXES[-len(mesh):], mesh))


def check_fsdp(fsdp, mesh, param_count: int):
    """The reference's FSDP switch for a step builder on ``mesh``:
    ``"auto"`` turns it on where one model shard's bfloat16 weights pass
    10 GB.  FSDP shards over the data axis, so it changes nothing on a data
    axis of one rank; on more it is not in the port and raises."""
    sizes = mesh_sizes(None if mesh is None else tuple(int(n) for n in mesh))
    if fsdp == "auto":
        fsdp = (param_count / sizes.get("model", 1)) * 2 > 10e9
    if fsdp and sizes.get("data", 1) > 1:
        raise NotImplementedError(DATA_AXIS_ROADMAP)


def over_data_groups(ctx, n_rows: int, fn):
    """Run ``fn(rows)`` for each of ``ctx.dp`` data groups, ``rows`` the
    group's ``slice`` of ``n_rows`` batch rows (the whole batch, once, when
    it does not split evenly: the reference then replicates it), and return
    the list of results.  Only the first group tallies into an active
    ledger capture: every group runs the same program, whose traffic the
    reference's ledger records once."""
    from ..parallel import ledger

    dp = ctx.dp if n_rows % ctx.dp == 0 else 1
    m = n_rows // dp
    out = [fn(slice(0, m))]
    with ledger.paused():
        out.extend(fn(slice(g * m, (g + 1) * m)) for g in range(1, dp))
    return out
