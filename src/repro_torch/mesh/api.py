"""Parallelism context: how model code talks to the mesh
(``repro.mesh.api``), single-device subset.

The port's model slice runs at tensor-parallel degree 1 on one card:
``tp == 1``, ``rank() == 0``, ``comm_mode="none"``.  A mesh with a model
axis of more than one rank, the SMI or bulk comm modes and ring attention
wait for the tensor-parallel slice (``ROADMAP.md`` §1, items 2 and 9) and
raise ``NotImplementedError`` rather than run single-device in their stead.
"""

from __future__ import annotations

from dataclasses import dataclass

#: what a tensor-parallel request raises with
TP_ROADMAP = ("tensor parallelism (tp > 1) waits for the TP serving slice: channels, "
              "ChannelPool and the overlap engine (ROADMAP.md §1, items 2 and 9)")


@dataclass(frozen=True)
class ParallelCtx:
    """Everything model code needs to know about the mesh: at tp = 1, that
    there is none."""

    @property
    def tp(self) -> int:
        return 1

    def rank(self) -> int:
        return 0


def make_ctx(mesh=None, *, comm_mode: str = "none", opt_ring_attn: bool = False) -> ParallelCtx:
    """The context of a launch.  ``mesh`` is ``None`` or the grid of one
    device (``(1, 1)``); a larger grid, another comm mode or ring attention
    raises."""
    if mesh is not None and tuple(mesh) not in ((1,), (1, 1)):
        raise NotImplementedError(f"mesh {tuple(mesh)}: {TP_ROADMAP}")
    if comm_mode != "none":
        raise NotImplementedError(f"comm_mode={comm_mode!r}: {TP_ROADMAP}")
    if opt_ring_attn:
        raise NotImplementedError(f"opt_ring_attn (ring attention): {TP_ROADMAP}")
    return ParallelCtx()
