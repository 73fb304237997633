"""Halo exchange (the paper's stencil application, §5.4.2).

The start/finish split of the reference's ``core/overlap.py``: the four
neighbour permutes are issued first, the caller runs the interior update,
and only then is the padded tile assembled.  Tensors are rank-stacked:
``x`` is ``(P, Nx, Ny, ...)``, row ``r`` rank ``r``'s tile.
"""

from __future__ import annotations

import torch

from ..netsim.schedule import halo_pairs as halo_perm
from .comm import Communicator


def _resolve(transport, comm: Communicator):
    from ..transport.registry import resolve_transport

    return resolve_transport(transport, comm)


def halo_exchange_2d_start(
    x: torch.Tensor,
    comm: Communicator,
    *,
    grid: tuple[int, int],
    halo: tuple[int, int] = (1, 1),
    transport=None,
    tag: str = "halo",
):
    """Launch the four neighbour permutes of a 2D halo exchange and return
    the in-flight halo slabs (south, north, east, west) — the *send edge*
    of the overlap window.  Steps are accounted under ``tag``."""
    RX, RY = grid
    hx, hy = halo
    if comm.size != RX * RY:
        raise ValueError(f"grid {grid} needs {RX * RY} ranks; communicator has {comm.size}")
    t = _resolve(transport, comm)

    with t.tagged(tag):
        def shift(buf, drx, dry):
            pairs = halo_perm(grid, drx, dry)
            if not pairs:
                # a 1-row/1-column grid has no neighbours this direction: no
                # wire step at all (and none accounted) — the paper's unused
                # channels; every rank's halo is zeros
                return torch.zeros_like(buf)
            return t.permute(buf, comm, pairs)

        # x[:, :hx] are each rank's north boundary rows; the north
        # neighbour (rx-1) needs them as its south halo, and so on per
        # direction.
        south_halo = shift(x[:, :hx], -1, 0)   # from rx+1: their north rows
        north_halo = shift(x[:, -hx:], +1, 0)  # from rx-1: their south rows
        east_halo = shift(x[:, :, :hy], 0, -1)  # from ry+1: their west cols
        west_halo = shift(x[:, :, -hy:], 0, +1)  # from ry-1: their east cols
    return south_halo, north_halo, east_halo, west_halo


def halo_exchange_2d_finish(
    x: torch.Tensor,
    inflight,
    comm: Communicator,
    *,
    grid: tuple[int, int],
    halo: tuple[int, int] = (1, 1),
):
    """Assemble the padded tiles from ``x`` and the slabs returned by
    :func:`halo_exchange_2d_start` — the *receive edge* of the overlap
    window.  Physical-boundary halos are zeroed (Dirichlet)."""
    RX, RY = grid
    hx, hy = halo
    south_halo, north_halo, east_halo, west_halo = inflight
    r = comm.rank(x.dim())
    rx, ry = r // RY, r % RY
    P, Nx, Ny = x.shape[0], x.shape[1], x.shape[2]
    out = x.new_zeros((P, Nx + 2 * hx, Ny + 2 * hy) + tuple(x.shape[3:]))
    zero = x.new_zeros(())
    out[:, hx:-hx, hy:-hy] = x
    out[:, :hx, hy:-hy] = torch.where(rx > 0, north_halo, zero)
    out[:, -hx:, hy:-hy] = torch.where(rx < RX - 1, south_halo, zero)
    out[:, hx:-hx, :hy] = torch.where(ry > 0, west_halo, zero)
    out[:, hx:-hx, -hy:] = torch.where(ry < RY - 1, east_halo, zero)
    return out


def halo_exchange_2d(
    x: torch.Tensor,
    comm: Communicator,
    *,
    grid: tuple[int, int],
    halo: tuple[int, int] = (1, 1),
    transport=None,
):
    """Exchange N/S/E/W halo slabs of a 2D-decomposed domain (paper
    Fig. 14) and return the tiles padded with the received halos (zero at
    physical boundaries).  The non-overlapped composition."""
    inflight = halo_exchange_2d_start(x, comm, grid=grid, halo=halo, transport=transport)
    return halo_exchange_2d_finish(x, inflight, comm, grid=grid, halo=halo)
