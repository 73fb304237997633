"""Copy of the halo wiring in ``repro.netsim.schedule``.

The traced exchange (``core/overlap.py``) takes its neighbour pairs from
here, as the reference does, so the wiring has one definition.
"""

from __future__ import annotations


def halo_pairs(grid, drx: int, dry: int):
    """(src, dst) pairs of one halo direction: rank (sx, sy) of the
    row-major ``grid`` sends to (sx + drx, sy + dry) where that rank
    exists (no wrap)."""
    RX, RY = grid
    pairs = []
    for s in range(RX * RY):
        sx, sy = s // RY, s % RY
        tx, ty = sx + drx, sy + dry
        if 0 <= tx < RX and 0 <= ty < RY:
            pairs.append((s, tx * RY + ty))
    return pairs


def halo_slab_elems(shape, halo=(1, 1)) -> tuple[int, int]:
    """(ns_elems, ew_elems): element counts of one N/S row slab and one E/W
    column slab of a per-rank tile ``shape`` = (Nx, Ny, ...)."""
    hx, hy = halo
    trail = 1
    for d in shape[2:]:
        trail *= int(d)
    return hx * shape[1] * trail, shape[0] * hy * trail
