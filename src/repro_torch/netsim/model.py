"""Copies of ``repro.netsim.model``'s ``WIRE_AXIS_ELEMS`` and
``clamp_chunks``; the link cost model itself is not ported yet."""

from __future__ import annotations

#: scale-block size of the int8 compressed wire: one float32 scale per
#: ``WIRE_AXIS_ELEMS`` payload elements (``transport/compressed.py``)
WIRE_AXIS_ELEMS = 256


def clamp_chunks(n_chunks: int, leading_dim: int) -> int:
    """Largest divisor of ``leading_dim`` <= the chunk-count hint (the
    pipelined transports require n_chunks | leading dim; hints are never a
    correctness constraint)."""
    n = max(1, min(int(n_chunks), int(leading_dim)))
    while leading_dim % n:
        n -= 1
    return n
