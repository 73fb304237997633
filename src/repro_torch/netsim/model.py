"""Copy of ``repro.netsim.model.clamp_chunks``; the link cost model itself
is not ported yet."""

from __future__ import annotations


def clamp_chunks(n_chunks: int, leading_dim: int) -> int:
    """Largest divisor of ``leading_dim`` <= the chunk-count hint (the
    pipelined transports require n_chunks | leading dim; hints are never a
    correctness constraint)."""
    n = max(1, min(int(n_chunks), int(leading_dim)))
    while leading_dim % n:
        n -= 1
    return n
