"""The stencil sweep's entry points: one step, a time loop, the interior."""

from __future__ import annotations

import torch

from .kernel import stencil_sweep


def stencil_step(x: torch.Tensor) -> torch.Tensor:
    """One sweep of the 4-point stencil with zero (Dirichlet) boundaries,
    on an (M, N) tile or a (P, M, N) stack of tiles."""
    return stencil_sweep(x)


def stencil_run(x: torch.Tensor, n_steps: int) -> torch.Tensor:
    """``n_steps`` sweeps (the paper's T timesteps)."""
    for _ in range(n_steps):
        x = stencil_step(x)
    return x


def stencil_interior(x: torch.Tensor) -> torch.Tensor:
    """Interior output points of one sweep: rows/cols ``1..-2`` of
    :func:`stencil_step`, which read no halo values.  This is the compute
    the distributed stencil runs *while* its halo slabs are in flight; every
    point is the same ``0.25 * (n + s + w + e)`` float32 expression as the
    halo'd sweep, so the two agree bit for bit."""
    return stencil_step(x)[..., 1:-1, 1:-1]
