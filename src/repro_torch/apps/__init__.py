"""repro_torch.apps: distributed application workloads over the SMI stack.

* :class:`~repro_torch.apps.halo.HaloExchange` — the N/S/E/W halo schedule
  of a 2D rank grid, start/finish-split for overlap.
* :class:`~repro_torch.apps.stencil.DistributedStencil` — 2D heat diffusion
  (paper §5.4.2): a pipelined step that runs the interior update while the
  halo slabs fly, plus the non-overlapped reference it matches bit for bit.
* :func:`~repro_torch.apps.gesummv.gesummv` and
  :func:`~repro_torch.apps.gesummv.gesummv_two_ranks` — GESUMMV (paper
  §5.4.1) on one rank and as the two-rank decomposition over a channel.
"""

from .gesummv import gesummv, gesummv_two_ranks
from .halo import HALO_TAG, HaloExchange
from .stencil import DistributedStencil

__all__ = ["HALO_TAG", "HaloExchange", "DistributedStencil", "gesummv", "gesummv_two_ranks"]
