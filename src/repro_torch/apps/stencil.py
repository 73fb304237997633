"""Distributed 2D heat-diffusion stencil with compute/communication overlap.

The paper's flagship application (§5.4.2): a 4-point stencil over a domain
sharded on a (RX, RY) rank grid, halo slabs streamed to the neighbours
every timestep.  Two step schedules, numerically identical by construction:

* :meth:`DistributedStencil.step_reference` — the non-overlapped baseline:
  the halo exchange completes, then the full sweep runs on the padded tile.
* :meth:`DistributedStencil.step_overlapped` — the pipelined schedule: the
  four neighbour permutes are issued first, the *interior* update (which
  reads no halo values) runs — on a CUDA tensor through the stencil kernel
  (``kernels/stencil``) — and only the boundary ring waits for
  :meth:`HaloExchange.finish`.

Every output point is the same ``0.25 * (n + s + w + e)`` float32
expression in both schedules, so overlapped == reference to the bit, and
distributed == single-rank on the exact wires.  The tiles of the ranks a
process holds are one ``(n_local, nx, ny)`` tensor on the communicator's
device: all P of them in stacked mode, a block of them in each rank process
in process mode (:mod:`repro_torch.core.spmd`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.collectives import _schedule_loop
from ..core.comm import Communicator
from ..kernels.stencil import stencil_interior, stencil_ref
from .halo import HALO_TAG, HaloExchange


def _sweep(padded: torch.Tensor) -> torch.Tensor:
    """One 4-point sweep of halo-padded tiles: (..., M, N) -> (..., M-2, N-2).

    The single numeric expression both step schedules are built from —
    identical operand order everywhere, which makes the
    overlapped/reference diff exact."""
    q = padded.float()
    out = 0.25 * (q[..., :-2, 1:-1] + q[..., 2:, 1:-1] + q[..., 1:-1, :-2] + q[..., 1:-1, 2:])
    return out.to(padded.dtype)


@dataclass(frozen=True)
class DistributedStencil:
    """A sharded heat-diffusion run over ``grid`` = (RX, RY) ranks.

    ``transport`` / ``plan`` configure the halo schedule (see
    :class:`HaloExchange`).  The interior update takes the stencil kernel on
    a CUDA tensor and its plain version on a CPU tensor.
    """

    comm: Communicator
    grid: tuple[int, int]
    transport: object = None
    plan: object = None

    @staticmethod
    def create(grid, *, axis_names=None, comm=None, comm_mode=None, transport=None,
               plan=None, device=None):
        """Build the app over a fresh communicator (row-major torus over
        ``axis_names``) on ``device`` (``cuda`` unless named) unless one is
        passed.  ``comm_mode`` accepts the launch-layer strings
        (``"smi:fused"``), mapped onto the halo channel's spec."""
        RX, RY = grid
        if comm is None:
            if axis_names is None:
                axis_names = ("gx", "gy") if RX > 1 and RY > 1 else ("gx",)
            sizes = grid if len(axis_names) == 2 else (RX * RY,)
            comm = Communicator.create(axis_names, sizes, device=device)
        if comm_mode is not None:
            from ..channels import default_channel_spec

            if transport is not None:
                raise ValueError("pass comm_mode or transport, not both")
            spec = default_channel_spec(comm, comm_mode, kind="exchange", port=None,
                                        tag=HALO_TAG)
            transport = spec.transport
        return DistributedStencil(comm=comm, grid=(RX, RY), transport=transport, plan=plan)

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def halo_schedule(self) -> HaloExchange:
        return HaloExchange(comm=self.comm, grid=self.grid, halo=(1, 1),
                            transport=self.transport, plan=self.plan)

    # -- one timestep ------------------------------------------------------

    def step_reference(self, x, transport=None):
        """Non-overlapped: exchange completes, then the full padded sweep."""
        return _sweep(self.halo_schedule.exchange(x, transport))

    def step_overlapped(self, x, transport=None):
        """Pipelined: the interior update runs between the halo exchange's
        start and finish; only the one-point boundary ring consumes the
        received slabs."""
        he = self.halo_schedule
        inflight = he.start(x, transport)
        inner = stencil_interior(x)
        padded = he.finish(x, inflight)
        out = torch.zeros_like(x)
        out[:, 1:-1, 1:-1] = inner
        out[:, 0, :] = _sweep(padded[:, :3, :])[:, 0]
        out[:, -1, :] = _sweep(padded[:, -3:, :])[:, 0]
        out[:, :, 0] = _sweep(padded[:, :, :3])[:, :, 0]
        out[:, :, -1] = _sweep(padded[:, :, -3:])[:, :, 0]
        return out

    # -- multi-step runs ---------------------------------------------------

    def run(self, x, n_steps: int, *, overlapped: bool = True, transport=None):
        """``n_steps`` timesteps of the rank-stacked tiles ``x``; every
        step's halo traffic is tallied on one transport instance."""
        t = self.halo_schedule.resolve_transport(x, transport)
        step = self.step_overlapped if overlapped else self.step_reference
        return _schedule_loop(t, n_steps, lambda _, v: step(v, transport=t), x)

    # -- domain plumbing ---------------------------------------------------

    def scatter(self, world) -> torch.Tensor:
        """(X, Y) domain -> the row-major tiles of the ranks this process
        holds, ``(n_local, nx, ny)`` on the app's device (every rank's in
        stacked mode)."""
        RX, RY = self.grid
        world = torch.as_tensor(world, device=self.device)
        X, Y = world.shape
        if X % RX or Y % RY:
            raise ValueError(f"domain {tuple(world.shape)} not divisible by grid {self.grid}")
        nx, ny = X // RX, Y // RY
        lo, n = self.comm.lo, self.comm.n_local
        tiles = world.reshape(RX, nx, RY, ny).permute(0, 2, 1, 3).reshape(RX * RY, nx, ny)
        return tiles[lo:lo + n]

    def gather(self, tiles: torch.Tensor) -> torch.Tensor:
        """(n_ranks, nx, ny) tile stack of every rank -> reassembled (X, Y)
        domain (in process mode, of the tiles every process gave back:
        :meth:`~repro_torch.core.spmd.SpmdGroup.run` stacks them)."""
        RX, RY = self.grid
        if tiles.shape[0] != RX * RY:
            raise ValueError(f"gather needs the tiles of all {RX * RY} ranks, not "
                             f"{tiles.shape[0]}")
        _, nx, ny = tiles.shape
        return tiles.reshape(RX, RY, nx, ny).permute(0, 2, 1, 3).reshape(RX * nx, RY * ny)

    @staticmethod
    def single_rank_reference(world: torch.Tensor, n_steps: int) -> torch.Tensor:
        """The undistributed oracle: ``n_steps`` zero-boundary sweeps with
        the plain PyTorch version, on ``world``'s device."""
        out = world
        for _ in range(n_steps):
            out = stencil_ref(out)
        return out

    # -- costing -------------------------------------------------------------

    def predicted_step_time(self, tile_shape, dtype="float32", model=None, *,
                            overlapped: bool = True, compute_seconds: float | None = None,
                            wire: str = "raw") -> float:
        """LinkModel prediction of one timestep (the card's fit unless
        ``model`` is given): the halo exchange's time of one rank's
        ``tile_shape`` tile, combined with ``compute_seconds`` through the
        overlap window (the longer of the two on the pipelined schedule,
        the sum on the reference)."""
        from ..netsim.model import LinkModel

        model = model or LinkModel()
        comm_s = self.halo_schedule.predicted_time(tile_shape, dtype, model=model, wire=wire)
        if compute_seconds is None:
            return comm_s
        if overlapped:
            return model.overlapped_step_time(compute_seconds, comm_s)
        return model.serial_step_time(compute_seconds, comm_s)
