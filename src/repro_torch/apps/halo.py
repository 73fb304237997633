"""HaloExchange: the distributed-application communication schedule.

The paper's stencil benchmark (§5.4.2, Fig. 14) decomposes a 2D domain over
a rank grid and streams boundary slabs to the four neighbours each
timestep.  :class:`HaloExchange` packages that schedule:

* **backend-agnostic** — the slabs move through whichever transport the
  communicator (or an explicit ``transport=`` / ``comm_mode="smi:<b>"``)
  selects;
* **split for overlap** — :meth:`start` launches the neighbour permutes and
  :meth:`finish` assembles the padded tiles, so an application runs its
  interior compute between the two.

Its communication configuration rides in a :class:`ChannelSpec` of kind
``"exchange"`` (:attr:`spec`) carrying the ``"halo"`` stats tag.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..channels.spec import ChannelSpec
from ..core.comm import Communicator
from ..core.overlap import halo_exchange_2d_finish, halo_exchange_2d_start

#: the tag halo wire traffic is accounted under (TransportStats.by_tag)
HALO_TAG = "halo"


@dataclass(frozen=True)
class HaloExchange:
    """The N/S/E/W halo-exchange schedule of a (RX, RY) rank grid.

    ``transport`` is a registry key / Transport instance / None (the
    communicator's default).  A per-call ``transport=`` always wins.
    """

    comm: Communicator
    grid: tuple[int, int]
    halo: tuple[int, int] = (1, 1)
    transport: object = None

    def __post_init__(self):
        RX, RY = self.grid
        if self.comm.size != RX * RY:
            raise ValueError(
                f"grid {self.grid} needs {RX * RY} ranks; communicator has {self.comm.size}"
            )

    @property
    def spec(self) -> ChannelSpec:
        """This schedule's communication config: an anonymous-port
        ``"exchange"`` channel tagged ``"halo"``."""
        return ChannelSpec(comm=self.comm, kind="exchange", port=None,
                           transport=self.transport, tag=HALO_TAG)

    def resolve_transport(self, transport=None):
        """The Transport instance one exchange uses: the explicit argument,
        else the spec's (a fresh instance for a key)."""
        if transport is not None:
            from ..transport.registry import resolve_transport

            return resolve_transport(transport, self.comm)
        return self.spec.resolve()

    def start(self, x, transport=None):
        """Launch the four neighbour permutes; returns the in-flight slabs
        (tallied under ``"halo"`` in the backend's stats)."""
        return halo_exchange_2d_start(
            x, self.comm, grid=self.grid, halo=self.halo,
            transport=self.resolve_transport(transport), tag=self.spec.stats_tag,
        )

    def finish(self, x, inflight):
        """Assemble the halo-padded tiles from ``x`` + the in-flight slabs."""
        return halo_exchange_2d_finish(x, inflight, self.comm, grid=self.grid, halo=self.halo)

    def exchange(self, x, transport=None):
        """Non-overlapped exchange: start and immediately finish."""
        return self.finish(x, self.start(x, transport))
