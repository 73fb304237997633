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

It is also

* **costed** — :meth:`predicted_stats` is the netsim-exact (steps, bytes)
  the backend tallies under ``"halo"``, and :meth:`predicted_time` the
  :class:`~repro_torch.netsim.model.LinkModel` prediction of one exchange;
* **tunable** — ``plan="auto"`` asks the communicator's tuning table which
  backend moves a slab of this size on this topology
  (``Communicator.plan("halo", nbytes)``; always a raw wire: a lossy halo
  is an explicit choice, never a tuned one).

Its communication configuration rides in a :class:`ChannelSpec` of kind
``"exchange"`` (:attr:`spec`) carrying the ``"halo"`` stats tag.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..channels.spec import ChannelSpec
from ..core.comm import Communicator
from ..core.overlap import halo_exchange_2d_finish, halo_exchange_2d_start
from ..netsim.schedule import (
    _dtype_size,
    halo_slab_elems,
    predict_halo_stats,
    predict_halo_time,
)
from ..obs import trace as obs

#: the tag halo wire traffic is accounted under (TransportStats.by_tag)
HALO_TAG = "halo"


@dataclass(frozen=True)
class HaloExchange:
    """The N/S/E/W halo-exchange schedule of a (RX, RY) rank grid.

    ``transport`` is a registry key / Transport instance / None (the
    communicator's default); ``plan="auto"`` defers the choice to the
    tuning table per tile size.  A per-call ``transport=`` always wins.
    """

    comm: Communicator
    grid: tuple[int, int]
    halo: tuple[int, int] = (1, 1)
    transport: object = None
    plan: object = None

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
                           transport=self.transport, plan=self.plan, tag=HALO_TAG)

    def slab_nbytes(self, tile_shape, dtype=torch.float32) -> int:
        """Bytes of the largest halo slab of one rank's ``tile_shape`` tile
        (the message size the tuner's ``halo`` cells are keyed on)."""
        ns, ew = halo_slab_elems(tuple(tile_shape), self.halo)
        return max(ns, ew) * _dtype_size(dtype)

    def resolve_transport(self, tile=None, transport=None):
        """The Transport instance one exchange of the rank-stacked ``tile``
        uses: the explicit argument > the spec's ``transport`` > the tuned
        ``halo`` plan (``plan="auto"``) > the communicator's default."""
        spec = self.spec
        if transport is not None:
            from ..transport.registry import resolve_transport

            return resolve_transport(transport, self.comm)
        if spec.transport is None and spec.plan == "auto" and tile is not None:
            p = self.comm.plan("halo", self.slab_nbytes(tile.shape[1:], tile.dtype))
            return spec.replace(transport=p.transport_key).resolve()
        return spec.resolve()

    def start(self, x, transport=None):
        """Launch the four neighbour permutes; returns the in-flight slabs
        (tallied under ``"halo"`` in the backend's stats).  A traced
        ``halo.start`` carries one rank's tile shape, as the reference's
        per-shard event does."""
        t = self.resolve_transport(x, transport)
        if obs.TRACING:
            obs.emit("halo.start", tag=self.spec.stats_tag, grid=list(self.grid),
                     tile=list(x.shape[1:]), transport=t.name)
        return halo_exchange_2d_start(
            x, self.comm, grid=self.grid, halo=self.halo, transport=t, tag=self.spec.stats_tag,
        )

    def finish(self, x, inflight):
        """Assemble the halo-padded tiles from ``x`` + the in-flight slabs."""
        if obs.TRACING:
            obs.emit("halo.finish", tag=self.spec.stats_tag, grid=list(self.grid))
        return halo_exchange_2d_finish(x, inflight, self.comm, grid=self.grid, halo=self.halo)

    def exchange(self, x, transport=None):
        """Non-overlapped exchange: start and immediately finish."""
        return self.finish(x, self.start(x, transport))

    # -- costing (netsim) ----------------------------------------------------

    def predicted_stats(self, tile_shape, dtype="float32", transport: str = "static", **kw):
        """Exact (steps, bytes) one exchange of one rank's ``tile_shape``
        tile tallies under ``transport``: what ``stats.by_tag["halo"]``
        holds after it.  Extra keywords (``pkt_elems`` etc.) go to
        :func:`~repro_torch.netsim.schedule.predict_halo_stats`."""
        return predict_halo_stats(self.comm, grid=self.grid, shape=tuple(tile_shape),
                                  dtype=dtype, halo=self.halo, transport=transport, **kw)

    def predicted_time(self, tile_shape, dtype="float32", model=None,
                       wire: str = "raw") -> float:
        """LinkModel-predicted seconds of one exchange (the card's fit
        unless ``model`` is given)."""
        return predict_halo_time(self.comm, grid=self.grid, shape=tuple(tile_shape),
                                 dtype=dtype, halo=self.halo, model=model, wire=wire)
