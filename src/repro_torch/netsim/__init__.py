"""The parts of ``repro.netsim`` the port's schedules need, copied.

Only the halo wiring (:mod:`.schedule`), the tuning-plan record
(:mod:`.tune`) and the compressed wire's block size (:mod:`.model`) are
here; the simulator, the link cost model and the autotuner come with a
later slice.
"""

from .model import WIRE_AXIS_ELEMS, clamp_chunks
from .schedule import halo_pairs, halo_slab_elems
from .tune import DEFAULT_PLAN, Plan

__all__ = ["DEFAULT_PLAN", "Plan", "WIRE_AXIS_ELEMS", "clamp_chunks", "halo_pairs",
           "halo_slab_elems"]
