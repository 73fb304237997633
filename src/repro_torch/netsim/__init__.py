"""The parts of ``repro.netsim`` the port's schedules need, copied.

Only the halo wiring (:mod:`.schedule`) and the tuning-plan record
(:mod:`.tune`) are here; the simulator, the link cost model and the
autotuner come with a later slice.
"""

from .model import clamp_chunks
from .schedule import halo_pairs, halo_slab_elems
from .tune import DEFAULT_PLAN, Plan

__all__ = ["DEFAULT_PLAN", "Plan", "clamp_chunks",
           "halo_pairs", "halo_slab_elems"]
