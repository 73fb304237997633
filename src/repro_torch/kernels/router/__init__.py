"""The packet router's datapath (kernel C).

``ref`` holds the plain PyTorch tick on the stacked state of all ranks
(absorb + arbitrate) and the whole-run loop over it; ``kernel`` holds the
wrapper of the two CUDA kernels that run a whole router run in one call
(:func:`router_path` picks one by shape), with the plain run as its CPU
path.
"""

from .kernel import router_path, router_run
from .ref import TickSpec, router_absorb, router_run_ref, router_tick, tick_spec_of

__all__ = ["TickSpec", "router_absorb", "router_path", "router_run", "router_run_ref", "router_tick",
           "tick_spec_of"]
