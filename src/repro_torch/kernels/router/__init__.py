"""The packet router's datapath (kernel C).

``ref`` holds the plain PyTorch tick on the stacked state of all ranks
(absorb + arbitrate) and the whole-run loop over it; ``kernel`` holds the
wrapper of the two CUDA kernels that run a whole router run in one call
(:func:`router_path` picks one by shape), with the plain run as its CPU
path, and of the block-tick form (:func:`router_tick_block`: one tick of a
block of ranks a launch, the form ranks run as processes use).
"""

from .kernel import router_path, router_run, router_tick_block
from .ref import (
    TickSpec,
    init_state,
    pack_rows,
    router_absorb,
    router_run_ref,
    router_tick,
    router_tick_block_plain,
    tick_spec_of,
    unpack_rows,
)

__all__ = ["TickSpec", "init_state", "pack_rows", "router_absorb", "router_path", "router_run",
           "router_run_ref", "router_tick", "router_tick_block", "router_tick_block_plain",
           "tick_spec_of", "unpack_rows"]
