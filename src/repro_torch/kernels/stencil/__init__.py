from .kernel import stencil_sweep, stencil_sweep_plain
from .ops import stencil_interior, stencil_run, stencil_step
from .ref import stencil_ref

__all__ = ["stencil_interior", "stencil_ref", "stencil_run", "stencil_step",
           "stencil_sweep", "stencil_sweep_plain"]
