"""Plain-PyTorch oracle: one 4-point stencil sweep, zero boundary.

It is the kernel's plain version, so the oracle and the CPU path are one
definition; the tests hold it against the reference's ``stencil_ref`` and
``stencil_pallas``.
"""

from .kernel import stencil_sweep_plain as stencil_ref

__all__ = ["stencil_ref"]
