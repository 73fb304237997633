"""Launch-layer configuration: the parts of ``repro.configs`` the ported
slice runs (transport backends, comm_mode strings, stencil cells)."""

from .registry import COMM_MODES, STENCIL_CASES, TRANSPORT_BACKENDS

__all__ = ["COMM_MODES", "STENCIL_CASES", "TRANSPORT_BACKENDS"]
