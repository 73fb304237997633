"""Copy of ``repro.configs.registry``'s transport and stencil tables,
restricted to what the port has."""

from __future__ import annotations

#: transport backends of the port (``comm_mode="smi:<backend>"``); bare
#: ``"smi"`` means ``smi:static``
TRANSPORT_BACKENDS: tuple[str, ...] = ("static", "fused", "packet")
COMM_MODES: tuple[str, ...] = ("smi", *(f"smi:{b}" for b in TRANSPORT_BACKENDS))

#: default (grid, domain, steps) cells the stencil launcher runs: the
#: paper's 8-rank testbed shape as a torus and as a 1D ring
STENCIL_CASES: dict[str, dict] = {
    "ring8": {"grid": (1, 8), "domain": (256, 256), "steps": 8},
    "torus2x4": {"grid": (2, 4), "domain": (256, 256), "steps": 8},
    "torus2x2": {"grid": (2, 2), "domain": (256, 256), "steps": 8},
}
