"""smilint: static analysis for SMI channel programs (the port of
``repro.analysis``).

Two passes over two program sources:

* **capture mode** (:mod:`repro_torch.analysis.capture` + :mod:`.verify`) —
  abstract interpretation: run a program with every transport replaced by
  a no-op accounting backend, then verify the recorded channel-op ledger
  (port collisions, endpoint matching, push/pop balance, credit windows,
  claim leaks, deadlock cycles);
* **AST lints** (:mod:`repro_torch.analysis.rules`) — source-level rules
  over the port's tree (deprecated shims, close discipline, reserved
  ports, raw moves over the rank dimension), with
  ``# smilint: ignore[RULE]`` suppression.

CLI: ``python -m repro_torch.analysis.lint``.

This package root imports only the op model and the verifier (no torch):
``capture`` / ``AbstractTransport`` pull in the transport stack and resolve
on first attribute access; ``.programs`` and ``.lint`` pull in the launch
stack and are imported explicitly by the CLI only.
"""

from .ops import (  # noqa: F401
    CaptureLedger,
    ChannelOp,
    Program,
    ProgramBuilder,
    as_program,
)
from .verify import (  # noqa: F401
    CATALOG,
    Diagnostic,
    verify_ledger,
    verify_program,
)

#: lazy (torch-touching) exports -> defining submodule
_LAZY = {"capture": "capture", "record": "capture",
         "AbstractTransport": "capture", "source_location": "capture"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
