"""String-keyed transport registry + comm_mode parsing.

Call sites name their backend with a string carried in
``Communicator.transport`` or a ``comm_mode`` like ``"smi:fused"``; the
same call site then runs over whichever backend the string selects.  The
port has ``"static"``, ``"fused"``, ``"packet"`` and ``"packet:pallas"``.
The reference's compressed keys name a backend that is not ported yet, and
asking for one raises — it never falls back to another backend.
"""

from __future__ import annotations

from typing import Union

_REGISTRY: dict[str, type] = {}

#: transport key used when a comm_mode / Communicator doesn't name one
DEFAULT_TRANSPORT = "static"

#: reference backends the port does not have yet, and the slice that adds each
NOT_PORTED = {
    "compressed": "the compressed-wire slice",
}


def register_transport(name: str):
    """Class decorator: register a Transport subclass under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_builtins():
    # each module registers its keys when first imported; importing one of
    # them directly must not hide the others
    from . import fused, packet, static  # noqa: F401


def available_transports() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def _not_ported(key: str):
    base = key if key in NOT_PORTED else key.partition(":")[0]
    return NOT_PORTED.get(base)


def is_transport_key(key: str) -> bool:
    """True when ``key`` names a backend the port has."""
    _ensure_builtins()
    return key in _REGISTRY


def get_transport(name: str | None = None, **kw):
    """New Transport instance for ``name`` (None -> DEFAULT_TRANSPORT);
    ``kw`` (e.g. ``device=``) goes to the constructor."""
    _ensure_builtins()
    key = name or DEFAULT_TRANSPORT
    if key in _REGISTRY:
        return _REGISTRY[key](**kw)
    later = _not_ported(key)
    if later is not None:
        raise NotImplementedError(
            f"transport {key!r} is not ported yet (it comes with {later}); "
            f"available: {available_transports()}"
        )
    raise KeyError(f"unknown transport {key!r}; available: {available_transports()}")


def resolve_transport(transport, comm=None):
    """Per-call resolution: explicit object > explicit key > communicator's
    key > default.  A key resolves to a fresh instance on the
    communicator's device."""
    from .base import Transport

    if isinstance(transport, Transport):
        return transport
    if transport is None and comm is not None:
        transport = comm.transport
    kw = {} if comm is None else {"device": comm.device}
    return get_transport(transport, **kw)


def resolve_comm_mode(mode: Union[str, None]) -> tuple[str, str]:
    """Split a comm_mode string into (base_mode, transport_key).

    ``"smi"`` -> ("smi", "static"); ``"smi:fused"`` -> ("smi", "fused");
    ``"bulk"`` / ``"none"`` pass through with the default transport key.
    Unknown bases or transports raise; a reference backend that is not
    ported yet raises ``NotImplementedError``.
    """
    if not mode:
        return "none", DEFAULT_TRANSPORT
    base, _, backend = mode.partition(":")
    if base not in ("smi", "bulk", "none"):
        raise ValueError(f"unknown comm_mode base {base!r} in {mode!r}")
    if not backend:
        return base, DEFAULT_TRANSPORT
    if base != "smi":
        raise ValueError(
            f"comm_mode {mode!r}: only 'smi' takes a transport backend"
        )
    if not is_transport_key(backend):
        later = _not_ported(backend)
        if later is not None:
            raise NotImplementedError(
                f"comm_mode {mode!r}: transport {backend!r} is not ported "
                f"yet (it comes with {later})"
            )
        raise ValueError(
            f"comm_mode {mode!r}: unknown transport {backend!r}; "
            f"available: {available_transports()}"
        )
    return base, backend
