"""String-keyed transport registry + comm_mode parsing.

Call sites name their backend with a string carried in
``Communicator.transport`` or a ``comm_mode`` like ``"smi:fused"``; the
same call site then runs over whichever backend the string selects.  The
port has ``"static"``, ``"fused"``, ``"packet"``, ``"packet:pallas"`` and
``"compressed"``.  Wrapper backends compose by key: a class registered with
a true ``wraps_inner`` attribute (``CompressedTransport``) takes
``"<wrapper>:<inner>"`` keys — ``"compressed:packet"`` is the int8 wire over
the packet router; comm modes spell it ``"smi:compressed:packet"``.
"""

from __future__ import annotations

from typing import Union

_REGISTRY: dict[str, type] = {}

#: transport key used when a comm_mode / Communicator doesn't name one
DEFAULT_TRANSPORT = "static"

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
    from . import compressed, fused, packet, static  # noqa: F401


def available_transports() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def _split_wrapper(key: str):
    """``"compressed:packet"`` -> (wrapper class, ``"packet"``); None for any
    other key."""
    outer, _, inner = key.partition(":")
    cls = _REGISTRY.get(outer)
    if inner and cls is not None and getattr(cls, "wraps_inner", False) and inner in _REGISTRY:
        return cls, inner
    return None


def is_transport_key(key: str) -> bool:
    """True when ``key`` names a backend the port has, composed
    ``"<wrapper>:<inner>"`` keys included."""
    _ensure_builtins()
    return key in _REGISTRY or _split_wrapper(key) is not None


def get_transport(name: str | None = None, **kw):
    """New Transport instance for ``name`` (None -> DEFAULT_TRANSPORT);
    ``kw`` (e.g. ``device=``) goes to the constructor."""
    _ensure_builtins()
    key = name or DEFAULT_TRANSPORT
    if key in _REGISTRY:
        return _REGISTRY[key](**kw)
    wrapped = _split_wrapper(key)
    if wrapped is not None:
        cls, inner = wrapped
        return cls(inner=inner, **kw)
    raise KeyError(f"unknown transport {key!r}; available: {available_transports()} "
                   "(wrapper backends compose as '<wrapper>:<inner>', e.g. 'compressed:packet')")


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
    ``"smi:compressed:packet"`` -> ("smi", "compressed:packet"); ``"bulk"``
    / ``"none"`` pass through with the default transport key.  Unknown
    bases or transports raise.
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
        raise ValueError(
            f"comm_mode {mode!r}: unknown transport {backend!r}; "
            f"available: {available_transports()}"
        )
    return base, backend
