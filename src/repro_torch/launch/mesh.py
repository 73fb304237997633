"""Production meshes (``repro.launch.mesh``).

A mesh here is the tuple of its axis sizes with the names of its axes
(``mesh/api.py``: the port stacks every rank of the model axis on one card
and runs the data groups one after another, so a mesh needs no devices).
Single-pod: ``(16, 16)`` = 256 ranks over ``(data, model)``.  Multi-pod:
``(2, 16, 16)`` = 512 ranks over ``(pod, data, model)``; the ``"pod"`` axis
is one more dimension of the data groups' torus.
"""

from __future__ import annotations

from ..mesh import api


def make_production_mesh(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``(shape, axis names)`` of the production mesh: ``(16, 16)`` over
    ``(data, model)``, or ``(2, 16, 16)`` over ``(pod, data, model)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, api.MESH_AXES[-len(shape):])


def make_mesh(shape, axes) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Any mesh (tests, benchmarks, elastic restarts): ``shape`` sizes over
    ``axes``, which must be the last ``len(shape)`` of
    :data:`~repro_torch.mesh.api.MESH_AXES` (the order every step builder
    reads a mesh tuple in)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or axes != api.MESH_AXES[len(api.MESH_AXES) - len(axes):]:
        raise ValueError(f"mesh {shape} over {axes}: the axes must be the last "
                         f"{len(shape)} of {api.MESH_AXES}")
    return shape, axes


def batch_axes_of(mesh) -> tuple[str, ...]:
    """The batch axes of a ``(shape, axes)`` mesh, or of anything with
    ``axis_names`` and ``devices`` (a ``jax.sharding.Mesh``):
    :func:`repro_torch.mesh.api.batch_axes_of` of its checked shape."""
    if hasattr(mesh, "axis_names"):
        mesh = (mesh.devices.shape, mesh.axis_names)
    return api.batch_axes_of(make_mesh(*mesh)[0])
