"""Shared helpers of the port's tests (tests/test_torch_*.py).

The reference side runs each rank's function under ``jit(shard_map)`` on
the 8 host devices of tests/conftest.py, with the transports whose paths
pass there: ``StaticTransport()`` and ``FusedTransport(use_pallas=False)``.
The port side runs the same inputs as one rank-stacked tensor on the CPU.
Inputs come from ``numpy.random.RandomState`` and go through both.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from repro.core import Communicator as RefComm
from repro.core import make_test_mesh, run_spmd
from repro.transport import available_transports
from repro_torch.interop import communicator_from_reference, tiles_from_reference
from repro_torch.transport import get_transport

# Load every reference backend through its registry before any module of
# repro.transport is imported directly: the registry imports its built-ins
# only while "static" is unregistered, so importing static.py first would
# leave "packet" out for every later test in this process.
available_transports()

from repro.transport.fused import FusedTransport as RefFused  # noqa: E402
from repro.transport.static import StaticTransport as RefStatic  # noqa: E402

#: the two rank layouts of the paper's 8-rank testbed
TOPOS = {"ring": (("x",), (8,)), "torus": (("x", "y"), (2, 4))}
TRANSPORTS = ("static", "fused")


def ref_comm(topo: str) -> RefComm:
    names, sizes = TOPOS[topo]
    return RefComm.create(names, sizes)


def ref_transport(key: str):
    return RefStatic() if key == "static" else RefFused(use_pallas=False)


def port_comm(topo: str, transport: str = "static"):
    rc = ref_comm(topo)
    return communicator_from_reference(rc.topology.to_json(), rc.axis_names,
                                       rc.axis_sizes, transport, device="cpu")


def port_transport(key: str):
    return get_transport(key, device="cpu")


def run_ref(fn, topo: str, *stacks) -> np.ndarray:
    """``fn(*per_rank_args)`` on every rank; each stack is ``(P, ...)``
    with rank r's argument in row r.  Returns the ``(P, ...)`` results."""
    names, sizes = TOPOS[topo]
    mesh = make_test_mesh(sizes, names)
    spec = PS(names[0]) if len(names) == 1 else PS(names)
    out = run_spmd(lambda *v: fn(*[a[0] for a in v])[None], mesh,
                   (spec,) * len(stacks), spec, *stacks)
    return np.asarray(out)


def to_port(a: np.ndarray) -> torch.Tensor:
    return tiles_from_reference(a, device="cpu")


def assert_bits_equal(got, want, msg: str = ""):
    """Bit-for-bit equality (tolerance 0, -0.0 != +0.0) of a port tensor
    and a reference array."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{msg}: shape {got.shape} != {want.shape}"
    assert got.dtype.itemsize == want.dtype.itemsize, f"{msg}: {got.dtype} vs {want.dtype}"
    if got.tobytes() != want.tobytes():
        bad = np.flatnonzero(got.reshape(-1).view(np.uint8) != want.reshape(-1).view(np.uint8))
        pytest.fail(f"{msg}: {bad.size} bytes differ, first at byte {bad[0]}")


def assert_stats_equal(port_t, ref_t, msg: str = ""):
    """Steps, bytes and per-tag counters of the two transports agree."""
    assert port_t.stats.steps == ref_t.stats.steps, msg
    assert port_t.stats.bytes_moved == ref_t.stats.bytes_moved, msg
    assert port_t.stats.by_tag == ref_t.stats.by_tag, msg
