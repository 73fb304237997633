"""The port's streamed collectives against ``repro.core.collectives``.

Every collective runs on ring(1x8) and torus(2x4) over the static and the
fused wire, from the same numpy inputs on both sides; outputs must agree
bit for bit (tolerance 0: every operation is a copy or the same ordered
float32 add) and the transport counters step for step and byte for byte.
Fourteen of them also run on rings of 2, 3, 5, 6 and 7 ranks and on the
2x3, 3x2 and 4x2 tori, where the fused wire's ring steps take kernel A's
gather-fused form at odd P and on tori.
"""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

from _torch_cases import CASES, _f32, _i32
from _torch_ref import (
    TOPOS,
    TRANSPORTS,
    assert_bits_equal,
    assert_stats_equal,
    port_comm,
    port_transport,
    ref_comm,
    ref_transport,
    run_ref,
    to_port,
)

import repro.core.collectives as rc
import repro_torch.core.collectives as pc
from repro.core import Communicator as RefComm
from repro.core import make_test_mesh, run_spmd
from repro.netsim.tune import Plan as RefPlan
from repro_torch.interop import communicator_from_reference
from repro_torch.netsim import Plan

P = 8


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_matches_reference(case, topo, transport):
    call, x = CASES[case]
    rcomm, rt = ref_comm(topo), ref_transport(transport)
    want = run_ref(lambda v: call(rc, rcomm, rt, v, RefPlan), topo, x)
    pt = port_transport(transport)
    xin = to_port(x)
    got = call(pc, port_comm(topo), pt, xin, Plan)
    assert_bits_equal(got, want, f"{case} on {topo}/{transport}")
    assert_stats_equal(pt, rt, f"{case} on {topo}/{transport}")
    assert_bits_equal(xin, x, "input was modified")


def test_dispatchers_default_to_the_tuned_plan():
    """``plan="auto"`` is the default: the communicator's tuning table
    (keyed on one rank's bytes) picks the plan; ``plan=None`` is the static
    default; ``transport=`` replaces only the plan's backend."""
    comm = port_comm("ring")
    x = to_port(_f32(P, 16))
    tuned = comm.plan("allreduce", 16 * 4)
    assert_bits_equal(pc.allreduce(x, comm), pc.allreduce(x, comm, plan=tuned), "default")
    assert_bits_equal(pc.allreduce(x, comm, plan=None),
                      pc.allreduce(x, comm, plan=None, transport="static"), "plan=None")
    assert_bits_equal(pc.bcast(x, comm, transport="fused"),
                      pc.bcast(x, comm, plan=comm.plan("bcast", 64), transport="fused"),
                      "transport override")
    # an int8 plan runs the compressed wire over the plan's backend
    assert_bits_equal(pc.bcast(x, comm, plan=Plan("static", 1, "ring", wire="int8")),
                      pc.bcast(x, comm, plan=None, transport="compressed:static"), "int8 plan")


#: rank layouts other than the 8-rank testbed: (axis names, axis sizes)
OTHER_TOPOS = {f"ring{n}": (("x",), (n,)) for n in (2, 3, 5, 6, 7)}
OTHER_TOPOS.update({f"torus{a}x{b}": (("x", "y"), (a, b)) for a, b in ((2, 3), (3, 2), (4, 2))})


def _cases_for(P: int) -> dict:
    """Fourteen collectives on ``P`` ranks: name -> (call, rank-stacked
    input); the roots are those of ``CASES`` modulo ``P``."""
    return {
        "allgather": (lambda m, c, t, x: m.stream_allgather(x, c, transport=t), _f32(P, 2, 3)),
        "reduce_scatter": (lambda m, c, t, x: m.stream_reduce_scatter(x, c, transport=t),
                           _f32(P, P * 2, 3, seed=2)),
        "allreduce": (lambda m, c, t, x: m.allreduce(x, c, plan=None, transport=t),
                      _f32(P, 13, 3, seed=3)),
        "allreduce_bidir": (lambda m, c, t, x: m.allreduce(x, c, plan=None, transport=t,
                                                           bidir=True), _f32(P, 40, seed=4)),
        "allreduce_int32": (lambda m, c, t, x: m.allreduce(x, c, plan=None, transport=t),
                            _i32(P, 21, seed=5)),
        "alltoall": (lambda m, c, t, x: m.stream_alltoall(x, c, transport=t),
                     _f32(P, P, 2, 3, seed=6)),
        "bcast_chain": (lambda m, c, t, x: m._stream_bcast_impl(x, c, root=3 % P, n_chunks=2,
                                                                transport=t),
                        _f32(P, 8, 3, seed=7)),
        "reduce_chain": (lambda m, c, t, x: m._stream_reduce_impl(x, c, root=5 % P, n_chunks=4,
                                                                  transport=t),
                         _f32(P, 8, 3, seed=8)),
        "gather": (lambda m, c, t, x: m._stream_gather_impl(x, c, root=2 % P, transport=t),
                   _f32(P, 2, 3, seed=9)),
        "scatter": (lambda m, c, t, x: m._stream_scatter_impl(x, c, root=6 % P, transport=t),
                    _f32(P, P * 2, 3, seed=10)),
        "tree_bcast": (lambda m, c, t, x: m.tree_bcast(x, c, root=1 % P, transport=t),
                       _f32(P, 5, 3, seed=11)),
        "tree_reduce": (lambda m, c, t, x: m.tree_reduce(x, c, root=4 % P, transport=t),
                        _f32(P, 5, 3, seed=12)),
        "staged_bcast": (lambda m, c, t, x: m.staged_bcast(x, c, root=2 % P, transport=t),
                         _f32(P, 5, 3, seed=13)),
        "staged_reduce": (lambda m, c, t, x: m.staged_reduce(x, c, root=P - 1, transport=t),
                          _f32(P, 5, 3, seed=14)),
    }


CASES_14 = sorted(_cases_for(2))


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topo", sorted(OTHER_TOPOS))
@pytest.mark.parametrize("case", CASES_14)
def test_collective_matches_reference_on_other_layouts(case, topo, transport):
    names, sizes = OTHER_TOPOS[topo]
    P = int(np.prod(sizes))
    call, x = _cases_for(P)[case]
    rcomm, rt = RefComm.create(names, sizes), ref_transport(transport)
    mesh = make_test_mesh(sizes, names)
    spec = PS(names[0]) if len(names) == 1 else PS(names)
    want = np.asarray(run_spmd(lambda v: call(rc, rcomm, rt, v[0])[None], mesh, (spec,), spec,
                               x))
    comm = communicator_from_reference(rcomm.topology.to_json(), names, sizes, transport,
                                       device="cpu")
    pt = port_transport(transport)
    xin = to_port(x)
    got = call(pc, comm, pt, xin)
    assert_bits_equal(got, want, f"{case} on {topo}/{transport}")
    assert_stats_equal(pt, rt, f"{case} on {topo}/{transport}")
    assert_bits_equal(xin, x, "input was modified")
