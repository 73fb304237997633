"""The port's streamed collectives against ``repro.core.collectives``.

Every collective runs on ring(1x8) and torus(2x4) over the static and the
fused wire, from the same numpy inputs on both sides; outputs must agree
bit for bit (tolerance 0: every operation is a copy or the same ordered
float32 add) and the transport counters step for step and byte for byte.
"""

import numpy as np
import pytest
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
from repro.netsim.tune import Plan as RefPlan
from repro_torch.netsim import Plan

P = 8


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _i32(*shape, seed=0):
    return np.random.RandomState(seed).randint(-1000, 1000, size=shape).astype(np.int32)


# name -> (call, rank-stacked input).  One call serves both packages: it
# takes (collectives module, comm, transport, x, Plan class).
CASES = {
    "allgather": (lambda m, c, t, x, _: m.stream_allgather(x, c, transport=t), _f32(P, 2, 3)),
    "allgather_bidir": (lambda m, c, t, x, _: m.stream_allgather(x, c, bidir=True, transport=t),
                        _f32(P, 2, 3, seed=1)),
    "reduce_scatter": (lambda m, c, t, x, _: m.stream_reduce_scatter(x, c, transport=t),
                       _f32(P, P * 2, 3, seed=2)),
    "allreduce": (lambda m, c, t, x, _: m.allreduce(x, c, plan=None, transport=t),
                  _f32(P, 13, 3, seed=3)),
    "allreduce_bidir": (lambda m, c, t, x, _: m.allreduce(x, c, plan=None, transport=t,
                                                          bidir=True), _f32(P, 40, seed=4)),
    "allreduce_int32": (lambda m, c, t, x, _: m.allreduce(x, c, plan=None, transport=t),
                        _i32(P, 21, seed=5)),
    "alltoall": (lambda m, c, t, x, _: m.stream_alltoall(x, c, transport=t),
                 _f32(P, P, 2, 3, seed=6)),
    "bcast_chain": (lambda m, c, t, x, _: m._stream_bcast_impl(x, c, root=3, n_chunks=2,
                                                               transport=t), _f32(P, 8, 3, seed=7)),
    "reduce_chain": (lambda m, c, t, x, _: m._stream_reduce_impl(x, c, root=5, n_chunks=4,
                                                                 transport=t), _f32(P, 8, 3, seed=8)),
    "gather": (lambda m, c, t, x, _: m._stream_gather_impl(x, c, root=2, transport=t),
               _f32(P, 2, 3, seed=9)),
    "scatter": (lambda m, c, t, x, _: m._stream_scatter_impl(x, c, root=6, transport=t),
                _f32(P, P * 2, 3, seed=10)),
    "tree_bcast": (lambda m, c, t, x, _: m.tree_bcast(x, c, root=1, transport=t),
                   _f32(P, 5, 3, seed=11)),
    "tree_reduce": (lambda m, c, t, x, _: m.tree_reduce(x, c, root=4, transport=t),
                    _f32(P, 5, 3, seed=12)),
    "staged_bcast": (lambda m, c, t, x, _: m.staged_bcast(x, c, root=2, transport=t),
                     _f32(P, 5, 3, seed=13)),
    "staged_reduce": (lambda m, c, t, x, _: m.staged_reduce(x, c, root=7, transport=t),
                      _f32(P, 5, 3, seed=14)),
    "bcast_plan_chunks": (lambda m, c, t, x, plan: m.bcast(x, c, root=0, transport=t,
                                                           plan=plan("static", 4, "ring")),
                          _f32(P, 12, seed=15)),
    "reduce_plan_chunks": (lambda m, c, t, x, plan: m.reduce(x, c, root=6, transport=t,
                                                             plan=plan("static", 3, "ring")),
                           _f32(P, 12, seed=16)),
    "reduce_plan_tree": (lambda m, c, t, x, plan: m.reduce(x, c, root=1, transport=t,
                                                           plan=plan("static", 1, "tree")),
                         _f32(P, 12, seed=17)),
    "bcast_plan_staged": (lambda m, c, t, x, plan: m.bcast(x, c, root=5, transport=t,
                                                           plan=plan("static", 1, "staged")),
                          _f32(P, 12, seed=18)),
}


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


def test_dispatchers_default_to_static_and_refuse_auto():
    comm = port_comm("ring")
    x = to_port(_f32(P, 16))
    assert_bits_equal(pc.allreduce(x, comm), pc.allreduce(x, comm, transport="static"), "default")
    with pytest.raises(NotImplementedError, match="tuner"):
        pc.allreduce(x, comm, plan="auto")
    with pytest.raises(NotImplementedError, match="tuner"):
        comm.plan("allreduce", 64)
    with pytest.raises(NotImplementedError, match="compressed"):
        pc.bcast(x, comm, plan=Plan("static", 1, "ring", wire="int8"))
