"""The port's streamed collectives against ``repro.core.collectives``.

Every collective runs on ring(1x8) and torus(2x4) over the static and the
fused wire, from the same numpy inputs on both sides; outputs must agree
bit for bit (tolerance 0: every operation is a copy or the same ordered
float32 add) and the transport counters step for step and byte for byte.
"""

import pytest
from _torch_cases import CASES, _f32
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
