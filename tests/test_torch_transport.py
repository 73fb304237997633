"""The port's transports against ``repro.transport``: permute, shift and
the chunk-pipelined multi-hop p2p on ring(1x8) and torus(2x4), static and
fused, with equal values (bit for bit), zeros on ranks that receive
nothing, and equal steps, bytes and per-tag counters."""

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

from repro_torch.core import ppermute
from repro_torch.transport import get_transport, resolve_comm_mode, resolve_transport

X = np.random.RandomState(0).randn(8, 12, 3).astype(np.float32)

PERMUTES = {
    "ring_plus1": lambda c: c.ring_perm(+1),
    "ring_minus3": lambda c: c.ring_perm(-3),
    "partial": lambda c: [(0, 3), (5, 1), (2, 7)],
    "empty": lambda c: [],
}


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("perm", sorted(PERMUTES))
def test_permute_matches_reference(perm, topo, transport):
    rcomm, rt = ref_comm(topo), ref_transport(transport)
    pairs = PERMUTES[perm](rcomm)
    with rt.tagged("t"):
        want = run_ref(lambda v: rt.permute(v, rcomm, pairs), topo, X)
    pt = port_transport(transport)
    with pt.tagged("t"):
        got = pt.permute(to_port(X), port_comm(topo), pairs)
    assert_bits_equal(got, want, perm)
    assert_stats_equal(pt, rt, perm)
    receivers = {d for _, d in pairs}
    for r in set(range(8)) - receivers:
        assert not got[r].any(), f"rank {r} received nothing but holds data"


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("step", [1, -2, 5])
def test_shift_matches_reference(step, topo, transport):
    rcomm, rt = ref_comm(topo), ref_transport(transport)
    want = run_ref(lambda v: rt.shift(v, rcomm, step), topo, X)
    pt = port_transport(transport)
    got = pt.shift(to_port(X), port_comm(topo), step)
    assert_bits_equal(got, want, f"shift {step}")
    assert_stats_equal(pt, rt)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("src,dst,n_chunks", [(0, 5, 1), (0, 5, 4), (6, 1, 2), (7, 3, 12),
                                              (3, 3, 1)])
def test_p2p_matches_reference(src, dst, n_chunks, topo, transport):
    rcomm, rt = ref_comm(topo), ref_transport(transport)
    with rt.tagged("p2p"):
        want = run_ref(lambda v: rt.p2p(v, src=src, dst=dst, comm=rcomm, n_chunks=n_chunks),
                       topo, X)
    pt = port_transport(transport)
    with pt.tagged("p2p"):
        got = pt.p2p(to_port(X), src=src, dst=dst, comm=port_comm(topo), n_chunks=n_chunks)
    assert_bits_equal(got, want, f"p2p {src}->{dst} x{n_chunks}")
    assert_stats_equal(pt, rt)
    if src != dst:
        assert_bits_equal(got[dst], X[src], "delivered message")
        others = [r for r in range(8) if r != dst]
        assert not got[others].any(), "a rank other than dst holds data"


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_stream_exchange_matches_reference(topo, transport):
    from repro.core import stream_exchange as ref_exchange
    from repro_torch.core import stream_exchange

    pairs = [(0, 1), (1, 0), (6, 7), (7, 6)]
    rcomm, rt = ref_comm(topo), ref_transport(transport)
    want = run_ref(lambda v: ref_exchange(v, pairs=pairs, comm=rcomm, transport=rt, tag="ex"),
                   topo, X)
    pt = port_transport(transport)
    got = stream_exchange(to_port(X), pairs=pairs, comm=port_comm(topo), transport=pt, tag="ex")
    assert_bits_equal(got, want, "stream_exchange")
    assert_stats_equal(pt, rt)
    assert pt.stats.tag_counts("ex") == (1, X[0].nbytes)


def test_ppermute_leaves_input_alone_and_counts_one_rank():
    x = to_port(X)
    before = x.clone()
    y = ppermute(x, [(1, 0)])
    assert_bits_equal(x, before.numpy(), "input")
    assert_bits_equal(y[0], X[1], "moved row")
    t = port_transport("static")
    t.permute(x, port_comm("ring"), [(1, 0)])
    assert t.stats.bytes_moved == X[0].nbytes  # bytes of one rank, not of the stack


def test_registry_keys_and_resolution():
    import os
    import subprocess
    import sys
    from pathlib import Path

    # importing one backend module first must not hide the other keys
    code = ("import repro_torch.transport.fused\n"
            "from repro_torch.transport import available_transports\n"
            "print(available_transports())")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=env, timeout=120).stdout
    assert out.strip() == str(("compressed", "fused", "packet", "packet:pallas", "static"))
    comm = port_comm("torus", transport="fused")
    assert type(resolve_transport(None, comm)).__name__ == "FusedTransport"
    assert resolve_transport("static", comm).device.type == "cpu"
    assert resolve_comm_mode("smi") == ("smi", "static")
    assert resolve_comm_mode("smi:fused") == ("smi", "fused")
    assert resolve_comm_mode(None)[0] == "none"
    from repro_torch.transport.packet import PacketTransport, PallasPacketTransport

    assert type(get_transport("packet", device="cpu")) is PacketTransport
    assert type(resolve_transport("packet:pallas", comm)) is PallasPacketTransport
    assert resolve_comm_mode("smi:packet") == ("smi", "packet")
    assert resolve_comm_mode("smi:packet:pallas") == ("smi", "packet:pallas")
    # the compressed wire composes with any inner backend by key
    for key, inner in (("compressed", "static"), ("compressed:packet", "packet")):
        t = get_transport(key, device="cpu")
        assert type(t).__name__ == "CompressedTransport" and t.inner.name == inner
        assert t.stats is t.inner.stats
        assert resolve_comm_mode(f"smi:{key}") == ("smi", key)
    with pytest.raises(KeyError):
        get_transport("compressed:warp-drive", device="cpu")
    with pytest.raises(KeyError):
        get_transport("warp-drive", device="cpu")
    with pytest.raises(ValueError):
        resolve_comm_mode("smi:warp-drive")
    with pytest.raises(ValueError):
        resolve_comm_mode("bulk:static")
    with pytest.raises(ValueError, match="was given a tensor"):
        get_transport("static", device="cpu").permute(to_port(X).to("meta"), comm, [])
