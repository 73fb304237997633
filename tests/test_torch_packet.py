"""The port's packet transport against the static backend and ``repro``.

Bit for bit (tolerance 0: the packet wire moves 32-bit words and never
computes on them): ``permute``, ``shift``, ``p2p`` and every ported
collective over ``packet`` equal ``static`` on ring(1x8), torus(2x4) and
the snake bus embedded in the 2x4 torus, with ``stats.overflow == 0``.
Steps, bytes and ``by_tag`` equal the reference ``PacketTransport``'s under
``shard_map`` on a few cases and ``repro.netsim``'s predictions on the
rest.  The cases marked ``cuda`` run the same checks through kernel C:

    python -m pytest --noconftest -m cuda tests/test_torch_packet.py
"""

import numpy as np
import pytest
import torch
from _torch_cases import CASES

from repro_torch.core import Communicator, snake_bus
from repro_torch.kernels.router import router_run
from repro_torch.transport import get_transport, resolve_comm_mode
from repro_torch.transport.packet import (
    TBL_CACHE_MAX,
    PacketTransport,
    PallasPacketTransport,
    _decode,
    _encode,
    lru_get,
)

P = 8
#: name -> (axis names, axis sizes, snake bus?)
TOPOS = {"ring": (("x",), (8,), False), "torus": (("x", "y"), (2, 4), False),
         "snake_bus": (("x", "y"), (2, 4), True)}
X = np.random.RandomState(0).randn(8, 12, 3).astype(np.float32)


def _comm(topo, device="cpu"):
    names, sizes, snake = TOPOS[topo]
    return Communicator.create(names, sizes, topology=snake_bus(sizes) if snake else None,
                               device=device)


def _packet(device="cpu", **kw):
    return get_transport("packet", device=device, **kw)


def _bits_equal(a: torch.Tensor, b) -> bool:
    b = b if torch.is_tensor(b) else torch.from_numpy(np.array(b))
    return a.shape == b.shape and a.dtype == b.dtype and a.cpu().contiguous().view(
        torch.uint8).equal(b.cpu().contiguous().view(torch.uint8))


def _lossless(t) -> bool:
    return t.stats.overflow is None or int(t.stats.overflow.sum()) == 0


# -- every step and collective equals static ------------------------------------------

PERMUTES = {
    "ring_plus1": lambda c: c.ring_perm(+1),
    "ring_minus3": lambda c: c.ring_perm(-3),
    "partial": lambda c: [(0, 3), (5, 1), (2, 7)],
    "self_and_partial": lambda c: [(4, 4), (6, 2)],
    "empty": lambda c: [],
}


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("perm", sorted(PERMUTES))
def test_packet_permute_equals_static(perm, topo):
    comm = _comm(topo)
    pairs = PERMUTES[perm](comm)
    x = torch.from_numpy(X)
    tp = _packet(pkt_elems=16)
    got = tp.permute(x, comm, pairs)
    if perm == "empty":
        assert got is x and tp.stats.steps == 0  # nothing moves, nothing is accounted
        return
    want = get_transport("static", device="cpu").permute(x, comm, pairs)
    assert _bits_equal(got, want) and _lossless(tp)
    assert tp.stats.bytes_moved == X[0].nbytes


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("step", [1, -2, 5])
def test_packet_shift_equals_static(step, topo):
    comm, x = _comm(topo), torch.from_numpy(X)
    tp = _packet(pkt_elems=16)
    got = tp.shift(x, comm, step)
    assert _bits_equal(got, get_transport("static", device="cpu").shift(x, comm, step))
    assert _lossless(tp)


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("src,dst", [(0, 5), (6, 1), (7, 3), (3, 3)])
def test_packet_p2p_equals_static(src, dst, topo):
    comm, x = _comm(topo), torch.from_numpy(X)
    tp = _packet(pkt_elems=5)
    got = tp.p2p(x, src=src, dst=dst, comm=comm, n_chunks=4)
    want = get_transport("static", device="cpu").p2p(x, src=src, dst=dst, comm=comm, n_chunks=4)
    assert _bits_equal(got, want) and _lossless(tp)


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_packet_collective_equals_static(case, topo):
    import repro_torch.core.collectives as pc
    from repro_torch.netsim import Plan

    call, x = CASES[case]
    comm, xin = _comm(topo), torch.from_numpy(x)
    tp, ts = _packet(pkt_elems=16), get_transport("static", device="cpu")
    got = call(pc, comm, tp, xin, Plan)
    assert _bits_equal(got, call(pc, comm, ts, xin, Plan)), f"{case} on {topo}"
    assert _lossless(tp) and tp.stats.steps > 0
    assert _bits_equal(xin, x), "input was modified"


# -- accounting against the reference ------------------------------------------------


def _ref_cases():
    """(name, topo, pkt_elems, call(transport, comm, x), tag) of the runs
    held to the reference PacketTransport under ``shard_map``."""
    return [
        ("permute", "torus", 8, lambda t, c, v: t.permute(v, c, c.ring_perm(1)), "t"),
        ("shift", "ring", 16, lambda t, c, v: t.shift(v, c, -2), None),
        ("p2p", "snake_bus", 5, lambda t, c, v: t.p2p(v, src=0, dst=5, comm=c, n_chunks=2), "p"),
        ("shift_snake", "snake_bus", 32, lambda t, c, v: t.shift(v, c, 1), "s"),
        ("transit_overflow", "torus", 4, lambda t, c, v: t.permute(v, c, [(4, 2), (7, 1)]),
         None),
        # the schedule bound is no worst case for a long ring shift of
        # distance 2 on the snake bus: the reference comes up short, and so
        # must the port, rank for rank
        ("snake_shift2_short", "snake_bus", 2, lambda t, c, v: t.shift(v, c, 2), None),
    ]


@pytest.fixture(scope="module")
def ref_runs():
    """Each case of :func:`_ref_cases` on the reference: (values, per-rank
    overflow, steps, bytes, by_tag)."""
    import _torch_ref  # noqa: F401  (loads the reference's transport registry first)
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from repro.core import Communicator as RefComm
    from repro.core import make_test_mesh, run_spmd
    from repro.core.router import snake_bus as ref_snake
    from repro.transport import get_transport as ref_get

    out = {}
    for name, topo, E, call, tag in _ref_cases():
        names, sizes, snake = TOPOS[topo]
        rc = RefComm.create(names, sizes, topology=ref_snake(sizes) if snake else None)
        mesh = make_test_mesh(sizes, names)
        spec = PS(names[0]) if len(names) == 1 else PS(names)
        kw = dict(transit_cap=1) if name == "transit_overflow" else {}
        x = np.ones((8, 64), np.float32) if name == "transit_overflow" else X
        holder = {}

        def fn(v, call=call, E=E, kw=kw, tag=tag, holder=holder, rc=rc):
            t = holder["t"] = ref_get("packet", pkt_elems=E, **kw)
            if tag is None:
                y = call(t, rc, v[0])
            else:
                with t.tagged(tag):
                    y = call(t, rc, v[0])
            return y[None], jnp.asarray(t.stats.overflow, jnp.int32)[None]

        y, ovf = run_spmd(fn, mesh, (spec,), (spec, spec), x)
        t = holder["t"]
        out[name] = (np.asarray(y), np.asarray(ovf), t.stats.steps, t.stats.bytes_moved,
                     dict(t.stats.by_tag), x)
    return out


@pytest.mark.parametrize("case", [c[0] for c in _ref_cases()])
def test_packet_matches_reference_transport(case, ref_runs):
    name, topo, E, call, tag = next(c for c in _ref_cases() if c[0] == case)
    want, want_ovf, steps, nbytes, by_tag, x = ref_runs[name]
    kw = dict(transit_cap=1) if name == "transit_overflow" else {}
    tp = _packet(pkt_elems=E, **kw)
    comm = _comm(topo)
    if tag is None:
        got = call(tp, comm, torch.from_numpy(x))
    else:
        with tp.tagged(tag):
            got = call(tp, comm, torch.from_numpy(x))
    assert _bits_equal(got, want)
    assert tp.stats.overflow.numpy().tolist() == want_ovf.tolist()
    assert (tp.stats.steps, tp.stats.bytes_moved, tp.stats.by_tag) == (steps, nbytes, by_tag)
    if name in ("transit_overflow", "snake_shift2_short"):
        assert int(tp.stats.overflow.sum()) > 0  # a lossy run says so


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_packet_stats_match_netsim_prediction(topo):
    from repro.core import Communicator as RefComm
    from repro.core.router import snake_bus as ref_snake
    from repro.netsim.schedule import predict_transport_stats

    names, sizes, snake = TOPOS[topo]
    rc = RefComm.create(names, sizes, topology=ref_snake(sizes) if snake else None)
    comm, x = _comm(topo), torch.from_numpy(X)
    for E in (4, 32):
        for src, dst in ((0, 5), (7, 2), (1, 6)):
            tp = _packet(pkt_elems=E)
            tp.p2p(x, src=src, dst=dst, comm=comm)
            assert (tp.stats.steps, tp.stats.bytes_moved) == predict_transport_stats(
                rc, "p2p", shape=X.shape[1:], transport="packet", src=src, dst=dst,
                pkt_elems=E)
        tp = _packet(pkt_elems=E)
        tp.shift(x, comm, 1)
        assert (tp.stats.steps, tp.stats.bytes_moved) == predict_transport_stats(
            rc, "shift", shape=X.shape[1:], transport="packet", pkt_elems=E)


# -- the wire --------------------------------------------------------------------------


def test_wire_round_trip_is_bit_exact():
    rng = np.random.RandomState(1)
    ints = rng.randint(-2**31, 2**31 - 1, size=(8, 40), dtype=np.int64).astype(np.int32)
    # NaN and infinity bit patterns as float32, and the extremes
    ints[:, :6] = np.array([0x7FC00001, 0x7F800001, -1, 0x7F800000, -2**31, 2**31 - 1],
                           dtype=np.int64).astype(np.int32)
    cases = [torch.from_numpy(ints), torch.from_numpy(rng.randn(8, 5, 7).astype(np.float32)),
             torch.from_numpy(rng.randn(8, 33)).to(torch.bfloat16),
             torch.from_numpy(rng.randn(8, 33)).to(torch.float16),
             torch.from_numpy(rng.randint(0, 255, (8, 9)).astype(np.uint8))]
    for x in cases:
        wire = _encode(x)
        assert wire.dtype == torch.float32 and wire.shape == (8, x[0].numel())
        assert _bits_equal(_decode(wire, x.shape, x.dtype), x), x.dtype
    for bad in (torch.zeros(8, 3, dtype=torch.int64), torch.zeros(8, 3, dtype=torch.float64)):
        with pytest.raises(TypeError, match="<=32-bit"):
            _encode(bad)


@pytest.mark.parametrize("topo", ["torus", "snake_bus"])
def test_int32_nan_patterns_survive_the_router(topo):
    ints = np.full((8, 50), 0x7FC00001, np.int64).astype(np.int32)
    ints[:, ::3] = np.int64(0xFFBADBAD).astype(np.int32)
    x, comm = torch.from_numpy(ints), _comm(topo)
    tp = _packet(pkt_elems=7)
    got = tp.shift(x, comm, 1)
    assert _bits_equal(got, get_transport("static", device="cpu").shift(x, comm, 1))
    assert _lossless(tp)


# -- runtime routes and the table cache -----------------------------------------------


def test_one_instance_reroutes_torus_then_snake_bus():
    torus = _comm("torus")
    tp, x = _packet(pkt_elems=8), torch.from_numpy(X)
    for comm in (torus, torus.with_topology(snake_bus((2, 4)))):
        got = tp.shift(x, comm, -1)
        assert _bits_equal(got, get_transport("static", device="cpu").shift(x, comm, -1))
    assert _lossless(tp) and len(tp._tbl_cache) == 2
    # sweeping more fabrics than the cache holds keeps it bounded: the eight
    # buses cut out of the 8-ring, each a runtime table of the same fabric
    from repro_torch.core import Topology

    ring, edges = _comm("ring"), [(i, (i + 1) % 8) for i in range(8)]
    for k in range(8):
        tp._route_table(ring.with_topology(Topology.from_edges(8, edges[:k] + edges[k + 1:])))
    assert len(tp._tbl_cache) == TBL_CACHE_MAX


def test_tbl_cache_is_bounded_lru():
    cache: dict = {}
    calls = []
    for i in range(TBL_CACHE_MAX + 4):
        lru_get(cache, i, lambda i=i: calls.append(i) or i * 10)
    assert len(cache) == TBL_CACHE_MAX
    assert 0 not in cache and 3 not in cache  # oldest evicted
    n_calls = len(calls)
    oldest = next(iter(cache))
    assert lru_get(cache, oldest, lambda: None) == oldest * 10
    assert len(calls) == n_calls  # a hit refreshes recency instead of rebuilding
    lru_get(cache, "new", lambda: "v")
    assert oldest in cache


def test_packet_keys_resolve():
    t = get_transport("packet:pallas", device="cpu")
    assert isinstance(t, PallasPacketTransport) and t.router_impl == "kernel"
    assert type(get_transport("packet", device="cpu")) is PacketTransport
    assert resolve_comm_mode("smi:packet") == ("smi", "packet")
    assert resolve_comm_mode("smi:packet:pallas") == ("smi", "packet:pallas")
    # kernel C has no CPU mode: the pinned key refuses the CPU, never falls back
    with pytest.raises(ValueError, match="CUDA"):
        t.shift(torch.from_numpy(X), _comm("torus"), 1)
    with pytest.raises(ValueError, match="partial permutations"):
        _packet().permute(torch.from_numpy(X), _comm("ring"), [(0, 1), (2, 1)])


# -- the stencil over the packet wire ---------------------------------------------------


@pytest.mark.parametrize("overlapped", [True, False], ids=["overlapped", "reference"])
def test_stencil_over_packet_equals_single_rank(overlapped):
    from repro.core import Communicator as RefComm
    from repro.netsim.schedule import predict_halo_stats
    from repro_torch.apps import HALO_TAG, DistributedStencil

    steps = 3
    world = torch.from_numpy(np.random.RandomState(0).randn(64, 64).astype(np.float32))
    app = DistributedStencil.create((2, 4), comm_mode="smi:packet", device="cpu")
    tp = app.halo_schedule.resolve_transport()
    assert isinstance(tp, PacketTransport)
    got = app.run(app.scatter(world), steps, overlapped=overlapped, transport=tp)
    assert _bits_equal(app.gather(got), app.single_rank_reference(world, steps))
    assert _lossless(tp)
    want = predict_halo_stats(RefComm.create(("gx", "gy"), (2, 4)), grid=(2, 4), shape=(32, 16),
                              transport="packet")
    assert tp.stats.tag_counts(HALO_TAG) == (steps * want[0], steps * want[1])


def test_launch_stencil_over_packet_on_cpu(tmp_path, capsys):
    import json

    from repro_torch.launch import stencil as launch_stencil

    out = tmp_path / "r.json"
    assert launch_stencil.main(["--domain", "64x64", "--steps", "2", "--comm-mode", "smi:packet",
                                "--device", "cpu", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["ok"] and res["max_err"] == 0.0 and res["halo_steps"] > 0
    assert "OK" in capsys.readouterr().out


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel C has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["packet", "packet:pallas"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_packet_on_the_card_runs_kernel_c(topo, key, cuda_device):
    comm, x = _comm(topo, cuda_device), torch.from_numpy(X).to(cuda_device)
    tp = get_transport(key, device=cuda_device, pkt_elems=8)
    before = router_run.launches
    got = tp.shift(x, comm, -1)
    torch.cuda.synchronize()
    assert router_run.launches == before + 1
    assert _bits_equal(got, get_transport("static", device=cuda_device).shift(x, comm, -1))
    assert _lossless(tp)
