"""The packet wire with ranks as processes (``repro_torch.core.spmd`` +
``core/router.py``'s process path) against the stacked port and the
reference.

P = 8 ranks run as 8 processes (one a rank) and as 2 (four a rank), on the
CPU, each process routing the ranks it holds and the link rows of every
router tick crossing the shared-memory mailboxes.  Bit for bit (tolerance 0:
the router moves 32-bit words and never computes on them): ``run_router``
against the stacked run on a drained run, a run cut at its tick budget and
an overflowing one; the packet ``permute``, ``p2p`` and +-1 shifts on
ring(1x8), torus(2x4) and the snake bus embedded in it against the stacked
packet wire and the reference's ``PacketTransport`` under ``run_spmd``, the
steps, bytes and per-tag counters equal in every process; the 2x4 stencil
over ``smi:packet`` against the single-rank sweep, its ``halo`` counters
the stacked run's; one transport re-routed from the torus to the snake bus.
The rank processes run the functions of ``_torch_spmd_packet_cases`` (no
JAX there).  One group a process layout serves the file.
"""

import numpy as np
import pytest
import torch
from _torch_cases import _f32
from _torch_ref import assert_bits_equal

import _torch_spmd_packet_cases as K
from repro_torch.core import (
    Communicator,
    RouterConfig,
    SpmdGroup,
    Topology,
    make_router_tables,
    run_router,
    snake_bus,
)
from repro_torch.launch import stencil as launch_stencil
from repro_torch.transport import get_transport

P = 8
LAYOUTS = (8, 2)  # rank processes: one a rank, four ranks a process
DIMS = (2, 4)
#: name -> (axis names, axis sizes, snake bus embedded in the torus?)
TOPOS = {"ring": (("x",), (8,), False), "torus": (("x", "y"), DIMS, False),
         "snake_bus": (("x", "y"), DIMS, True)}
PKT = 8  # float32 a packet: the 36-element rows of X go as trains of 5
X = _f32(P, 12, 3, seed=31)
#: a slot holds the bandwidth program's link rows (4,096 float32 a packet, 2 links)
SLOT_BYTES = 64 << 10

_GROUPS: dict = {}


def _group(n_procs: int) -> SpmdGroup:
    g = _GROUPS.get(n_procs)
    if g is None or g.closed:
        g = _GROUPS[n_procs] = SpmdGroup(n_procs, P, device="cpu", slot_bytes=SLOT_BYTES)
    return g


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    for g in _GROUPS.values():
        g.close()


def _comm_args(names, sizes) -> dict:
    return {"axis_names": names, "axis_sizes": sizes}


# -- run_router ----------------------------------------------------------------------------

#: name -> (RouterConfig, tick budget, staged packets a FIFO at most)
ROUTER_CASES = {
    "drained": (RouterConfig(dims=DIMS, n_ports=2, fifo_cap=6, transit_cap=16, out_cap=16,
                             pkt_elems=4, R=4), 64, 6),
    "cut_at_budget": (RouterConfig(dims=DIMS, n_ports=2, fifo_cap=6, transit_cap=16,
                                   out_cap=16, pkt_elems=4, tick_batch=2), 6, 6),
    "overflowing": (RouterConfig(dims=DIMS, n_ports=2, fifo_cap=6, transit_cap=1, out_cap=3,
                                 pkt_elems=4, R=2, switch_bubble=True), 64, 6),
}


def _staged(seed: int, cfg: RouterConfig, most: int):
    rng = np.random.RandomState(seed)
    pay = rng.randn(P, cfg.n_ports, cfg.fifo_cap, cfg.pkt_elems).astype(np.float32)
    # never a rank's own: a packet to itself is never routed
    dst = (np.arange(P).reshape(P, 1, 1) + rng.randint(1, P, (P, cfg.n_ports, cfg.fifo_cap))
           ) % P
    dst = dst.astype(np.int32)
    ln = rng.randint(0, most + 1, (P, cfg.n_ports)).astype(np.int32)
    return [torch.from_numpy(a) for a in (pay, dst, ln)]


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_router_equals_stacked(n_procs, case):
    cfg, n_steps, most = ROUTER_CASES[case]
    pay, dst, ln = _staged(sorted(ROUTER_CASES).index(case) + 40, cfg, most)
    tbl = torch.from_numpy(make_router_tables(Topology.torus(DIMS), DIMS))
    comm = Communicator.create(("x", "y"), DIMS, device="cpu")
    want = run_router(cfg, comm, tbl, pay, dst, ln, n_steps)
    for w, s in zip(want, run_router(cfg, comm, tbl, pay, dst, ln, n_steps, impl="scalar")):
        assert torch.equal(w, s)
    got = _group(n_procs).run(K.router, _comm_args(("x", "y"), DIMS), pay, dst, ln, cfg=cfg,
                              tbl=tbl, n_steps=n_steps)
    for name, w in zip(("out_pay", "out_cnt", "overflow", "t_done"), want):
        assert_bits_equal(got[name], w.numpy(), f"{name} of {case} at {n_procs} processes")
    delivered, lost = int(want[1].sum()), int(want[2].sum())
    if case == "overflowing":
        assert lost > 0
    if case == "cut_at_budget":  # the budget ends the run with packets still staged
        assert delivered + lost < int(ln.sum())
    if case == "drained":
        assert lost == 0 and delivered == int(ln.sum())


def test_process_router_refuses_the_scalar_oracle_and_a_partial_table():
    from dataclasses import replace

    cfg, n_steps, most = ROUTER_CASES["drained"]
    pay, dst, ln = _staged(40, cfg, most)
    tbl = torch.from_numpy(make_router_tables(Topology.torus(DIMS), DIMS))
    comm = replace(Communicator.create(("x", "y"), DIMS, device="cpu"), lo=4, n_local=4,
                   group=object())
    with pytest.raises(ValueError, match="scalar"):
        run_router(cfg, comm, tbl, pay[4:], dst[4:], ln[4:], n_steps, impl="scalar")
    with pytest.raises(ValueError, match="whole"):
        run_router(cfg, comm, tbl[4:], pay[4:], dst[4:], ln[4:], n_steps)
    with pytest.raises(ValueError, match="CUDA"):
        run_router(cfg, comm, tbl, pay[4:], dst[4:], ln[4:], n_steps, impl="kernel")
    # the key pinned to kernel C refuses the CPU in process mode too: no fall back
    with pytest.raises(ValueError, match="CUDA"):
        get_transport("packet:pallas", device="cpu").shift(torch.from_numpy(X[4:]), comm, 1)


# -- the packet wire against the stacked wire and the reference --------------------------

_REF: dict = {}


def _reference(topo: str) -> dict:
    """The reference's ``PacketTransport`` under ``run_spmd`` on ``topo``,
    every step of :func:`K.packet_steps` in one program (cached): name ->
    (rows, per-rank overflow, steps, bytes, by_tag)."""
    if topo not in _REF:
        import _torch_ref  # noqa: F401  (loads the reference's transport registry first)
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as PS

        from repro.core import Communicator as RefComm
        from repro.core import make_test_mesh, run_spmd
        from repro.core.router import snake_bus as ref_snake
        from repro.transport import get_transport as ref_get

        names, sizes, snake = TOPOS[topo]
        rc = RefComm.create(names, sizes, topology=ref_snake(sizes) if snake else None)
        steps = {"permute": lambda t, v: t.permute(v, rc, K.PARTIAL),
                 "shift+1": lambda t, v: t.shift(v, rc, 1),
                 "shift-1": lambda t, v: t.shift(v, rc, -1),
                 "p2p": lambda t, v: t.p2p(v, src=0, dst=5, comm=rc, n_chunks=2)}
        holder = {}

        def fn(v):
            outs = []
            for name, step in steps.items():
                t = holder[name] = ref_get("packet", pkt_elems=PKT)
                with t.tagged(name):
                    outs.append(step(t, v[0])[None])
                outs.append(jnp.asarray(t.stats.overflow, jnp.int32)[None])
            return tuple(outs)

        spec = PS(names[0]) if len(names) == 1 else PS(names)
        out = run_spmd(fn, make_test_mesh(sizes, names), (spec,), (spec,) * 8, X)
        _REF[topo] = {name: (np.asarray(out[2 * i]), np.asarray(out[2 * i + 1]),
                             holder[name].stats.steps, holder[name].stats.bytes_moved,
                             dict(holder[name].stats.by_tag))
                      for i, name in enumerate(steps)}
    return _REF[topo]


_GOT: dict = {}


def _process_steps(n_procs: int, topo: str) -> dict:
    key = (n_procs, topo)
    if key not in _GOT:
        names, sizes, snake = TOPOS[topo]
        _GOT[key] = _group(n_procs).run(K.packet_steps, _comm_args(names, sizes),
                                        torch.from_numpy(X), snake, PKT)
    return _GOT[key]


@pytest.mark.parametrize("step", ["permute", "shift+1", "shift-1", "p2p"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_packet_wire_matches_stacked_and_reference(n_procs, topo, step):
    got = _process_steps(n_procs, topo)[step]
    names, sizes, snake = TOPOS[topo]
    comm = Communicator.create(names, sizes, topology=snake_bus(sizes) if snake else None,
                               device="cpu")
    stacked = K.packet_steps(comm, torch.from_numpy(X), False, PKT)[step]
    want, want_ovf, steps, nbytes, by_tag = _reference(topo)[step]
    what = f"{step} on {topo} at {n_procs} processes"
    assert_bits_equal(got["y"], want, what)
    assert_bits_equal(got["y"], stacked["y"].numpy(), what)
    assert_bits_equal(got["overflow"], want_ovf, f"{what}: overflow")
    assert int(got["overflow"].sum()) == 0
    assert got["stats"] == [(steps, nbytes, by_tag)] * n_procs, what
    assert stacked["stats"] == (steps, nbytes, by_tag), what


# -- the stencil, the launcher, the table swap --------------------------------------------


@pytest.fixture(scope="module")
def world():
    return torch.from_numpy(np.random.RandomState(3).randn(32, 32).astype(np.float32))


@pytest.mark.parametrize("overlapped", [True, False], ids=["overlapped", "reference"])
@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_packet_stencil_equals_single_rank(n_procs, overlapped, world):
    import _torch_spmd_cases as S

    from repro_torch.apps import HALO_TAG, DistributedStencil

    steps = 2
    app = DistributedStencil.create(DIMS, comm_mode="smi:packet", device="cpu")
    tiles = app.scatter(world)
    tp = app.halo_schedule.resolve_transport(tiles)
    stacked = app.run(tiles, steps, overlapped=overlapped, transport=tp)
    got = _group(n_procs).run(S.stencil, _comm_args(("gx", "gy"), DIMS), tiles, steps,
                              overlapped, "packet")
    assert_bits_equal(app.gather(got["tiles"]), app.single_rank_reference(world, steps).numpy(),
                      f"stencil over packet at {n_procs} processes")
    assert_bits_equal(got["tiles"], stacked.numpy(), "against the stacked packet run")
    assert got["halo"] == [tp.stats.tag_counts(HALO_TAG)] * n_procs


def test_launch_stencil_packet_process_mode_on_cpu(tmp_path, capsys):
    import json

    out = tmp_path / "r.json"
    argv = ["--device", "cpu", "--domain", "16x16", "--steps", "2", "--comm-mode", "smi:packet",
            "--ranks", "process", "--procs", "2", "--json", str(out)]
    assert launch_stencil.main(argv, group=_group(2)) == 0
    res = json.loads(out.read_text())
    assert res["ok"] and res["max_err"] == 0.0 and res["halo_backend"] == "packet"
    assert res["launches_c"] == [0, 0]  # the plain version on the CPU
    assert "ranks=process procs=2" in capsys.readouterr().out


@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_packet_reroutes_torus_then_snake_bus(n_procs):
    x = torch.from_numpy(X)
    got = _group(n_procs).run(K.reroute, _comm_args(("x", "y"), DIMS), x, PKT)
    torus = Communicator.create(("x", "y"), DIMS, device="cpu")
    static = get_transport("static", device="cpu")
    for name, comm in (("torus", torus), ("snake_bus", torus.with_topology(snake_bus(DIMS)))):
        assert_bits_equal(got[name], static.shift(x, comm, -1).numpy(), name)
    assert got["tables"] == [2] * n_procs
    assert int(got["overflow"].sum()) == 0


@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_channels_over_packet(n_procs):
    """``launch.channels``'s latency and bandwidth programs over the packet
    wire with the ranks as processes: every delivery and push/pop loop
    passes the launcher's own checks (it raises otherwise)."""
    from repro_torch.launch.channels import HOPS, bandwidth, latency

    lat = latency("cpu", ("packet",), count=4, reps=1, group=_group(n_procs))
    bw = bandwidth("cpu", (1,), ("packet",), reps=1, group=_group(n_procs))
    assert [(r["hops"], r["wire"]) for r in lat] == [(h, "packet") for _, h in HOPS]
    assert [r["wire"] for r in bw] == ["packet", "staged"] * len(HOPS)
    assert all(r["ranks"] == "process" for r in lat + bw)


@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_packet_p2p_and_push_pop_equal_stacked(n_procs):
    """Channel transfers at 1, 4 and 7 hops on the 8-rank bus and a push/pop
    loop over the packet wire, ranks as processes, against the stacked run."""
    import _torch_spmd_cases as S

    from repro_torch.core import Topology

    comm_args = {"axis_names": ("x",), "axis_sizes": (P,), "topology": Topology.bus(P)}
    x = torch.from_numpy(_f32(P, 8, seed=32))
    got = _group(n_procs).run(S.p2p, comm_args, x, transport="packet")
    comm = Communicator.create("x", (P,), topology=Topology.bus(P), device="cpu")
    want = S.p2p(comm, x, transport="packet")
    for dst, w in want.items():
        for key in ("y", "oks", "vals", "popped"):
            assert_bits_equal(got[dst][key], w[key].numpy(), f"{key} to {dst}")
        assert got[dst]["stats"] == [w["stats"]] * n_procs
