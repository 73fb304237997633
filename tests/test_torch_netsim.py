"""The port's netsim (``repro_torch.netsim``) and its ``plan="auto"`` path
against ``repro.netsim`` and ``repro``'s tuned dispatchers, on the CPU.

* **model** — every ``LinkModel`` method equals the reference's, for the
  reference's defaults, the port's (the card's fit) and one other set;
  ``fit`` within 1e-12 relative (numpy ``lstsq`` on both sides),
  ``validate`` and ``drift_ratio`` equal;
* **simulator** — ``simulate`` and ``simulate_rounds`` give equal reports
  (ticks, per-link occupancy and queues, stalls, drops, the move log) on
  the reference's own cases (tests/test_netsim.py) and on seeded random
  message sets;
* **exactness** — ``predict_transport_stats``, ``predict_halo_stats`` and
  ``predict_channel_stats`` equal the port's ``TransportStats`` after a run
  on the CPU (and the reference's predictions), static and packet, on the
  ring, the 2x4 torus and the snake bus;
* **tuner** — ``autotune`` gives the reference's tables (plans and
  scores) on ring(8), torus(2x4), the snake bus and torus(8x8), under the
  reference's model and under the port's default; tables cross between
  the packages as JSON;
* **plan="auto"** — ``bcast``/``reduce``/``allreduce`` equal the
  reference's under the same table: bit for bit on raw plans, within the
  int8 codec's bound on int8 plans; the tuned halo equals the static
  schedule bit for bit; ``Communicator.plan`` is cached per route table.

The reference side imports JAX inside fixtures, so the ``cuda`` cases
(phase 26's checks at small sizes) run on the card with::

    python -m pytest --noconftest -m cuda tests/test_torch_netsim.py
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.core.collectives as pc
import repro_torch.netsim as pn
from repro_torch.apps import DistributedStencil, HaloExchange
from repro_torch.channels import open_channel
from repro_torch.core import Communicator, Topology, snake_bus
from repro_torch.core.routing import compute_route_table
from repro_torch.netsim import tune as ptune
from repro_torch.transport import get_transport

P = 8
FIELDS = ("hop_latency", "link_bw", "injection_base", "switch_cycles", "quant_latency",
          "unfused_add_latency")
#: a parameter set that is neither package's default
OTHER = dict(hop_latency=3.7e-5, link_bw=2.9e10, injection_base=1.1e-4, switch_cycles=0.7,
             quant_latency=2.2e-4, unfused_add_latency=1.9e-5)
#: a slow link, under which the int8 wire wins small all-reduces
SLOW = dict(link_bw=1e8)


def _f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _codec_atol(x, hops_quantised=1):
    """The reference's bound (tests/test_compressed.py): ``hops_quantised``
    int8 roundings of data bounded by max|x|, half a step of max|x| / 127."""
    return hops_quantised * float(np.max(np.abs(x))) / 254.0 * 1.05 + 1e-6


@pytest.fixture(scope="module")
def R():
    """The reference side (imports JAX)."""
    import repro.netsim as rn
    from repro.core import Communicator as RComm
    from repro.core import Topology as RTopo
    from repro.core.router import snake_bus as rsnake
    from repro.core.routing import compute_route_table as rroutes
    from repro.netsim import calibrate as rcal
    from repro.netsim import tune as rtune

    return SimpleNamespace(ns=rn, cal=rcal, tune=rtune, Topology=RTopo, Comm=RComm,
                           snake=rsnake, routes=rroutes)


@pytest.fixture(autouse=True)
def _fresh_tables():
    """Every test starts and ends with empty tuning caches in both packages
    (the cache is keyed by topology, not by model)."""
    import sys

    def clear():
        ptune.clear_cache()
        if "repro.netsim.tune" in sys.modules:
            sys.modules["repro.netsim.tune"].clear_cache()

    clear()
    yield
    clear()


def _models(R, which):
    """(reference model, port model) with equal fields."""
    if which == "reference_default":
        vals = {f: getattr(R.ns.LinkModel(), f) for f in FIELDS}
    elif which == "port_default":
        vals = {f: getattr(pn.LinkModel(), f) for f in FIELDS}
    elif which == "slow":
        vals = {f: getattr(R.ns.LinkModel(), f) for f in FIELDS} | SLOW
    else:
        vals = OTHER
    return R.ns.LinkModel(**vals), pn.LinkModel(**vals)


#: topology name -> builder taking (Topology, snake_bus)
TOPOS = {
    "ring8": lambda T, s: T.ring(8),
    "torus2x4": lambda T, s: T.torus((2, 4)),
    "snake_bus": lambda T, s: s((2, 4)),
    "bus8": lambda T, s: T.bus(8),
    "bus4": lambda T, s: T.bus(4),
    "torus8x8": lambda T, s: T.torus((8, 8)),
}


def _topos(R, name):
    """(reference topology and routes, port topology and routes)."""
    rt = TOPOS[name](R.Topology, R.snake)
    pt = TOPOS[name](Topology, snake_bus)
    assert rt.to_json() == pt.to_json()
    return (rt, R.routes(rt)), (pt, compute_route_table(pt))


# -- the link cost model -----------------------------------------------------------------


@pytest.mark.parametrize("which", ["reference_default", "port_default", "other"])
def test_link_model_methods_equal_reference(R, which):
    rm, pm = _models(R, which)
    sizes = (0, 1, 4, 31, 1000, 4096, 1 << 20, 3 * (1 << 22) + 7)
    for n in sizes:
        assert pm.serialization(n) == rm.serialization(n)
        assert pm.hop_time(n) == rm.hop_time(n)
        for wire in ("raw", "int8"):
            assert pm.wire_bytes(n, wire) == rm.wire_bytes(n, wire)
            assert pm.hop_time_wire(n, wire) == rm.hop_time_wire(n, wire)
        for hops in range(9):
            assert pm.staged_time(n, hops) == rm.staged_time(n, hops)
            for nc in (1, 2, 4, 16, 32):
                assert pm.p2p_time(n, hops, nc) == rm.p2p_time(n, hops, nc)
                assert pm.bandwidth(n, hops, nc) == rm.bandwidth(n, hops, nc)
        assert pn.int8_wire_nbytes(n) == R.ns.int8_wire_nbytes(n)
        assert pn.int8_wire_nbytes(n, 7) == R.ns.int8_wire_nbytes(n, 7)
    with pytest.raises(ValueError):
        pm.wire_bytes(4, "fp8")
    for Rs in range(-1, 18):
        assert pm.injection_cycles(Rs) == rm.injection_cycles(Rs)
    for c, m in ((1e-3, 2e-3), (5e-4, 1e-4)):
        assert pm.overlapped_step_time(c, m) == rm.overlapped_step_time(c, m)
        assert pm.serial_step_time(c, m) == rm.serial_step_time(c, m)
    rec = {"steps": 19, "bytes": 123456.0}
    assert pm.predict(rec) == rm.predict(rec)
    assert dataclasses.asdict(pm.with_params(link_bw=1e9)) == \
        dataclasses.asdict(rm.with_params(link_bw=1e9))
    assert not hasattr(pm, "default_v5e")


def _records(seed, collinear=False):
    rng = np.random.RandomState(seed)
    true = dict(hop_latency=3e-5 * (1 + rng.rand()), link_bw=2e10 * (1 + rng.rand()),
                injection_base=1e-4 * rng.rand())
    recs = []
    for i in range(12):
        steps = int(rng.randint(1, 40))
        nbytes = 32.0 * steps if collinear else float(rng.randint(32, 1 << 26))
        t = (true["injection_base"] + steps * true["hop_latency"] + nbytes / true["link_bw"])
        recs.append({"steps": steps, "bytes": nbytes, "seconds": t * (1 + 0.2 * rng.randn()),
                     "name": f"r{i}"})
    return recs


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "collinear", "clamped"])
def test_fit_validate_and_drift_equal_reference(R, case, capsys):
    if case == "collinear":
        recs = _records(3, collinear=True)  # the latency records: bytes = 32 x steps
    elif case == "clamped":
        recs = [{"steps": 1, "bytes": 8.0, "seconds": 5e-4},   # a negative intercept and
                {"steps": 2, "bytes": 8.0, "seconds": 1e-4},   # hop time: base's values
                {"steps": 9, "bytes": 1e6, "seconds": 2e-5}]
    else:
        recs = _records(int(case[-1]))
    rbase, pbase = _models(R, "other")
    rfit, pfit = R.ns.fit(recs, base=rbase), pn.fit(recs, base=pbase)
    for f in FIELDS:
        want, got = getattr(rfit, f), getattr(pfit, f)
        assert got == pytest.approx(want, rel=1e-12, abs=0), (f, got, want)
    assert pn.fit([], base=pbase) == pbase
    for tol in (2.0, 1.01):
        outcomes = []
        for mod, base in ((R.cal, rbase), (pn.calibrate, pbase)):
            try:
                m, worst = mod.validate(recs, tol=tol, model=mod.fit(recs, base=base))
                outcomes.append(("ok", worst, [m.predict(r) for r in recs]))
            except AssertionError as e:
                outcomes.append(("fail", str(e).splitlines()[0], None))
        (rk, rw, rp), (pk, pw, pp) = outcomes
        assert pk == rk
        if rk == "ok":
            assert pw == pytest.approx(rw, rel=1e-12)
            np.testing.assert_allclose(pp, rp, rtol=1e-12)
        else:
            assert pw == rw
    for a, b in ((1e-3, 2e-3), (0.0, 1e-6), (5.0, 5.0), (-1.0, 1.0)):
        assert pn.calibrate.drift_ratio(a, b) == R.cal.drift_ratio(a, b)
    assert pn.record(3, 96, 1e-5, "x") == R.cal.record(3, 96, 1e-5, "x")
    capsys.readouterr()


# -- the simulator -------------------------------------------------------------------------


def _report(rep) -> dict:
    return dataclasses.asdict(rep)


def _sim_both(ref, name, msgs, **kw):
    (rt, rrt), (pt, prt) = _topos(ref, name)
    rmsgs = [ref.ns.Message(**m) for m in msgs]
    pmsgs = [pn.Message(**m) for m in msgs]
    try:
        want = ref.ns.simulate(rt, rrt, rmsgs, trace=True, **kw)
    except AssertionError as e:  # a backpressure deadlock trips the runaway guard
        with pytest.raises(AssertionError, match=str(e).split(" (")[0]):
            pn.simulate(pt, prt, pmsgs, trace=True, **kw)
        return None
    got = pn.simulate(pt, prt, pmsgs, trace=True, **kw)
    assert _report(got) == _report(want), (name, msgs, kw)
    return got


def test_simulate_equals_reference_on_the_reference_cases(R):
    """The cases of tests/test_netsim.py: pipelined p2p on the bus,
    contention and backpressure, R-sticky arbitration with the switch
    bubble, delivery drops at an undersized out_cap."""
    for nc in (1, 2, 8):
        for dst in (1, 4, 7):
            rep = _sim_both(R, "bus8", [dict(src=0, dst=dst, n_flits=nc,
                                             flit_bytes=4096.0 / nc)])
            assert rep.ticks == nc + dst - 1
    two = [dict(src=0, dst=4, n_flits=6, flit_bytes=64.0),
           dict(src=1, dst=4, n_flits=6, flit_bytes=64.0)]
    for kw in ({}, {"fifo_depth": 1}):
        _sim_both(R, "bus8", two, **kw)
    assert _sim_both(R, "bus8", two, fifo_depth=1).stalls > 0
    ports = [dict(src=0, dst=3, n_flits=8, flit_bytes=32.0, port=0, pipelined=False),
             dict(src=0, dst=3, n_flits=8, flit_bytes=32.0, port=1, pipelined=False)]
    for kw in ({}, {"R": 1, "switch_bubble": True}, {"R": 16, "switch_bubble": True}):
        _sim_both(R, "bus4", ports, **kw)
    three = [dict(src=s, dst=0, n_flits=1, flit_bytes=64.0) for s in (1, 2, 3)]
    assert _sim_both(R, "ring8", three, out_cap=1).dropped == 2


@pytest.mark.parametrize("name", ["ring8", "torus2x4", "snake_bus"])
def test_simulate_rounds_equals_reference_on_collective_rounds(R, name):
    """Every collective's rounds under every algorithm, the compressed
    reduce-scatter, the halo rounds and a p2p, replayed in both packages;
    each builder's rounds equal too."""
    (rt, rrt), (pt, prt) = _topos(R, name)
    cases = [("bcast", a, nc) for a in ("ring", "tree", "staged") for nc in (1, 4, 16)]
    cases += [("reduce", a, 4) for a in ("ring", "tree", "staged")]
    cases += [(op, "ring", 1) for op in ("allgather", "reduce_scatter", "allreduce")]
    rounds = [(R.ns.collective_rounds(rt, rrt, op, a, 4096.0, n_chunks=nc, root=r),
               pn.collective_rounds(pt, prt, op, a, 4096.0, n_chunks=nc, root=r))
              for op, a, nc in cases for r in (0, 5)]
    rounds.append((R.ns.compressed_reduce_scatter_rounds(P, 512.0),
                   pn.compressed_reduce_scatter_rounds(P, 512.0)))
    rounds.append((R.ns.halo_rounds((2, 4), 4096.0, 2048.0),
                   pn.halo_rounds((2, 4), 4096.0, 2048.0)))
    rounds.append(([R.ns.p2p_messages(rrt, 0, 5, 1e5, 8)], [pn.p2p_messages(prt, 0, 5, 1e5, 8)]))
    for rr, pr in rounds:
        assert [[dataclasses.asdict(m) for m in msgs] for msgs in pr] == \
            [[dataclasses.asdict(m) for m in msgs] for msgs in rr]
        rticks, rs, rreps = R.ns.simulate_rounds(rt, rrt, rr, model=R.ns.LinkModel())
        pticks, ps, preps = pn.simulate_rounds(pt, prt, pr,
                                               model=_models(R, "reference_default")[1])
        assert (pticks, ps) == (rticks, rs)
        assert [_report(r) for r in preps] == [_report(r) for r in rreps]
        assert pn.simulate_rounds(pt, prt, pr)[1] is None


@pytest.mark.parametrize("seed", range(16))
def test_simulate_equals_reference_on_random_messages(R, seed):
    rng = np.random.RandomState(seed)
    name = ("ring8", "torus2x4", "snake_bus")[seed % 3]
    msgs = []
    for _ in range(rng.randint(1, 7)):
        src = int(rng.randint(P))
        dst = int((src + rng.randint(1, P)) % P)
        msgs.append(dict(src=src, dst=dst, n_flits=int(rng.randint(1, 6)),
                         flit_bytes=float(rng.randint(1, 4096)), t_start=int(rng.randint(4)),
                         port=int(rng.randint(2)), pipelined=bool(rng.randint(2))))
    kw = dict(fifo_depth=(None, 1, 2)[rng.randint(3)], R=(None, 1, 4)[rng.randint(3)],
              switch_bubble=bool(rng.randint(2)), out_cap=(None, 2)[rng.randint(2)])
    _sim_both(R, name, msgs, **kw)


def test_simulator_runaway_guard():
    topo = Topology.ring(4)
    rt = compute_route_table(topo)
    assert pn.sim.MAX_TICKS_FACTOR == 64
    bad = pn.Message(0, 2, n_flits=1, path=[0, 1, 0, 1, 2])  # revisits, still delivers
    assert pn.simulate(topo, rt, [bad]).ticks == 4
    with pytest.raises(AssertionError, match="not a topology link"):
        pn.simulate(topo, rt, [pn.Message(0, 2, path=[0, 2])])


# -- exactness: predictions equal the port's TransportStats ---------------------------------

EXACT_TOPOS = {"ring": (("x",), (8,), lambda s: Topology.ring(8)),
               "torus": (("x", "y"), (2, 4), lambda s: None),
               "snake_bus": (("x", "y"), (2, 4), snake_bus)}


def _comm(topo):
    names, sizes, make = EXACT_TOPOS[topo]
    return Communicator.create(names, sizes, topology=make(sizes), device="cpu")


def _ref_comm(R, topo):
    names, sizes, _ = EXACT_TOPOS[topo]
    make = {"ring": lambda s: R.Topology.ring(8), "torus": lambda s: None,
            "snake_bus": R.snake}[topo]
    return R.Comm.create(names, sizes, topology=make(sizes))


def _lossless(t):
    return t.stats.overflow is None or int(t.stats.overflow.sum()) == 0


@pytest.mark.parametrize("backend", ["static", "packet"])
@pytest.mark.parametrize("topo", sorted(EXACT_TOPOS))
def test_predicted_p2p_stats_equal_the_run(R, topo, backend):
    comm = _comm(topo)
    shape, n_chunks, dst = (8, 16), 4, 5
    x = torch.from_numpy(_f32(P, *shape, seed=0))
    t = get_transport(backend, device="cpu")
    y = t.p2p(x, src=0, dst=dst, comm=comm, n_chunks=n_chunks)
    assert _lossless(t) and torch.equal(y[dst], x[0])
    want = pn.predict_transport_stats(comm, "p2p", shape=shape, src=0, dst=dst,
                                      n_chunks=n_chunks, transport=backend)
    assert (t.stats.steps, t.stats.bytes_moved) == want
    assert want == R.ns.predict_transport_stats(_ref_comm(R, topo), "p2p", shape=shape, src=0,
                                                dst=dst, n_chunks=n_chunks, transport=backend)
    rec = pn.record_from_stats(t.stats, 1e-3, "probe")
    assert (rec["steps"], rec["bytes"], rec["seconds"], rec["name"]) == (*want, 1e-3, "probe")
    assert rec["overflow"] == (0 if backend == "packet" else None)


def test_predicted_allgather_and_packet_shift_equal_the_run(R):
    """Ring only, as in the reference: on the other layouts the simulator
    charges a linearised shift's wrap edges their routed cost while the
    static wire counts one step a permute."""
    comm = _comm("ring")
    t = get_transport("static", device="cpu")
    pc.stream_allgather(torch.from_numpy(_f32(P, 4, 8, seed=1)), comm, transport=t)
    want = pn.predict_transport_stats(comm, "allgather", shape=(4, 8))
    assert (t.stats.steps, t.stats.bytes_moved) == want
    t = get_transport("packet", device="cpu")
    t.shift(torch.from_numpy(_f32(P, 8, 8, seed=2)), comm)
    want = pn.predict_transport_stats(comm, "shift", shape=(8, 8), transport="packet")
    assert _lossless(t) and (t.stats.steps, t.stats.bytes_moved) == want
    rc = _ref_comm(R, "ring")
    assert want == R.ns.predict_transport_stats(rc, "shift", shape=(8, 8), transport="packet")


@pytest.mark.parametrize("backend", ["static", "packet", "compressed"])
@pytest.mark.parametrize("topo", sorted(EXACT_TOPOS))
def test_predicted_halo_stats_equal_the_run(R, topo, backend):
    comm = _comm(topo)
    he = HaloExchange(comm=comm, grid=(2, 4), transport=backend)
    x = torch.from_numpy(_f32(P, 12, 10, seed=3))
    t = he.resolve_transport(x)
    he.exchange(x, transport=t)
    want = he.predicted_stats((12, 10), transport=backend)
    assert t.stats.tag_counts("halo") == want
    assert want == R.ns.predict_halo_stats(_ref_comm(R, topo), grid=(2, 4), shape=(12, 10),
                                           transport=backend)
    assert he.predicted_stats((12, 10), dtype=torch.float32, transport=backend) == want


@pytest.mark.parametrize("backend", ["static", "fused", "packet", "compressed:static"])
@pytest.mark.parametrize("topo", sorted(EXACT_TOPOS))
def test_predicted_channel_stats_equal_the_run(topo, backend):
    comm = _comm(topo)
    x = torch.from_numpy(_f32(P, 16, 4, seed=4))
    ch = open_channel(comm, src=1, dst=6, port=3, n_chunks=2,
                      transport=get_transport(backend, device="cpu"))
    t = ch.spec.resolve()
    with ch:
        ch.transfer(x)
    assert t.stats.tag_counts(ch.spec.stats_tag) == \
        pn.predict_channel_stats(ch.spec, shape=(16, 4))


def test_predicted_halo_time_equals_reference(R):
    rm, pm = _models(R, "other")
    for topo in sorted(EXACT_TOPOS):
        comm, rc = _comm(topo), _ref_comm(R, topo)
        for wire in ("raw", "int8"):
            want = R.ns.predict_halo_time(rc, grid=(2, 4), shape=(64, 32), model=rm, wire=wire)
            assert pn.predict_halo_time(comm, grid=(2, 4), shape=(64, 32), model=pm,
                                        wire=wire) == want
        app = DistributedStencil.create((2, 4), comm=comm)
        got = app.predicted_step_time((64, 32), model=pm, compute_seconds=1e-4)
        assert got == max(1e-4, pn.predict_halo_time(comm, grid=(2, 4), shape=(64, 32), model=pm))
        assert app.predicted_step_time((64, 32), model=pm, overlapped=False,
                                       compute_seconds=1e-4) == pytest.approx(
            1e-4 + app.halo_schedule.predicted_time((64, 32), model=pm), rel=1e-15)
        assert app.predicted_step_time((64, 32)) == \
            app.halo_schedule.predicted_time((64, 32), model=pn.LinkModel())


# -- the tuner --------------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["reference_default", "port_default"])
@pytest.mark.parametrize("name", ["ring8", "torus2x4", "snake_bus", "torus8x8"])
def test_autotune_tables_equal_reference(R, name, which):
    """Equal tables: the same plan and the same score (and static default's
    score) in every (op, size) cell, the same signature and lookups."""
    (rt, rrt), (pt, prt) = _topos(R, name)
    rm, pm = _models(R, which)
    want = R.ns.autotune(rt, rrt, model=rm)
    got = pn.autotune(pt, prt, model=pm)
    assert got.topo_sig == want.topo_sig
    assert got.entries == want.entries
    for op in ptune.OPS:
        for n in (1, 700, 3000, 1 << 16, 5 << 20, 1 << 30):
            assert got.lookup(op, n).to_dict() == want.lookup(op, n).to_dict()
    for (op, size), e in got.entries.items():
        assert e["score"] <= e["static_score"] + 1e-18
    if name != "torus8x8":
        for (op, size), e in got.entries.items():
            plan = pn.Plan(e["transport"], e["n_chunks"], e["algo"], e["wire"])
            assert pn.score_plan(pt, prt, op, size, plan, pm) == e["score"]


def test_tuner_constants_equal_reference(R):
    for name in ("SIZE_GRID", "N_CHUNKS_GRID", "OPS", "ALGOS", "PACKET_ELEMS", "PACKET_R",
                 "WIRES"):
        assert getattr(ptune, name) == getattr(R.tune, name), name
    assert ptune.DEFAULT_PLAN.to_dict() == R.tune.DEFAULT_PLAN.to_dict()
    assert sorted(pn.__all__) == sorted(R.ns.__all__)


def test_tuning_tables_cross_between_the_packages_as_json(R, tmp_path):
    (rt, rrt), (pt, prt) = _topos(R, "ring8")
    rm, pm = _models(R, "port_default")
    mine = pn.autotune(pt, prt, model=pm, sizes=(1 << 10, 1 << 16, 1 << 22))
    theirs = R.ns.autotune(rt, rrt, model=R.ns.LinkModel(), sizes=(1 << 12, 1 << 20))
    mine.save(str(tmp_path / "port.json"))
    theirs.save(str(tmp_path / "ref.json"))
    for table, loaded in ((mine, R.ns.TuningTable.load(str(tmp_path / "port.json"))),
                          (theirs, pn.TuningTable.load(str(tmp_path / "ref.json")))):
        assert loaded.topo_sig == table.topo_sig and loaded.entries == table.entries
        assert {f: getattr(loaded.model, f) for f in FIELDS} == \
            {f: getattr(table.model, f) for f in FIELDS}
        for op in ptune.OPS:
            for n in (1, 1 << 11, 1 << 17, 1 << 25):
                assert loaded.lookup(op, n).to_dict() == table.lookup(op, n).to_dict()
    assert json.loads(mine.to_json()).keys() == json.loads(theirs.to_json()).keys()
    # a table without the unfused-add key takes the port's default
    spec = json.loads(mine.to_json())
    del spec["model"]["unfused_add_latency"]
    legacy = pn.TuningTable.from_json(json.dumps(spec))
    assert legacy.model.unfused_add_latency == pn.LinkModel().unfused_add_latency
    assert pn.TuningTable("x", pm).lookup("bcast", 64) == pn.DEFAULT_PLAN


def test_communicator_plan_is_cached_per_route_table():
    comm = Communicator.create("x", (8,), topology=Topology.ring(8), device="cpu")
    p1 = comm.plan("allreduce", 1 << 20)
    assert p1 == comm.plan("allreduce", 1 << 20) and isinstance(p1, pn.Plan)
    assert len(ptune._TABLES) == 1
    assert p1 == ptune.tuning_table_for(comm.topology, comm.route_table).lookup(
        "allreduce", 1 << 20)
    dor = Communicator.create("x", (8,), device="cpu")
    bfs = Communicator.create("x", (8,), routing_scheme="bfs", device="cpu")
    t_dor = ptune.tuning_table_for(dor.topology, dor.route_table)
    t_bfs = ptune.tuning_table_for(bfs.topology, bfs.route_table)
    assert t_dor.topo_sig != t_bfs.topo_sig
    assert t_dor is ptune.tuning_table_for(dor.topology, dor.route_table)
    assert t_dor.model == pn.LinkModel()


# -- plan="auto" against the reference under the same table -----------------------------------

#: (model, layout, op, one rank's shape, dtype): the 1 MiB bcast on the
#: ring is the reference model's int8 pick; SLOW puts small all-reduces on
#: the int8 wire; torus(2x4) tunes small rooted ops to a binomial tree
AUTO_CASES = {
    "bcast_1MiB_int8": ("reference_default", "ring", "bcast", (1024, 256), "f32"),
    "bcast_4KiB": ("reference_default", "ring", "bcast", (16, 64), "f32"),
    "reduce_4KiB_fused": ("reference_default", "ring", "reduce", (16, 64), "f32"),
    "reduce_256KiB_chunked": ("reference_default", "ring", "reduce", (256, 256), "f32"),
    "allreduce_4KiB_fused": ("reference_default", "ring", "allreduce", (16, 64), "f32"),
    "bcast_tree": ("reference_default", "torus", "bcast", (16, 64), "f32"),
    "reduce_tree": ("reference_default", "torus", "reduce", (16, 64), "f32"),
    "allreduce_int8": ("slow", "ring", "allreduce", (64, 64), "f32"),
    "allreduce_int8_plan_int32": ("slow", "ring", "allreduce", (64, 64), "i32"),
    "bcast_port_default": ("port_default", "ring", "bcast", (64, 64), "f32"),
    "reduce_port_default": ("port_default", "torus", "reduce", (64, 64), "f32"),
    "allreduce_port_default": ("port_default", "ring", "allreduce", (64, 64), "f32"),
}


def _same_tables(R, which, topo):
    """Fill both packages' caches for ``topo`` under one model; returns
    (reference comm, port comm, the tables)."""
    from _torch_ref import port_comm, ref_comm

    rc, pcomm = ref_comm(topo), port_comm(topo)
    rm, pm = _models(R, which)
    rtab = R.tune.tuning_table_for(rc.topology, rc.route_table, model=rm)
    ptab = ptune.tuning_table_for(pcomm.topology, pcomm.route_table, model=pm)
    assert ptab.entries == rtab.entries
    return rc, pcomm, ptab


@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_auto_dispatchers_equal_reference_under_one_table(R, case):
    from _torch_ref import run_ref, to_port

    import repro.core.collectives as rcoll

    which, topo, op, shape, dt = AUTO_CASES[case]
    rc, pcomm, table = _same_tables(R, which, topo)
    x = _f32(P, *shape, seed=sum(shape))
    if dt == "i32":
        x = np.random.RandomState(5).randint(-1000, 1000, (P, *shape)).astype(np.int32)
    calls = {"bcast": lambda m, c, v, **k: m.bcast(v, c, root=2, **k),
             "reduce": lambda m, c, v, **k: m.reduce(v, c, root=5, **k),
             "allreduce": lambda m, c, v, **k: m.allreduce(v, c, **k)}[op]
    plan = table.lookup(op, int(np.prod(shape)) * 4)
    if case.endswith("int8") or case == "bcast_1MiB_int8":
        assert plan.wire == "int8", plan
    want = run_ref(lambda v: calls(rcoll, rc, v), topo, x)
    got = calls(pc, pcomm, to_port(x)).numpy()
    raw = calls(pc, pcomm, to_port(x), plan=None).numpy()
    if plan.wire == "int8" and dt == "f32":
        hops = {"bcast": 1, "allreduce": P}[op]
        tol = _codec_atol(x, hops) + (_codec_atol(raw) if op == "allreduce" else 0.0)
        np.testing.assert_allclose(got, raw, atol=tol, rtol=0)
        np.testing.assert_allclose(got, want, atol=2 * tol, rtol=0)
    else:
        assert got.tobytes() == want.tobytes(), f"{case}: {plan}"
        if op != "reduce" or plan.algo == "ring":
            assert got.tobytes() == raw.tobytes()
        else:  # a tree sums in another order
            np.testing.assert_allclose(got, raw, rtol=1e-6, atol=1e-6)


def test_auto_default_and_transport_override():
    """``plan="auto"`` is the dispatchers' default; ``transport=`` replaces
    only the tuned backend, and the tuned schedule stays."""
    comm = Communicator.create(("x", "y"), (2, 4), device="cpu")
    x = torch.from_numpy(_f32(P, 16, 64, seed=9))
    plan = comm.plan("bcast", 16 * 64 * 4)
    assert torch.equal(pc.bcast(x, comm), pc.bcast(x, comm, plan="auto"))
    assert torch.equal(pc.bcast(x, comm, transport="fused"),
                       pc.bcast(x, comm, plan=plan, transport="fused"))
    assert torch.equal(pc.allreduce(x, comm), pc.allreduce(x, comm, plan="auto"))
    with pytest.raises(ValueError, match="plan must be"):
        pc.reduce(x, comm, plan="fastest")


def test_halo_auto_plan_equals_static_schedule():
    """The tuned halo backend (a raw wire by construction) moves the slabs
    the static schedule moves: the run equals the static one bit for bit,
    with the tuned backend's halo counters."""
    world = torch.from_numpy(_f32(64, 48, seed=10))
    results = {}
    for plan, mode in (("auto", None), (None, "smi:static")):
        app = DistributedStencil.create((2, 4), comm_mode=mode, plan=plan, device="cpu")
        tiles = app.scatter(world)
        t = app.halo_schedule.resolve_transport(tiles)
        results[plan] = (app.gather(app.run(tiles, 3, transport=t)), t)
    auto_t = results["auto"][1]
    tuned = app.comm.plan("halo", app.halo_schedule.slab_nbytes((32, 12)))
    assert tuned.wire == "raw" and auto_t.name == tuned.transport_key
    assert torch.equal(results["auto"][0], results[None][0])
    assert torch.equal(results["auto"][0], DistributedStencil.single_rank_reference(world, 3))
    assert auto_t.stats.tag_counts("halo") == results[None][1].stats.tag_counts("halo")


def test_channel_auto_plans_follow_the_table():
    """A p2p channel keys ``plan="auto"`` on ``p2p``, a collective channel
    on its kind; both equal the direct call under the tuned plan."""
    import repro_torch.channels as pch

    comm = Communicator.create("x", (8,), topology=Topology.ring(8), device="cpu")
    x = torch.from_numpy(_f32(P, 64, 16, seed=11))
    nbytes = 64 * 16 * 4
    p = comm.plan("p2p", nbytes)
    got = pch.open_channel(comm, src=0, dst=5, port=None, plan="auto").transfer(x)
    want = pch.open_channel(comm, src=0, dst=5, port=None, plan=p).transfer(x)
    assert torch.equal(got, want)
    for kind, direct in (("bcast", lambda: pc.bcast(x, comm, root=1)),
                         ("reduce", lambda: pc.reduce(x, comm, root=1)),
                         ("allreduce", lambda: pc.allreduce(x, comm))):
        opener = getattr(pch, f"open_{kind}_channel")
        kw = {} if kind == "allreduce" else {"root": 1}
        ch = opener(comm, port=None, plan="auto", **kw)
        assert torch.equal(ch.transfer(x), direct()), kind


# -- on the card: phase 26's checks at a small size ----------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels A and B have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring", "torus", "bus"])
def test_auto_against_default_on_card(layout, cuda_device):
    """``plan="auto"`` against ``plan=None`` at one rank's 4 KiB and 256
    KiB: bcast bit for bit on a raw plan; reduce and all-reduce within rtol
    1e-6 on a raw plan (bit for bit where the algorithm is the default's);
    an int8 plan within the codec's bound."""
    names, sizes, topo = {"ring": (("x",), (8,), None), "torus": (("x", "y"), (2, 4), None),
                          "bus": (("x",), (8,), Topology.bus(8))}[layout]
    comm = Communicator.create(names, sizes, topology=topo, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(26)
    for elems in (1024, 65536):
        x = torch.randn((P, elems), generator=gen, device=cuda_device)
        for op, call in (("bcast", lambda **k: pc.bcast(x, comm, root=0, **k)),
                         ("reduce", lambda **k: pc.reduce(x, comm, root=0, **k)),
                         ("allreduce", lambda **k: pc.allreduce(x, comm, **k))):
            plan = comm.plan(op, elems * 4)
            got, want = call(plan="auto"), call(plan=None)
            assert torch.isfinite(got).all()
            if plan.wire == "int8":
                xs = x.cpu().numpy()
                tol = _codec_atol(xs, 1 if op == "bcast" else P)
                tol += 0.0 if op == "bcast" else _codec_atol(want.cpu().numpy())
                assert float((got - want).abs().max()) <= tol, (op, plan)
            elif op == "bcast" or plan.algo == "ring":
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (op, plan)
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_halo_auto_on_card_launches_kernel_b(cuda_device):
    from repro_torch.kernels.stencil import stencil_sweep

    world = torch.randn((256, 256), generator=torch.Generator().manual_seed(0))
    app = DistributedStencil.create((2, 4), plan="auto", device=cuda_device)
    before = stencil_sweep.launches
    got = app.gather(app.run(app.scatter(world), 4))
    assert stencil_sweep.launches - before == 4
    want = DistributedStencil.single_rank_reference(world.to(cuda_device), 4)
    assert torch.equal(got, want)
