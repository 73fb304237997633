"""The port's observability layer (``repro_torch.obs``) against ``repro.obs``.

The tracer's schema and ring buffer, the disabled hot path allocating
nothing over the port's eager ``push``/``pop``, Chrome-trace documents
equal as dicts, the netsim overlay, metrics snapshots and drift gauges
equal to the reference's, and every producer's event sequence — kind, tag,
port, attribute keys and non-timing values — equal to the reference's on
the programs where the reference's trace records each op once.  The port
emits once per call: a k-step stencil emits k times the one-step pattern.
"""

import gc
import json
import tracemalloc

import numpy as np
import pytest
import torch
from _torch_ref import port_comm, ref_comm, run_ref, to_port

import repro.obs.export as rexport
from repro.apps import DistributedStencil as RefStencil
from repro.channels import ChannelPool as RefPool
from repro.core import PortAllocator as RefAlloc
from repro.netsim import calibrate as rcal
from repro.netsim.model import LinkModel as RefModel
from repro.netsim.schedule import halo_rounds as ref_halo_rounds
from repro.netsim.sim import simulate as ref_simulate
from repro.obs import trace as robs
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro.transport import get_transport as ref_get_transport
from repro_torch.apps import DistributedStencil
from repro_torch.channels import (
    ChannelPool,
    open_allreduce_channel,
    open_bcast_channel,
    open_channel,
    open_reduce_channel,
)
from repro_torch.core import PortAllocator
from repro_torch.interop import communicator_from_reference
from repro_torch.launch import stencil as launch_stencil
from repro_torch.netsim import calibrate
from repro_torch.netsim.model import LinkModel
from repro_torch.netsim.schedule import halo_rounds
from repro_torch.netsim.sim import simulate
from repro_torch.obs import export, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.transport import get_transport

#: attributes that carry host times, which differ run to run
TIMING = ("dt", "ema")


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test leaves both packages' tracers disabled."""
    yield
    trace.disable()
    robs.disable()


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]

    return clock


def _seeded_events(tracer_mod):
    tr = tracer_mod.Tracer(capacity=64, clock=_fake_clock())
    tr.event("channel.open", tag="halo", port=3, src=0, dst=5)
    tr.event("run.step", rank=2, step=1, dur=0.25)
    tr.event("sim.flit", ts=1.5, link=[0, 1], dur=0.1, msg=0)
    tr.event("router.overflow", tag=None, counter="stats.overflow")
    tr.event("halo.start", rank=7, tag="halo", grid=[2, 4], tile=[16, 8])
    return tr.events()


def _shape(events):
    """(kind, tag, port, attrs without host times) of each event."""
    return [(e["kind"], e["tag"], e["port"],
             {k: v for k, v in e["attrs"].items() if k not in TIMING}) for e in events]


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_event_schema_and_chrome_trace_equal_reference():
    events = _seeded_events(trace)
    assert events == _seeded_events(robs)
    assert trace.EVENT_KEYS == robs.EVENT_KEYS
    assert all(tuple(e) == trace.EVENT_KEYS for e in events)
    doc = export.to_chrome_trace(events)
    assert doc == rexport.to_chrome_trace(events)
    assert export.parse_chrome_trace(json.loads(json.dumps(doc))) == events
    assert export.parse_chrome_trace(json.dumps(doc)) == events
    body = [r for r in doc["traceEvents"] if r["ph"] != "M"]
    assert [r["ph"] for r in body] == ["i", "X", "X", "i", "i"]
    assert export.HOST_TID == rexport.HOST_TID
    assert (export.PID_RANKS, export.PID_LINKS, export.PID_SIM_RANKS, export.PID_SIM_LINKS) == \
        (rexport.PID_RANKS, rexport.PID_LINKS, rexport.PID_SIM_RANKS, rexport.PID_SIM_LINKS)
    for pid in (1, 2, 3, 4):
        assert export.lane_count(doc, pid) == rexport.lane_count(doc, pid)


def test_tracer_ring_buffer_bounded():
    tr = trace.Tracer(capacity=4, clock=_fake_clock())
    for i in range(10):
        tr.event("k", i=i)
    assert len(tr) == 4
    assert [e["attrs"]["i"] for e in tr.events()] == [6, 7, 8, 9]
    assert tr.kinds() == {"k"}
    tr.clear()
    assert len(tr) == 0


def test_enabled_context_restores_previous():
    assert trace.get() is None and trace.TRACING is False
    with trace.enabled(capacity=16) as outer:
        with trace.enabled(capacity=16) as inner:
            assert trace.get() is inner and trace.TRACING
            trace.emit("k")
        assert trace.get() is outer and trace.TRACING
        trace.emit("k")
    assert trace.get() is None and trace.TRACING is False
    assert len(inner) == 1 and len(outer) == 1
    trace.emit("dropped")  # no tracer: a no-op
    assert len(outer) == 1


def _push_pop(n: int, ch, e):
    for _ in range(n):
        ch = ch.push(e)
        ch, _, _ = ch.pop()
    return ch


def test_disabled_tracer_allocates_nothing_on_push_pop(monkeypatch):
    """Tracing off: 100 port push/pop pairs never reach ``emit`` (no event
    kwargs are built) and the guarded call pattern allocates nothing (the
    reference's tracemalloc check, over the port's eager push and pop)."""
    comm = port_comm("ring")
    assert trace.TRACING is False
    calls = []
    monkeypatch.setattr(trace, "emit", lambda kind, **kw: calls.append(kind))
    ch = open_channel(comm, src=0, dst=3, port=None, elem_shape=(4,), tag="hot")
    e = torch.ones(4)
    _push_pop(20, ch, e)  # warm every cache
    gc.collect()
    tracemalloc.start()
    try:
        snap1 = tracemalloc.take_snapshot()
        _push_pop(100, ch, e)
        snap2 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    flt = [tracemalloc.Filter(True, __file__)]
    grown = sum(d.size_diff for d in snap2.filter_traces(flt).compare_to(
        snap1.filter_traces(flt), "lineno") if d.size_diff > 0)
    assert grown < 512, f"disabled tracer left {grown}B over 100 push/pop pairs"
    assert calls == []
    _push_pop(100, ch, e)
    assert calls == []
    monkeypatch.undo()
    with trace.enabled() as tr:
        _push_pop(100, ch, e)
    kinds = [ev["kind"] for ev in tr.events()]
    assert kinds == ["channel.push", "channel.pop"] * 100


# ---------------------------------------------------------------------------
# the netsim overlay and the metrics registry
# ---------------------------------------------------------------------------


def test_sim_report_events_equal_reference():
    rc, pc = ref_comm("torus"), port_comm("torus")
    fields = RefModel.default_v5e().__dict__
    rmodel, pmodel = RefModel(**fields), LinkModel(**fields)
    rrep = [ref_simulate(rc.topology, rc.route_table, m, trace=True)
            for m in ref_halo_rounds((2, 4), 256.0, 256.0)]
    prep = [simulate(pc.topology, pc.route_table, m, trace=True)
            for m in halo_rounds((2, 4), 256.0, 256.0)]
    want = rexport.sim_report_events(rc.topology, rrep, model=rmodel)
    got = export.sim_report_events(pc.topology, prep, model=pmodel)
    assert got == want
    assert export.directed_links(pc.topology) == rexport.directed_links(rc.topology)
    doc = export.to_chrome_trace(got)
    assert doc == rexport.to_chrome_trace(want)
    assert export.lane_count(doc, export.PID_SIM_LINKS) == len(export.directed_links(pc.topology))
    # the card's model is the default
    assert export.sim_report_events(pc.topology, prep) == \
        export.sim_report_events(pc.topology, prep, model=LinkModel())


def _ref_stencil(grid, world, steps=1):
    ref = RefStencil.create(grid, use_pallas=False)
    rt = ref_get_transport("static")
    tiles = ref.scatter(world)
    out = np.asarray(ref.jitted(ref.make_mesh(), n_steps=steps, transport=rt)(tiles))
    return ref, rt, tiles, out


def _port_stencil(ref, tiles, steps=1):
    rc = ref.comm
    comm = communicator_from_reference(rc.topology.to_json(), rc.axis_names, rc.axis_sizes,
                                       device="cpu")
    app = DistributedStencil.create(ref.grid, comm=comm)
    pt = get_transport("static", device="cpu")
    out = app.run(to_port(tiles), steps, transport=pt)
    return app, pt, out


def test_metrics_snapshot_equals_reference_stencil():
    world = np.random.RandomState(0).randn(32, 32).astype(np.float32)
    ref, rt, tiles, want = _ref_stencil((2, 4), world)
    _, pt, got = _port_stencil(ref, tiles)
    np.testing.assert_array_equal(got.numpy(), want)
    rreg, preg = RefRegistry(), MetricsRegistry()
    rreg.track("halo", rt)
    preg.track("halo", pt)
    rreg.inc("runs", 2)
    preg.inc("runs", 2)
    assert preg.snapshot() == rreg.snapshot()
    snap = preg.snapshot()["transports"]["halo"]
    assert snap["by_tag"]["halo"] == {"steps": pt.stats.steps, "bytes": pt.stats.bytes_moved}
    json.dumps(preg.snapshot())
    preg.clear()
    assert preg.snapshot() == {"counters": {}, "gauges": {}, "transports": {}}


def test_metrics_snapshot_reads_the_packet_overflow_tensor():
    comm = port_comm("ring")
    t = get_transport("packet", device="cpu")
    t.shift(torch.ones(8, 16), comm, 1)
    assert torch.is_tensor(t.stats.overflow)
    reg = MetricsRegistry()
    reg.track("p", t)
    snap = reg.snapshot()["transports"]["p"]
    assert snap["overflow"] == 0 and snap["name"] == "packet"
    json.dumps(reg.snapshot())


def test_drift_gauges_equal_validate_and_reference():
    records = [calibrate.record(4, 1024.0, 1.0e-5, "a"),
               calibrate.record(8, 4096.0, 5.0e-5, "b"),
               calibrate.record(16, 65536.0, 3.0e-4, "c")]
    m, worst = calibrate.validate(records, tol=1e9, label="obs_test")
    reg = MetricsRegistry()
    got = reg.drift_from_records("obs_test", records, model=m)
    assert got == worst and reg.gauges["drift/obs_test"] == worst
    rm = RefModel(**m.__dict__)
    rreg = RefRegistry()
    assert rreg.drift_from_records("obs_test", records, model=rm) == got
    assert rreg.gauges == reg.gauges
    _, rworst = rcal.validate(records, tol=1e9, label="obs_test", model=rm)
    assert rworst == worst
    for name, (p, q) in {"x": (2.0, 1.0), "y": (1.0, 2.0), "z": (0.5, 0.5)}.items():
        assert reg.drift(name, predicted=p, measured=q) == \
            rreg.drift(name, predicted=p, measured=q)


# ---------------------------------------------------------------------------
# the producers, against the reference's event sequences
# ---------------------------------------------------------------------------


def _p2p_program(mod, comm, v, alloc):
    """A claimed p2p channel (one push, one pop, close) and an anonymous
    whole-message transfer."""
    with mod["open_channel"](comm, count=2, src=0, dst=3, port=5, tag="obs.p2p",
                             elem_shape=(4,), allocator=alloc) as ch:
        ch = ch.push(v)
        ch, val, _ = ch.pop()
    y = mod["open_channel"](comm, src=0, dst=3, port=None, n_chunks=2, tag="obs.x",
                            allocator=alloc).transfer(v)
    return val + y


def _collective_program(mod, comm, v, alloc):
    """bcast and reduce channels element by element, an allreduce and a
    reduce transfer, each channel closed."""
    with mod["open_bcast_channel"](comm, root=1, port=6, elem_shape=(4,),
                                   allocator=alloc) as b:
        b = b.push(v)
        b, bv, _ = b.pop()
    with mod["open_reduce_channel"](comm, root=0, port=7, elem_shape=(4,), count=1,
                                    allocator=alloc) as r:
        r = r.push(v)
        r, rv, _ = r.pop()
    a = mod["open_allreduce_channel"](comm, port=None, allocator=alloc).transfer(v)
    with mod["open_reduce_channel"](comm, root=2, port=8, n_chunks=2, allocator=alloc) as r2:
        c = r2.transfer(v)
    return bv + rv + a + c


def _ref_mod():
    import repro.channels as C

    return {k: getattr(C, k) for k in ("open_channel", "open_bcast_channel",
                                       "open_reduce_channel", "open_allreduce_channel")}


PORT_MOD = {"open_channel": open_channel, "open_bcast_channel": open_bcast_channel,
            "open_reduce_channel": open_reduce_channel,
            "open_allreduce_channel": open_allreduce_channel}


@pytest.mark.parametrize("program", [_p2p_program, _collective_program],
                         ids=["p2p", "collective"])
def test_channel_events_equal_reference(program):
    x = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    rc, pc = ref_comm("ring"), port_comm("ring")
    rmod = _ref_mod()
    with robs.enabled() as rtr:
        want = run_ref(lambda v: program(rmod, rc, v, RefAlloc()), "ring", x)
    with trace.enabled() as ptr:
        got = program(PORT_MOD, pc, to_port(x), PortAllocator())
    np.testing.assert_array_equal(got.numpy(), want)
    assert _shape(ptr.events()) == _shape(rtr.events())
    kinds = ptr.kinds()
    assert {"channel.open", "channel.push", "channel.pop", "channel.close",
            "channel.transfer.start", "channel.transfer.finish"} <= kinds


def test_pool_and_leak_events_equal_reference():
    def drive(pool_cls, alloc, comm, tracer_mod):
        with tracer_mod.enabled(capacity=256) as tr:
            pool = pool_cls(comm, allocator=alloc)
            pool.spec("decode.mlp")
            pool.spec("decode.attn", kind="allreduce")
            closed = pool_cls(comm, allocator=alloc, base_port=150)
            closed.spec("decode.out")
            closed.close()
            del pool, closed
            gc.collect()
        return tr.events()

    rc, pc = ref_comm("ring"), port_comm("ring")
    palloc = PortAllocator()
    got = drive(ChannelPool, palloc, pc, trace)
    want = drive(RefPool, RefAlloc(), rc, robs)
    assert _shape(got) == _shape(want)
    leaks = [e for e in got if e["kind"] == "ft.leak"]
    assert len(leaks) == 1 and leaks[0]["attrs"]["ports"] == [100, 101]
    assert palloc.in_use(pc) == ()


def test_stencil_step_events_equal_reference():
    world = np.random.RandomState(2).randn(32, 32).astype(np.float32)
    with robs.enabled() as rtr:
        ref, _, tiles, want = _ref_stencil((2, 4), world)
    with trace.enabled() as ptr:
        _, _, got = _port_stencil(ref, tiles)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _shape(ptr.events()) == _shape(rtr.events())
    assert [e["kind"] for e in ptr.events()] == ["halo.start", "halo.finish"]
    assert ptr.events()[0]["attrs"]["tile"] == [16, 8]
    # eager: k steps emit k times the one-step pattern
    with trace.enabled() as ktr:
        _port_stencil(ref, tiles, steps=3)
    assert _shape(ktr.events()) == _shape(rtr.events()) * 3


def test_packet_wire_events_equal_reference():
    x = np.random.RandomState(3).randn(8, 40).astype(np.float32)
    rc, pc = ref_comm("torus"), port_comm("torus")
    rt, pt = ref_get_transport("packet"), get_transport("packet", device="cpu")
    with robs.enabled() as rtr:
        want = run_ref(lambda v: rt.shift(v, rc, 1), "torus", x)
    with trace.enabled() as ptr:
        with pt.tagged("obs.pkt"):
            got = pt.shift(to_port(x), pc, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    got_ev, want_ev = _shape(ptr.events()), _shape(rtr.events())
    # the port's shift runs inside a tag; the reference's untagged
    assert [e[:1] + e[2:] for e in got_ev] == [e[:1] + e[2:] for e in want_ev]
    assert [e[0] for e in got_ev] == ["router.run", "router.tick_batch", "router.drain",
                                      "router.overflow"]
    assert got_ev[-1][1] == "obs.pkt"
    assert int(pt.stats.overflow.sum()) == 0


def test_tuner_plan_events_equal_reference():
    from repro.netsim.tune import autotune as ref_autotune
    from repro_torch.core import Topology
    from repro_torch.netsim.tune import autotune

    from repro.core import Topology as RefTopology

    fields = LinkModel().__dict__
    with robs.enabled() as rtr:
        ref_autotune(RefTopology.ring(4), ops=("bcast", "allreduce"), sizes=(1024, 1 << 20),
                     model=RefModel(**fields))
    with trace.enabled() as ptr:
        autotune(Topology.ring(4), ops=("bcast", "allreduce"), sizes=(1024, 1 << 20),
                 model=LinkModel(**fields))
    assert _shape(ptr.events()) == _shape(rtr.events())
    assert len(ptr.events()) == 4 and ptr.kinds() == {"tuner.plan"}


def _drive_ft(mod, monkeypatch, tracer_mod):
    now = [100.0]
    monkeypatch.setattr(f"{mod.__name__}.time.monotonic", lambda: now[0])
    with tracer_mod.enabled() as tr:
        wd = mod.StepWatchdog(threshold=3.0, alpha=0.1)
        wd.start()
        for i, dt in enumerate([1.0] * 3 + [10.0]):
            now[0] += dt
            wd.lap(step=i)

        class _Ckpt:
            def restore(self, state_like):
                return {"w": 1}, {"step": 5}

        calls = []

        def loop(state, step):
            calls.append(step)
            if len(calls) == 1:
                raise RuntimeError("boom")
            return state

        mod.run_with_restarts(loop, _Ckpt(), {"w": 0}, max_restarts=1)
    return tr.events()


def test_ft_events_equal_reference(monkeypatch):
    import repro.ft.watchdog as rwd
    import repro_torch.ft.watchdog as pwd

    got = _drive_ft(pwd, monkeypatch, trace)
    want = _drive_ft(rwd, monkeypatch, robs)
    assert [(e["kind"], e["tag"], e["port"], sorted(e["attrs"])) for e in got] == \
        [(e["kind"], e["tag"], e["port"], sorted(e["attrs"])) for e in want]
    # the clock is mocked, so the host times agree too
    assert [e["attrs"] for e in got] == [e["attrs"] for e in want]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_stencil_trace_and_metrics(tmp_path):
    out, tr, met = tmp_path / "r.json", tmp_path / "t.json", tmp_path / "m.json"
    rc = launch_stencil.main(["--device", "cpu", "--domain", "64x64", "--steps", "3",
                              "--trace", str(tr), "--metrics", str(met), "--json", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["ok"] and res["max_err"] == 0.0
    snap = json.loads(met.read_text())
    halo = snap["transports"]["halo"]
    assert halo["by_tag"]["halo"] == {"steps": res["halo_steps"],
                                      "bytes": res["halo_bytes_per_rank"]}
    assert (halo["steps"], halo["bytes"]) == (res["halo_steps"], res["halo_bytes_per_rank"])
    assert snap["gauges"]["drift/stencil/wall_vs_model"] >= 1.0
    doc = json.loads(tr.read_text())
    events = export.parse_chrome_trace(doc)
    kinds = [e["kind"] for e in events]
    assert kinds.count("halo.start") == 3 and kinds.count("halo.finish") == 3
    steps = [e for e in events if e["kind"] == "run.step"]
    assert len(steps) == 8 * 3 and all(e["attrs"]["dur"] > 0 for e in steps)
    assert export.lane_count(doc, export.PID_RANKS) == 8 + 1  # 8 ranks + the host lane
    comm = DistributedStencil.create((2, 4), device="cpu").comm
    assert export.lane_count(doc, export.PID_SIM_LINKS) == \
        len(export.directed_links(comm.topology))
    assert trace.TRACING is False
