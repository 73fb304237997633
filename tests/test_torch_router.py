"""The port's packet router against ``repro.core.router`` and its tick.

Tolerance 0 throughout: the router only moves, compares and counts, so
every output is equal bit for bit.

* per tick: the port's ``router_tick`` on the stacked state of all ranks
  equals the reference's ``ref.router_tick`` and the Pallas tick kernel in
  interpret mode, each called per rank outside ``shard_map``, on random
  states with wrapped transit rings, full buffers (drops), R=1 and R=16,
  bubble on and off;
* per run: the port's ``scalar`` and ``vector`` routers equal the
  reference's ``run_router(impl="scalar")`` under ``shard_map`` on the
  reference's equivalence configurations, the ``out_cap`` overrun and the
  step budget;
* the link lists and route tables equal the reference's;
* ``router_path`` sends every fabric of up to 32 ranks to the warp path
  and larger ones to the thread path;
* kernel C, each of its two paths, against the plain routers on the card
  (``cuda`` cases, skipped where there is none), each case asserting which
  counter moved:

    python -m pytest --noconftest -m cuda tests/test_torch_router.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import Communicator, RouterConfig, Topology, make_links, make_router_tables
from repro_torch.core import run_router, snake_bus
from repro_torch.core.router import _exchange_tables, _fabric
from repro_torch.interop import router_inputs_from_reference
from repro_torch.kernels.router import TickSpec, router_path, router_run, router_tick, tick_spec_of
from repro_torch.kernels.router.kernel import THREAD, WARP, warp_lanes, warp_shared_bytes

DIMS = (2, 4)
N = 8
#: the reference's equivalence configurations (tests/test_router.py)
EQ_CFGS = {
    "r1": dict(n_ports=1, R=1, switch_bubble=False, tick_batch=1),
    "r4_bubble": dict(n_ports=1, R=4, switch_bubble=True, tick_batch=2),
    "ports2_r8": dict(n_ports=2, R=8, switch_bubble=False, tick_batch=4),
    "ports2_bubble_r16": dict(n_ports=2, R=16, switch_bubble=True, tick_batch=3),
}
STATE_KEYS = ("inq_head", "tr_pay", "tr_dst", "tr_port", "tr_head", "tr_cnt",
              "out_pay", "out_cnt", "overflow", "last_src", "stick", "t_done")
OUTS = ("out_pay", "out_cnt", "overflow", "t_done")


@pytest.fixture(scope="module")
def ref():
    """The reference router (imports JAX): its tick, Pallas tick kernel,
    run under ``shard_map`` and tables."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    import repro.core as rcore
    from repro.core import router as rrouter
    from repro.kernels.router import ref as rref
    from repro.kernels.router.kernel import router_tick_pallas

    mesh = rcore.make_test_mesh(DIMS, ("x", "y"))
    comm = rcore.Communicator.create(("x", "y"), DIMS)
    cache = {}

    def run_scalar(cfg_kw, tbl, pay, dst, ln, n_steps):
        """The reference's scalar router under ``shard_map``: the outputs
        as (P, ...) numpy arrays."""
        key = (tuple(sorted(cfg_kw.items())), n_steps)
        if key not in cache:
            cfg = rrouter.RouterConfig(dims=DIMS, **cfg_kw)

            def wrapped(t, p, d, n):
                outs = rrouter.run_router(cfg, comm, t, p[0], d[0], n[0], n_steps, impl="scalar")
                return tuple(o[None] for o in outs)

            spec = PS(("x", "y"))
            cache[key] = jax.jit(jax.shard_map(wrapped, mesh=mesh, in_specs=(PS(),) + (spec,) * 3,
                                               out_specs=(spec,) * 4))
        outs = cache[key](*map(jnp.asarray, (tbl, pay, dst, ln)))
        return [np.asarray(o) for o in outs]

    return SimpleNamespace(jnp=jnp, rrouter=rrouter, rref=rref, pallas=router_tick_pallas,
                           Topology=rcore.Topology, run_scalar=run_scalar,
                           jit_tick=jax.jit(rref.router_tick, static_argnums=0),
                           jit_absorb=jax.jit(rref.router_absorb, static_argnums=0))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel C has no CPU mode)")
    return torch.device("cuda", 0)


def _stage(cfg, msgs):
    """msgs: (src, port, dst, value) -> the staged numpy arrays, as the
    reference's tests stage them."""
    pay = np.zeros((N, cfg["n_ports"], cfg["fifo_cap"], cfg["pkt_elems"]), np.float32)
    dst = np.zeros((N, cfg["n_ports"], cfg["fifo_cap"]), np.int32)
    ln = np.zeros((N, cfg["n_ports"]), np.int32)
    for s, p, d, val in msgs:
        i = ln[s, p]
        pay[s, p, i] = val
        dst[s, p, i] = d
        ln[s, p] += 1
    return pay, dst, ln


def _rand_msgs(n_ports, rng, load=4):
    return [(s, p, rng.randint(0, N), float(rng.randint(1, 99)))
            for s in range(N) for p in range(n_ports) for _ in range(rng.randint(0, load + 1))]


def _table(topo: str) -> np.ndarray:
    return make_router_tables(Topology.torus(DIMS) if topo == "torus" else snake_bus(DIMS), DIMS)


def _port_run(cfg_kw, tbl, staged, n_steps, impl, device="cpu"):
    comm = Communicator.create(("x", "y"), DIMS, device=device)
    args = router_inputs_from_reference(tbl, *staged, device=device)
    return run_router(RouterConfig(dims=DIMS, **cfg_kw), comm, *args, n_steps, impl=impl)


def _assert_outs_equal(got, want, msg):
    for g, w, name in zip(got, want, OUTS):
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f"{msg}: {name}"
        assert g.tobytes() == w.tobytes(), f"{msg}: {name} differs"


# -- tables --------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(2, 4), (8,), (4, 4), (2, 2, 2), (1, 8)])
def test_make_links_matches_reference(dims, ref):
    assert make_links(dims) == ref.rrouter.make_links(dims)


def test_make_links_2x4():
    assert [lid for lid, _ in make_links(DIMS)] == [0, 2, 3]


@pytest.mark.parametrize("topo", ["torus", "snake_bus"])
def test_router_tables_match_reference(topo, ref):
    rt = ref.Topology.torus(DIMS) if topo == "torus" else ref.rrouter.snake_bus(DIMS)
    want = ref.rrouter.make_router_tables(rt, DIMS)
    got = _table(topo)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert snake_bus(DIMS).to_json() == ref.rrouter.snake_bus(DIMS).to_json()
    nbr, src, ok = _exchange_tables(make_links(DIMS), N)
    rnbr, rsrc, rok = ref.rrouter._exchange_tables(ref.rrouter.make_links(DIMS), N)
    assert ok == rok and np.array_equal(nbr, rnbr) and np.array_equal(src, rsrc)


def test_router_tables_refuse_a_non_physical_edge():
    with pytest.raises(ValueError, match="not a physical link"):
        make_router_tables(Topology.from_edges(N, [(0, 5)] + [(i, i + 1) for i in range(7)]),
                           DIMS)


# -- per tick ------------------------------------------------------------------------


TICK_CASES = {
    "r1": dict(R=1, switch_bubble=False, n_ports=1, topo="torus"),
    "r16_bubble": dict(R=16, switch_bubble=True, n_ports=2, topo="snake_bus"),
    "r4_bubble_full": dict(R=4, switch_bubble=True, n_ports=2, topo="torus", full=True),
    "r16_full": dict(R=16, switch_bubble=False, n_ports=3, topo="snake_bus", full=True),
}


def _rand_tick(spec, rng, full=False):
    """A random (state, arrivals, t) of every rank: wrapped transit rings,
    and with ``full`` delivery buffers and transit rings at capacity."""
    P, NP, NL, S = N, spec.n_ports, spec.n_links, spec.n_srcs
    FC, TC, OC, E = spec.fifo_cap, spec.transit_cap, spec.out_cap, spec.pkt_elems
    i32 = np.int32
    inq_len = rng.randint(0, FC + 1, (P, NP)).astype(i32)
    tr_cnt = rng.randint(0, TC + 1, P).astype(i32)
    out_cnt = rng.randint(0, OC + 1, (P, NP)).astype(i32)
    if full:
        tr_cnt[::2] = TC
        out_cnt[1::2] = OC
    st = dict(
        inq_head=rng.randint(0, inq_len + 1).astype(i32),
        tr_pay=rng.randn(P, TC, E).astype(np.float32),
        tr_dst=rng.randint(0, N, (P, TC)).astype(i32),
        tr_port=rng.randint(0, NP, (P, TC)).astype(i32),
        tr_head=rng.randint(0, 3 * TC, P).astype(i32),
        tr_cnt=tr_cnt,
        out_pay=rng.randn(P, NP, OC, E).astype(np.float32),
        out_cnt=out_cnt,
        overflow=rng.randint(0, 5, P).astype(i32),
        last_src=rng.randint(0, S, (P, NL)).astype(i32),
        stick=rng.randint(0, spec.R + 1, (P, NL)).astype(i32),
        t_done=rng.randint(0, 9, P).astype(i32),
    )
    inq = (rng.randn(P, NP, FC, E).astype(np.float32), rng.randint(0, N, (P, NP, FC)).astype(i32),
           inq_len)
    arr = (rng.randn(P, NL, E).astype(np.float32), rng.randint(0, N, (P, NL)).astype(i32),
           rng.randint(0, NP, (P, NL)).astype(i32), rng.rand(P, NL) < 0.7)
    return st, inq, arr, int(rng.randint(1, 50))


@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_router_tick_matches_reference_and_pallas(case, ref):
    c = TICK_CASES[case]
    links = make_links(DIMS)
    spec_kw = dict(n=N, n_ports=c["n_ports"], fifo_cap=5, transit_cap=4, out_cap=3, pkt_elems=3,
                   R=c["R"], switch_bubble=c["switch_bubble"],
                   link_ids=tuple(lid for lid, _ in links))
    spec, rspec = TickSpec(**spec_kw), ref.rref.TickSpec(**spec_kw)
    tbl = _table(c["topo"])
    rng = np.random.RandomState(sum(map(ord, case)))
    jnp = ref.jnp
    for _ in range(2):
        st, inq, arr, t = _rand_tick(spec, rng, c.get("full", False))
        t_st = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
        got = router_tick(spec, torch.from_numpy(tbl), *map(torch.from_numpy, inq), t_st,
                          *map(torch.from_numpy, arr), torch.arange(N, dtype=torch.int32), t)
        got_st, got_out = got[0], got[1:]
        for impl in ("ref", "pallas"):
            per_rank = []
            for r in range(N):
                a = (rspec, jnp.asarray(tbl[r]), *(jnp.asarray(v[r]) for v in inq),
                     {k: jnp.asarray(v[r]) for k, v in st.items()},
                     *(jnp.asarray(v[r]) for v in arr), jnp.int32(r), jnp.int32(t))
                per_rank.append(ref.rref.router_tick(*a) if impl == "ref"
                                else ref.pallas(*a, interpret=True))
            for k in STATE_KEYS:
                want = np.stack([np.asarray(o[0][k]) for o in per_rank])
                assert got_st[k].numpy().tobytes() == want.tobytes(), f"{impl}: state {k}"
            for j, name in enumerate(("snd_pay", "snd_dst", "snd_prt", "snd_val", "pending")):
                want = np.stack([np.asarray(o[j + 1]) for o in per_rank])
                g = got_out[j].numpy()
                assert g.shape == want.shape and g.tobytes() == want.astype(g.dtype).tobytes(), \
                    f"{impl}: {name}"


# -- per run -------------------------------------------------------------------------


def _cfg(**kw):
    return dict(fifo_cap=6, transit_cap=8, out_cap=16, pkt_elems=4, **kw)


@pytest.mark.parametrize("cfg_name", sorted(EQ_CFGS))
@pytest.mark.parametrize("topo", ["torus", "snake_bus"])
def test_router_impls_match_reference_scalar(topo, cfg_name, ref):
    kw = _cfg(**EQ_CFGS[cfg_name])
    tbl = _table(topo)
    staged = _stage(kw, _rand_msgs(kw["n_ports"], np.random.RandomState(
        sum(map(ord, cfg_name)) % 1000)))
    want = ref.run_scalar(kw, tbl, *staged, 64)
    for impl in ("scalar", "vector"):
        _assert_outs_equal(_port_run(kw, tbl, staged, 64, impl), want, f"{impl} {cfg_name}/{topo}")


def test_router_out_cap_overrun_counts_overflow(ref):
    """Four ranks send one packet each to rank 0 / port 0 with out_cap=2:
    the first two land, the other two drop and count."""
    kw = dict(n_ports=1, fifo_cap=8, transit_cap=16, out_cap=2, pkt_elems=4)
    msgs = [(s, 0, 0, float(10 + s)) for s in (1, 2, 4, 5)]
    staged, tbl = _stage(kw, msgs), _table("torus")
    want = ref.run_scalar(kw, tbl, *staged, 64)
    for impl in ("scalar", "vector"):
        got = _port_run(kw, tbl, staged, 64, impl)
        _assert_outs_equal(got, want, impl)
        assert int(got[1][0, 0]) == 2 and int(got[2].sum()) == 2
        assert set(got[0][0, 0, :, 0].tolist()) <= {v for *_, v in msgs}


def test_router_batch_respects_step_budget(ref):
    """A flood that cannot drain in 5 ticks, with a tick batch that does
    not divide the budget: delivery stops exactly where the reference's
    scalar loop stops."""
    kw = dict(n_ports=1, fifo_cap=8, transit_cap=8, out_cap=8, pkt_elems=4, tick_batch=4)
    msgs = [(s, 0, (s + 1 + k) % N, float(10 * s + k)) for s in range(N) for k in range(4)]
    staged, tbl = _stage(kw, msgs), _table("torus")
    want = ref.run_scalar(kw, tbl, *staged, 5)
    for impl in ("scalar", "vector"):
        _assert_outs_equal(_port_run(kw, tbl, staged, 5, impl), want, impl)


def test_router_reroutes_without_rebuilding():
    """One config and one staging, two route tables: all delivered, no
    loss, on both; the impl takes the table as data."""
    kw = _cfg(n_ports=2)
    msgs = [(0, 0, 5, 9.0), (2, 1, 6, 8.0), (7, 0, 1, 3.0)]
    for topo in ("torus", "snake_bus"):
        out_pay, out_cnt, ovf, _ = _port_run(kw, _table(topo), _stage(kw, msgs), 64, "vector")
        assert int(ovf.sum()) == 0
        for _s, p, d, val in msgs:
            assert val in out_pay[d, p, :int(out_cnt[d, p]), 0].tolist()


# -- property: random partial permutations, held to the per-tick oracle -------------

from _hyp import given, settings, st  # noqa: E402


def _ref_run_ticks(ref, spec_kw, tbl, pay, dst, ln, n_steps):
    """A router run built from the reference's per-rank ``router_tick``
    (the per-tick oracle): every rank ticks, the exchange is done here."""
    jnp, rref = ref.jnp, ref.rref
    spec = rref.TickSpec(**spec_kw)
    tick, absorb = ref.jit_tick, ref.jit_absorb
    NL, E, NP = spec.n_links, spec.pkt_elems, spec.n_ports
    _, src, _ = _exchange_tables(make_links(DIMS), N)
    z = np.zeros
    st0 = dict(inq_head=z(NP, np.int32), tr_pay=z((spec.transit_cap, E), np.float32),
               tr_dst=z(spec.transit_cap, np.int32), tr_port=z(spec.transit_cap, np.int32),
               tr_head=np.int32(0), tr_cnt=np.int32(0),
               out_pay=z((NP, spec.out_cap, E), np.float32), out_cnt=z(NP, np.int32),
               overflow=np.int32(0), last_src=z(NL, np.int32), stick=z(NL, np.int32),
               t_done=np.int32(0))
    sts = [{k: jnp.asarray(v) for k, v in st0.items()} for _ in range(N)]
    arr = [(z((NL, E), np.float32), z(NL, np.int32), z(NL, np.int32), z(NL, bool))] * N
    for t in range(n_steps):
        outs = [tick(spec, jnp.asarray(tbl[r]), jnp.asarray(pay[r]),
                                 jnp.asarray(dst[r]), jnp.asarray(ln[r]), sts[r], *arr[r],
                                 jnp.int32(r), jnp.int32(t)) for r in range(N)]
        sts = [o[0] for o in outs]
        snd = [[np.asarray(v) for v in o[1:5]] for o in outs]
        arr = [tuple(np.stack([snd[src[r, li]][j][li] for li in range(NL)]) for j in range(4))
               for r in range(N)]
    sts = [absorb(spec, sts[r], *arr[r], jnp.int32(r), jnp.int32(n_steps - 1))
           for r in range(N)]
    return [np.stack([np.asarray(s[k]) for s in sts]) for k in OUTS]


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16 - 1), topo=st.sampled_from(["torus", "snake_bus"]),
       R=st.sampled_from([1, 4, 16]), bubble=st.booleans(), batch=st.integers(1, 4))
def test_router_equivalent_on_partial_permutations(seed, topo, R, bubble, batch, ref):
    kw = dict(n_ports=2, fifo_cap=4, transit_cap=6, out_cap=8, pkt_elems=4, R=R,
              switch_bubble=bubble)
    rng = np.random.RandomState(seed)
    msgs = []
    for p in range(kw["n_ports"]):
        srcs = rng.permutation(N)[: rng.randint(1, N + 1)]
        dsts = rng.permutation(N)[: len(srcs)]
        msgs += [(int(s), p, int(d), float(rng.randint(1, 99))) for s, d in zip(srcs, dsts)
                 if s != d]
    staged, tbl, n_steps = _stage(kw, msgs), _table(topo), 12
    spec_kw = {k: v for k, v in kw.items() if k != "tick_batch"}
    spec_kw.update(n=N, link_ids=tuple(lid for lid, _ in make_links(DIMS)))
    want = _ref_run_ticks(ref, spec_kw, tbl, *staged, n_steps)
    for impl in ("scalar", "vector"):
        got = _port_run(dict(kw, tick_batch=batch), tbl, staged, n_steps, impl)
        _assert_outs_equal(got, want, f"{impl} seed={seed}")


# -- the wrapper's contract ----------------------------------------------------------


def test_kernel_impl_refuses_the_cpu():
    kw = _cfg(n_ports=1)
    with pytest.raises(ValueError, match="CUDA"):
        _port_run(kw, _table("torus"), _stage(kw, [(0, 0, 5, 1.0)]), 8, "kernel")
    with pytest.raises(ValueError, match="unknown router impl"):
        _port_run(kw, _table("torus"), _stage(kw, [(0, 0, 5, 1.0)]), 8, "pallas")


def test_router_run_on_cpu_is_the_plain_run_and_launches_nothing():
    kw = _cfg(**EQ_CFGS["ports2_r8"])
    staged, tbl = _stage(kw, _rand_msgs(2, np.random.RandomState(3))), _table("snake_bus")
    before = router_run.launches
    default = _port_run(kw, tbl, staged, 64, None)
    vector = _port_run(kw, tbl, staged, 64, "vector")
    assert router_run.launches == before
    for a, b in zip(default, vector):
        assert torch.equal(a, b)


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name", sorted(EQ_CFGS))
@pytest.mark.parametrize("topo", ["torus", "snake_bus"])
def test_kernel_matches_plain_routers(topo, cfg_name, cuda_device):
    kw = _cfg(**EQ_CFGS[cfg_name])
    staged = _stage(kw, _rand_msgs(kw["n_ports"], np.random.RandomState(len(cfg_name))))
    tbl = _table(topo)
    before = router_run.launches
    got = _port_run(kw, tbl, staged, 64, "kernel", cuda_device)
    torch.cuda.synchronize()
    assert router_run.launches == before + 1
    for impl in ("vector", "scalar"):
        want = [o.cpu().numpy() for o in _port_run(kw, tbl, staged, 64, impl, cuda_device)]
        _assert_outs_equal(got, want, f"kernel vs {impl}")


@pytest.mark.cuda
def test_kernel_refuses_bad_input_on_the_card(cuda_device):
    kw = _cfg(n_ports=1)
    tbl, pay, dst, ln = router_inputs_from_reference(_table("torus"), *_stage(kw, []),
                                                     device=cuda_device)
    comm = Communicator.create(("x", "y"), DIMS, device=cuda_device)
    cfg = RouterConfig(dims=DIMS, **kw)
    with pytest.raises(TypeError):
        run_router(cfg, comm, tbl, pay.double(), dst, ln, 8, impl="kernel")
    with pytest.raises(ValueError):
        run_router(cfg, comm, tbl, pay[:, :, :2], dst, ln, 8, impl="kernel")


# -- the two kernel paths ------------------------------------------------------------

#: every fabric the suite knows, with the path kernel C takes on it
FABRIC_PATHS = {(2, 4): WARP, (8,): WARP, (4, 4): WARP, (2, 2, 2): WARP, (1, 8): WARP,
                (4, 8): WARP, (8, 8): THREAD}


@pytest.mark.parametrize("dims", sorted(FABRIC_PATHS), ids=str)
def test_router_path_picks_warp_up_to_32_ranks(dims):
    P, NL = int(np.prod(dims)), len(make_links(dims))
    assert router_path(P, 2, NL, 6, 8) == FABRIC_PATHS[dims]
    # the halo permute's router shape (128 packets a rank, transit 4)
    assert router_path(P, 1, NL, 128, 4) == FABRIC_PATHS[dims]


def test_router_path_takes_the_packet_reductions_at_8_ranks():
    """The packet reductions' router shapes at 8 ranks, 2,048 float32 a
    packet: the ring steps (1,024 packets a rank, transit 1,026) and the
    rooted reduce's whole rows (8,192 packets, transit 8,194: 2^16 origins,
    16-bit rings, 196 KB of shared memory)."""
    assert router_path(8, 1, 3, 1024, 1026) == WARP
    assert warp_shared_bytes(8, 1, 3, 8192, 8194) == 4 * (48 + 64 + 8) + 2 * 8 * 8194 + 65536
    assert router_path(8, 1, 3, 8192, 8194) == WARP


def test_router_path_falls_to_thread_where_the_warp_cannot_hold_the_shape():
    assert router_path(8, 31, 3, 4, 4) == WARP  # 32 candidates: a lane each
    assert router_path(8, 32, 3, 4, 4) == THREAD
    assert router_path(33, 1, 4, 4, 4) == THREAD
    # 32 lanes a rank: 32 control and 32 delivery warps do not fit a block
    assert router_path(16, 31, 3, 4, 4) == WARP
    assert router_path(17, 31, 3, 4, 4) == THREAD
    assert [warp_lanes(1, 3), warp_lanes(2, 4), warp_lanes(4, 6), warp_lanes(31, 3)] == \
        [4, 4, 8, 32]
    assert router_path(8, 1, 3, 1 << 17, 4) == THREAD  # 2^20 origins
    assert warp_shared_bytes(8, 1, 3, 4, 15000) > 232448
    assert router_path(8, 1, 3, 4, 15000) == THREAD
    assert warp_shared_bytes(8, 1, 3, 1 << 14, 8) == 4 * (48 + 64 + 8) + 4 * 8 * 8 + (1 << 17)


def _card_run(dims, topo, cfg_kw, msgs, n_steps, path, device):
    """One router job on the card through ``path``, the vector and the scalar
    routers: (kernel outputs with ticks, [vector outputs, scalar outputs])."""
    P = int(np.prod(dims))
    names = ("x", "y", "z")[:len(dims)]
    comm = Communicator.create(names, dims, device=device)
    cfg = RouterConfig(dims=dims, **cfg_kw)
    pay = np.zeros((P, cfg.n_ports, cfg.fifo_cap, cfg.pkt_elems), np.float32)
    dst = np.zeros((P, cfg.n_ports, cfg.fifo_cap), np.int32)
    ln = np.zeros((P, cfg.n_ports), np.int32)
    for s, p, d, val in msgs:
        if ln[s, p] < cfg.fifo_cap:
            pay[s, p, ln[s, p]], dst[s, p, ln[s, p]] = val, d
            ln[s, p] += 1
    tbl = make_router_tables(topo, dims)
    args = [torch.from_numpy(a).to(device) for a in (tbl, pay, dst, ln)]
    _, link_ids, src = _fabric(tuple(dims), device)
    spec = tick_spec_of(cfg, P, link_ids)
    before = (router_run.launches, router_run.warp_launches)
    got = router_run(spec, args[0], src, args[1], args[2], args[3], n_steps, path=path)
    torch.cuda.synchronize()
    assert (router_run.launches, router_run.warp_launches) == \
        (before[0] + 1, before[1] + (path == WARP)), f"the {path} counter did not move"
    want = [[o.cpu().numpy() for o in run_router(cfg, comm, *args, n_steps, impl=impl)]
            for impl in ("vector", "scalar")]
    for w, impl in zip(want, ("vector", "scalar")):
        _assert_outs_equal(got[:4], w, f"{path} vs {impl}")
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("path", [WARP, THREAD])
@pytest.mark.parametrize("cfg_name", sorted(EQ_CFGS))
@pytest.mark.parametrize("topo", ["torus", "snake_bus"])
def test_kernel_paths_match_plain_routers(topo, cfg_name, path, cuda_device):
    kw = _cfg(**EQ_CFGS[cfg_name])
    msgs = _rand_msgs(kw["n_ports"], np.random.RandomState(len(cfg_name) + 7))
    t = Topology.torus(DIMS) if topo == "torus" else snake_bus(DIMS)
    _card_run(DIMS, t, kw, msgs, 64, path, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("path", [WARP, THREAD])
def test_kernel_paths_count_the_out_cap_overrun(path, cuda_device):
    kw = dict(n_ports=1, fifo_cap=8, transit_cap=16, out_cap=2, pkt_elems=4)
    got, _ = _card_run(DIMS, Topology.torus(DIMS), kw,
                       [(s, 0, 0, float(10 + s)) for s in (1, 2, 4, 5)], 64, path, cuda_device)
    assert int(got[1][0, 0]) == 2 and int(got[2].sum()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("path", [WARP, THREAD])
def test_kernel_paths_respect_the_step_budget(path, cuda_device):
    kw = dict(n_ports=1, fifo_cap=8, transit_cap=8, out_cap=8, pkt_elems=4)
    msgs = [(s, 0, (s + 1 + k) % N, float(10 * s + k)) for s in range(N) for k in range(4)]
    got, _ = _card_run(DIMS, Topology.torus(DIMS), kw, msgs, 5, path, cuda_device)
    assert int(got[4]) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("path", [WARP, THREAD])
def test_kernel_paths_count_an_undersized_transit(path, cuda_device):
    """transit_cap 1 under traffic that forwards several packets through the
    same ranks: the parks past the cap drop and count."""
    kw = dict(n_ports=2, fifo_cap=6, transit_cap=1, out_cap=16, pkt_elems=4, R=4)
    msgs = [(s, p, (s + 2 + 3 * p) % N, float(s * 10 + p)) for s in range(N) for p in range(2)
            for _ in range(3)]
    got, _ = _card_run(DIMS, Topology.torus(DIMS), kw, msgs, 64, path, cuda_device)
    assert int(got[2].sum()) > 0


#: (dims, topology) of the seeded traffic cases: every fabric the suite knows
TRAFFIC = [((2, 4), "torus"), ((2, 4), "snake_bus"), ((8,), "torus"), ((4, 4), "torus"),
           ((2, 2, 2), "torus"), ((1, 8), "torus"), ((4, 8), "torus"), ((8, 8), "torus")]


@pytest.mark.cuda
@pytest.mark.parametrize("path", [WARP, THREAD])
@pytest.mark.parametrize("case", TRAFFIC, ids=lambda c: f"{c[1]}{c[0]}")
def test_kernel_paths_on_seeded_traffic(case, path, cuda_device):
    dims, topo = case
    P = int(np.prod(dims))
    if path == WARP and FABRIC_PATHS[dims] != WARP:
        with pytest.raises(ValueError, match="warp path"):
            _card_run(dims, Topology.torus(dims), _cfg(n_ports=1), [], 8, path, cuda_device)
        return
    rng = np.random.RandomState(P + len(dims) + (topo == "snake_bus"))
    kw = dict(n_ports=2, fifo_cap=6, transit_cap=12, out_cap=12, pkt_elems=8, R=4,
              switch_bubble=bool(P % 3))
    msgs = [(s, p, int(rng.randint(0, P)), float(rng.randint(1, 999)))
            for s in range(P) for p in range(2) for _ in range(rng.randint(0, 7))]
    t = Topology.torus(dims) if topo == "torus" else snake_bus(dims)
    got, _ = _card_run(dims, t, kw, msgs, 96, path, cuda_device)
    assert int(got[1].sum()) > 0


# -- the block-tick form (ranks as processes) -----------------------------------------

#: blocks of ranks a process may hold: (lo, n)
BLOCKS = [(5, 1), (4, 4), (0, 8)]


def _block_inputs(spec, st, inq, arr, lo, n, device="cpu"):
    """One block's rows of a random tick of :func:`_rand_tick`: its state,
    staged input and route-table rows, and its arrivals packed as link rows."""
    from repro_torch.kernels.router import pack_rows

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a[lo:lo + n])).to(device)

    packed = pack_rows(*(rows(a) for a in arr))
    return {k: rows(v) for k, v in st.items()}, [rows(a) for a in inq], packed


@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: f"lo{b[0]}n{b[1]}")
@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_block_tick_matches_reference_per_rank(case, block, ref):
    """The block-tick form on the CPU (its plain version) on a block's rows
    equals the reference's ``router_tick`` of each of its ranks, and with
    ``arbitrate=False`` the reference's ``router_absorb``."""
    from repro_torch.kernels.router import router_tick_block, unpack_rows

    c, (lo, n) = TICK_CASES[case], block
    links = make_links(DIMS)
    spec_kw = dict(n=N, n_ports=c["n_ports"], fifo_cap=5, transit_cap=4, out_cap=3, pkt_elems=3,
                   R=c["R"], switch_bubble=c["switch_bubble"],
                   link_ids=tuple(lid for lid, _ in links))
    spec, rspec = TickSpec(**spec_kw), ref.rref.TickSpec(**spec_kw)
    tbl = _table(c["topo"])
    jnp = ref.jnp
    st, inq, arr, t = _rand_tick(spec, np.random.RandomState(sum(map(ord, case)) + lo), c.get(
        "full", False))
    b_st, b_inq, b_arr = _block_inputs(spec, st, inq, arr, lo, n)
    b_tbl = torch.from_numpy(tbl[lo:lo + n].copy())
    got_st, snd, pend = router_tick_block(spec, b_tbl, *b_inq, b_st, b_arr, lo, t)
    abs_st, none_snd, none_pend = router_tick_block(spec, b_tbl, *b_inq, b_st, b_arr, lo, t,
                                                    arbitrate=False)
    assert none_snd is None and none_pend is None
    snd = (*unpack_rows(snd), pend)
    def own(a):  # a copy: an eager reference call may write into a buffer it aliases
        return jnp.array(np.array(a))

    for i, r in enumerate(range(lo, lo + n)):
        want = ref.rref.router_tick(rspec, own(tbl[r]), *(own(v[r]) for v in inq),
                                    {k: own(v[r]) for k, v in st.items()},
                                    *(own(v[r]) for v in arr), jnp.int32(r), jnp.int32(t))
        absorbed = ref.rref.router_absorb(rspec, {k: own(v[r]) for k, v in st.items()},
                                          *(own(v[r]) for v in arr), jnp.int32(r),
                                          jnp.int32(t - 1))
        for k in STATE_KEYS:
            assert got_st[k][i].numpy().tobytes() == np.asarray(want[0][k]).tobytes(), \
                f"rank {r}: state {k}"
            assert abs_st[k][i].numpy().tobytes() == np.asarray(absorbed[k]).tobytes(), \
                f"rank {r}: absorbed state {k}"
        for j, name in enumerate(("snd_pay", "snd_dst", "snd_prt", "snd_val", "pending")):
            g, w = snd[j][i].numpy(), np.asarray(want[j + 1])
            assert g.shape == w.shape and g.tobytes() == w.astype(g.dtype).tobytes(), \
                f"rank {r}: {name}"


def test_link_rows_round_trip_any_bits():
    from repro_torch.kernels.router import pack_rows, unpack_rows

    rng = np.random.RandomState(5)
    bits = rng.randint(-2**31, 2**31 - 1, (3, 4, 7), dtype=np.int64).astype(np.int32)
    bits[0, 0, :3] = np.array([0x7FC00001, 0x7F800001, -1], dtype=np.int64).astype(np.int32)
    pay = torch.from_numpy(bits).view(torch.float32)
    dst = torch.from_numpy(rng.randint(-1, 8, (3, 4)).astype(np.int32))
    prt = torch.from_numpy(rng.randint(0, 3, (3, 4)).astype(np.int32))
    val = torch.from_numpy(rng.rand(3, 4) < 0.5)
    rows = pack_rows(pay, dst, prt, val)
    assert rows.dtype == torch.int32 and rows.shape == (3, 4, 3 + 7)
    back = unpack_rows(rows)
    assert back[0].view(torch.int32).equal(pay.view(torch.int32))
    for a, b in zip(back[1:], (dst, prt, val)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: f"lo{b[0]}n{b[1]}")
@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_block_tick_kernel_matches_plain(case, block, cuda_device):
    """Kernel C's block-tick form against its plain version on the card, on
    the random ticks of the reference comparison (wrapped rings, full
    buffers): every state tensor, the send rows and the pending counts bit
    for bit, and the absorb alone; one launch a call."""
    from repro_torch.kernels.router import router_tick_block, router_tick_block_plain

    c, (lo, n) = TICK_CASES[case], block
    links = make_links(DIMS)
    spec = TickSpec(n=N, n_ports=c["n_ports"], fifo_cap=5, transit_cap=4, out_cap=3,
                    pkt_elems=3, R=c["R"], switch_bubble=c["switch_bubble"],
                    link_ids=tuple(lid for lid, _ in links))
    tbl = torch.from_numpy(_table(c["topo"])[lo:lo + n].copy()).to(cuda_device)
    st, inq, arr, t = _rand_tick(spec, np.random.RandomState(len(case) + lo),
                                 c.get("full", False))
    for arbitrate in (True, False):
        b_st, b_inq, b_arr = _block_inputs(spec, st, inq, arr, lo, n, cuda_device)
        want = router_tick_block_plain(spec, tbl, *b_inq, b_st, b_arr, lo, t, arbitrate)
        before = router_tick_block.launches
        got = router_tick_block(spec, tbl, *b_inq, {k: v.clone() for k, v in b_st.items()},
                                b_arr, lo, t, arbitrate)
        torch.cuda.synchronize()
        assert router_tick_block.launches == before + 1
        for k in STATE_KEYS:
            assert got[0][k].cpu().numpy().tobytes() == want[0][k].cpu().numpy().tobytes(), k
        if arbitrate:
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        else:
            assert got[1] is None and got[2] is None


@pytest.mark.cuda
def test_block_tick_kernel_refuses_bad_input(cuda_device):
    from repro_torch.kernels.router import init_state, router_tick_block

    links = make_links(DIMS)
    spec = TickSpec(n=N, n_ports=1, fifo_cap=4, transit_cap=4, out_cap=4, pkt_elems=4, R=8,
                    switch_bubble=False, link_ids=tuple(lid for lid, _ in links))
    dev = cuda_device
    st = init_state(spec, 2, dev)
    tbl = torch.zeros((2, N), dtype=torch.int32, device=dev)
    pay = torch.zeros((2, 1, 4, 4), device=dev)
    dst = torch.zeros((2, 1, 4), dtype=torch.int32, device=dev)
    ln = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    arr = torch.zeros((2, len(links), 3 + 4), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        router_tick_block(spec, tbl, pay.double(), dst, ln, st, arr, 0, 1)
    with pytest.raises(ValueError, match="shape"):
        router_tick_block(spec, tbl, pay, dst, ln, st, arr[:, :1].contiguous(), 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        router_tick_block(spec, tbl, pay, dst, ln, st, arr.repeat(1, 1, 2)[:, :, ::2], 0, 1)
    with pytest.raises(ValueError, match="does not take"):
        router_tick_block(spec, tbl, pay, dst, ln, st, arr, 7, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["packet", "packet:pallas"])
def test_process_packet_on_the_card_ticks_the_block_form(key, cuda_device):
    """The packet wire with the ranks as 2 processes of 4 on the card: a
    shift equal to the static wire's, no loss, the block-tick form launched
    in both processes."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _torch_spmd_packet_cases as K

    from repro_torch.core import SpmdGroup
    from repro_torch.transport import get_transport

    x = torch.from_numpy(np.random.RandomState(7).randn(N, 12, 3).astype(np.float32))
    comm_args = {"axis_names": ("x", "y"), "axis_sizes": DIMS}
    with SpmdGroup(2, N, device=cuda_device, slot_bytes=1 << 16) as group:
        before = group.run(K.block_tick_launches, comm_args)
        got = group.run(K.packet_steps, comm_args, x, False, 8, key)["shift+1"]
        after = group.run(K.block_tick_launches, comm_args)
    comm = Communicator.create(("x", "y"), DIMS, device=cuda_device)
    want = get_transport("static", device=cuda_device).shift(x.to(cuda_device), comm, 1)
    assert torch.equal(got["y"].view(torch.int32), want.cpu().view(torch.int32))
    assert int(got["overflow"].sum()) == 0
    assert all(a > b for a, b in zip(after, before))
