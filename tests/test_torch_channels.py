"""The port's channels (``repro_torch.channels``) against ``repro.channels``.

Each scenario of tests/test_channels.py runs in both packages on the same
numpy inputs: the reference per rank under ``jit(shard_map)`` on the 8 host
devices, the port on one rank-stacked CPU tensor.  Raw wires (static,
fused, packet) must agree bit for bit (tolerance 0), with equal steps,
bytes and ``by_tag``; so must the int8 wire's moves (the codec's bits are
equal), while its reductions stay within the bounds of
:data:`LOSSY_ATOL`; a p2p channel's tagged counts must equal
``repro.netsim.predict_channel_stats``.  Port claims (claim, lapse, double
close, persistent pool) are compared operation by operation.

The reference is imported inside the ``R`` fixture, so the cases marked
``cuda`` (the gates of ``chip_smoke.py``'s channel phases, skipped where
there is no card) run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_channels.py
"""

import dataclasses
import gc
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.channels as pch
import repro_torch.core.collectives as pc
from repro_torch.core import Communicator, PortAllocator, Topology, stream_p2p
from repro_torch.transport import get_transport

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

P = 8
BACKENDS = ("static", "packet", "fused", "compressed")
#: rank layouts: name -> (axis names, axis sizes, bus?)
LAYOUTS = {"ring1x8": (("x",), (8,), False), "torus2x4": (("x", "y"), (2, 4), False),
           "bus8": (("x",), (8,), True)}


@pytest.fixture(scope="module")
def R():
    """The reference side (imports JAX): its channel API, a runner of one
    function per rank under ``shard_map``, and its transports."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    import repro.channels as rch
    import repro.core as rcore
    from repro.core import make_test_mesh, run_spmd
    from repro.netsim import predict_channel_stats
    from repro.transport import available_transports
    from repro.transport import get_transport as ref_get

    # the reference registry loads its built-ins only while "static" is
    # unregistered: load them before importing a backend module directly
    available_transports()
    from repro.transport.fused import FusedTransport

    def comm(layout):
        names, sizes, bus = LAYOUTS[layout]
        return rcore.Communicator.create(names, sizes,
                                         topology=rcore.Topology.bus(8) if bus else None)

    def run(fn, layout, *stacks, n_out=1, replicated=()):
        """``fn(*per_rank_args)`` on every rank; a stack is ``(P, ...)``
        with rank r's argument in row r, or (index in ``replicated``) one
        array every rank holds."""
        names, sizes, _ = LAYOUTS[layout]
        mesh = make_test_mesh(sizes, names)
        spec = PS(names[0]) if len(names) == 1 else PS(names)
        in_specs = tuple(PS(None) if i in replicated else spec for i in range(len(stacks)))

        def per_rank(*v):
            args = [a if i in replicated else a[0] for i, a in enumerate(v)]
            out = fn(*args)
            return tuple(o[None] for o in out) if n_out > 1 else out[None]

        out = run_spmd(per_rank, mesh, in_specs, (spec,) * n_out if n_out > 1 else spec, *stacks)
        return tuple(np.asarray(o) for o in out) if n_out > 1 else np.asarray(out)

    def transport(key):
        return FusedTransport(use_pallas=False) if key == "fused" else ref_get(key)

    return SimpleNamespace(jax=jax, jnp=jnp, ch=rch, core=rcore, comm=comm, run=run,
                           transport=transport, predict=predict_channel_stats)


def port_comm(layout, device="cpu"):
    names, sizes, bus = LAYOUTS[layout]
    return Communicator.create(names, sizes, topology=Topology.bus(8) if bus else None,
                               device=device)


def _pt(key, device="cpu"):
    return get_transport(key, device=device)


def bits_equal(got, want, msg=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{msg}: shape {got.shape} != {want.shape}"
    assert got.dtype.itemsize == want.dtype.itemsize, f"{msg}: {got.dtype} vs {want.dtype}"
    assert got.tobytes() == want.tobytes(), f"{msg}: values differ"


def stats_equal(pt, rt, msg=""):
    assert (pt.stats.steps, pt.stats.bytes_moved) == (rt.stats.steps, rt.stats.bytes_moved), msg
    assert pt.stats.by_tag == rt.stats.by_tag, msg


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _col(acc, i, valid, val):
    """``acc[:, i] = val`` where ``valid`` (the reference's masked
    ``acc.at[i].set`` on every rank)."""
    acc = acc.clone()
    acc[:, i] = torch.where(valid, val, acc[:, i])
    return acc


# ---------------------------------------------------------------------------
# port claims, operation by operation
# ---------------------------------------------------------------------------


def _claims_scenario(M, comm):
    """One sequence of allocator operations; returns what each step saw."""
    seen = []

    def raises(fn):
        try:
            fn()
        except Exception as e:  # the reference asserts where the port raises
            return type(e).__name__ in ("ValueError", "AssertionError", "RuntimeError")
        return False

    def rows(pa):
        return [(r["port"], r["persistent"], r["anonymous"], r["tag"], r["kind"])
                for r in pa.claims(comm)]

    pa = M.PortAllocator()
    pa.claim(comm, 0), pa.claim(comm, 1)
    seen += [raises(lambda: pa.claim(comm, 0))]
    pa.release_all(comm)
    pa.claim(comm, 0)
    seen += [pa.in_use(comm)]
    pa = M.PortAllocator()
    ch = M.open_channel(comm, src=0, dst=1, port=0, allocator=pa)
    seen += [pa.in_use(comm), raises(lambda: M.open_channel(comm, src=0, dst=2, port=0,
                                                             allocator=pa))]
    other = M.open_channel(comm, src=0, dst=2, port=1, allocator=pa)
    ch.close()
    seen += [pa.in_use(comm)]
    M.open_channel(comm, src=3, dst=4, port=0, allocator=pa).close()
    other.close()
    with M.open_bcast_channel(comm, root=0, port=7, allocator=pa):
        seen += [pa.in_use(comm),
                 raises(lambda: M.open_reduce_channel(comm, root=0, port=7, allocator=pa))]
    seen += [pa.in_use(comm)]
    a = M.open_channel(comm, src=0, dst=1, port=None, allocator=pa)
    b = M.open_channel(comm, src=0, dst=2, port=None, allocator=pa)
    seen += [pa.in_use(comm), rows(pa)]
    a.close(), b.close()
    del a, b
    # a stale second close frees neither a later owner's claim nor a bare one
    a = M.open_channel(comm, src=0, dst=1, port=2, tag="first", allocator=pa)
    a.close()
    b = M.open_channel(comm, src=0, dst=1, port=2, tag="second", allocator=pa)
    a.close()
    seen += [pa.in_use(comm), rows(pa),
             raises(lambda: M.open_channel(comm, src=0, dst=1, port=2, allocator=pa))]
    c = M.open_channel(comm, src=0, dst=1, port=7, allocator=pa)
    c.close()
    pa.claim(comm, 7)
    c.close()
    seen += [pa.in_use(comm)]
    pa.release(comm, 7)
    b.close()
    seen += [pa.in_use(comm), rows(pa)]
    # a claim lapses with the last channel object holding its spec
    ch = M.open_channel(comm, src=0, dst=1, port=2, allocator=pa)
    del ch
    gc.collect()
    seen += [pa.in_use(comm)]
    M.open_channel(comm, src=0, dst=1, port=2, allocator=pa).close()
    # the persistent pool: claims survive their users, sequential ports
    pool = M.ChannelPool(comm, allocator=pa)
    spec = pool.spec("decode.mlp")
    port = spec.port
    del spec
    gc.collect()
    seen += [port, pa.in_use(comm), rows(pa), raises(lambda: pa.claim(comm, port))]
    s2 = pool.spec("decode.attn", kind="gather")
    seen += [pool.spec("decode.mlp").port, s2.port, s2.tag, s2.kind, s2.persistent,
             pool.ports(), len(pool), "decode.attn" in pool, pool.retag("serve.x"),
             [(r["port"], r["tag"], r["persistent"]) for r in pool.claims()]]
    pool.close()
    pool.close()
    seen += [pa.in_use(comm), pool.claims(), raises(lambda: pool.spec("again"))]
    with M.ChannelPool(comm, allocator=pa, base_port=40, prefix="p.") as pool2:
        seen += [pool2.spec("t").port, pool2.spec("t").tag, pa.in_use(comm)]
    seen += [pa.in_use(comm)]
    return seen


def test_port_claims_match_reference(R):
    want = _claims_scenario(SimpleNamespace(**vars(R.ch), PortAllocator=R.core.PortAllocator),
                            R.comm("ring1x8"))
    got = _claims_scenario(SimpleNamespace(**vars(pch), PortAllocator=PortAllocator),
                           port_comm("ring1x8"))
    assert got == want


def test_claims_are_keyed_per_communicator():
    pa = PortAllocator()
    c1, c2 = port_comm("ring1x8"), port_comm("ring1x8")
    a = pch.open_channel(c1, port=0, allocator=pa)
    b = pch.open_channel(c2, port=0, allocator=pa)
    assert pa.in_use(c1) == pa.in_use(c2) == (0,)
    a.close(), b.close()


# ---------------------------------------------------------------------------
# ChannelSpec, comm modes, the layer spec with a pool
# ---------------------------------------------------------------------------


def test_channel_spec_wire_and_comm_modes():
    comm = port_comm("ring1x8")
    assert pch.default_channel_spec(comm, "smi:packet").transport == "packet"
    assert pch.default_channel_spec(comm, "smi").transport == "static"
    spec = pch.default_channel_spec(comm, "smi:compressed:packet")
    assert spec.transport == spec.transport_key == "compressed:packet"
    with pytest.raises(ValueError):
        pch.default_channel_spec(comm, "bulk")
    spec = pch.ChannelSpec(comm=comm, transport="packet", wire="int8")
    assert spec.transport_key == "compressed:packet"
    t = spec.resolve()
    assert type(t).__name__ == "CompressedTransport" and t.inner.name == "packet"
    live = _pt("fused")
    wrapped = pch.ChannelSpec(comm=comm, transport=live, wire="int8").resolve()
    assert wrapped.inner is live and wrapped.stats is live.stats
    assert pch.ChannelSpec(comm=comm, transport=live).transport_key == "fused"
    assert pch.ChannelSpec(comm=comm, transport=wrapped).transport_key == "compressed:fused"
    assert pch.ChannelSpec(comm=comm, port=4).stats_tag == "port4"
    assert pch.ChannelSpec(comm=comm, port=4, tag="h").stats_tag == "h"
    assert pch.ChannelSpec(comm=comm, port=None).stats_tag is None
    spec = pch.ChannelSpec(comm=port_comm("bus8"), src=0, dst=7)
    assert spec.hops == 7 and spec.path == list(range(8))
    assert spec.step_transport() is spec.step_transport()
    with pytest.raises(ValueError):
        pch.ChannelSpec(comm=comm, wire="fp4")


def test_exports_match_reference(R):
    assert pch.__all__ == R.ch.__all__
    import repro_torch.core as pcore
    import repro_torch.core.streaming as pstream

    for name in ("open_channel", "push", "pop", "channel_transfer", "Channel", "ChannelSpec"):
        assert getattr(pstream, name) is getattr(pch, name)
        assert getattr(pcore, name) is getattr(pch, name)
    assert pcore.stream_p2p is pstream.stream_p2p


def test_layer_spec_serves_the_pool():
    from repro_torch.mesh.api import make_ctx
    from repro_torch.parallel import layers

    ctx = make_ctx((1, 4), comm_mode="smi:fused", device="cpu")
    pa = PortAllocator()
    with pch.ChannelPool(ctx.model_comm, allocator=pa) as pool:
        pctx = dataclasses.replace(ctx, channels=pool)
        spec = layers.layer_spec(pctx, "tp.attn.qkv", kind="gather")
        assert (spec.tag, spec.port, spec.persistent, spec.kind, spec.transport) == \
            ("serve.tp.attn.qkv", 100, True, "gather", "fused")
        assert layers.layer_spec(pctx, "tp.attn.qkv") is spec
        x = torch.from_numpy(_f32(4, 6, 5, seed=1))
        want = layers.all_reduce(x, ctx)
        for _ in range(3):
            bits_equal(layers.all_reduce(x, pctx), want.numpy(), "pool all_reduce")
        assert pa.in_use(ctx.model_comm) == (100, 101)
        assert [r["tag"] for r in pool.claims()] == ["serve.tp.attn.qkv", "serve.tp.allreduce"]
    assert pa.in_use(ctx.model_comm) == ()


# ---------------------------------------------------------------------------
# p2p: stream_p2p, push/pop over every backend, tagged stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,src,dst,n_chunks", [("ring1x8", 0, 5, 4), ("torus2x4", 0, 7, 3),
                                                      ("ring1x8", 3, 3, 2), ("bus8", 6, 1, 2)])
def test_stream_p2p_matches_reference(R, layout, src, dst, n_chunks):
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12) + 1.0
    rc = R.comm(layout)
    want = R.run(lambda v: R.core.stream_p2p(v, src=src, dst=dst, comm=rc, n_chunks=n_chunks),
                 layout, x)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)  # a plain call does not warn
        got = stream_p2p(torch.from_numpy(x), src=src, dst=dst, comm=port_comm(layout),
                         n_chunks=n_chunks)
    bits_equal(got, want, "stream_p2p")
    bits_equal(got[dst], x[src], "delivered")


def test_stream_p2p_keeps_int8_dtype(R):
    x = (np.arange(8 * 8).reshape(8, 8) % 127).astype(np.int8)
    rc = R.comm("ring1x8")
    want = R.run(lambda v: R.core.stream_p2p(v, src=2, dst=6, comm=rc, n_chunks=2), "ring1x8", x)
    got = stream_p2p(torch.from_numpy(x), src=2, dst=6, comm=port_comm("ring1x8"), n_chunks=2)
    assert got.dtype == torch.int8
    bits_equal(got, want, "int8 p2p")


def test_stream_p2p_deprecated_keywords_warn():
    from repro_torch.netsim import Plan

    comm = port_comm("ring1x8")
    x = torch.from_numpy(_f32(8, 16, seed=8))
    with pytest.warns(DeprecationWarning, match="open a channel"):
        legacy = stream_p2p(x, src=0, dst=4, comm=comm, n_chunks=2, transport="packet")
    chan = pch.open_channel(comm, src=0, dst=4, port=None, n_chunks=2,
                            transport="packet").transfer(x)
    assert torch.equal(legacy, chan)
    with pytest.warns(DeprecationWarning, match="open a channel"):
        legacy = stream_p2p(x, src=0, dst=5, comm=comm, plan=Plan("static", 4, "ring"))
    planned = pch.open_channel(comm, src=0, dst=5, port=None,
                               plan=Plan("static", 4, "ring")).transfer(x)
    assert torch.equal(legacy, planned) and torch.equal(legacy[5], x[0])
    with pytest.warns(DeprecationWarning, match="open a channel"):
        legacy = stream_p2p(x, src=0, dst=5, comm=comm, plan="auto")
    tuned = pch.open_channel(comm, src=0, dst=5, port=None,
                             plan=comm.plan("p2p", 16 * 4)).transfer(x)
    assert torch.equal(legacy, tuned) and torch.equal(legacy[5], x[0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_push_pop_over_backend_matches_reference(R, backend):
    """Paper Listing 1 on every backend: an element arrives after ``hops``
    pops, bubbles gate invalid, the counters track the roles; values,
    counters and the channel's tagged stats equal the reference's."""
    N, SRC, DST = 3, 0, 3
    rc = R.comm("ring1x8")
    hops = rc.route_table.n_hops(SRC, DST)
    iters = N + hops + 2
    rt = R.transport(backend)

    def ref_fn(dummy):
        jnp = R.jnp
        chan = R.ch.open_channel(rc, count=N, src=SRC, dst=DST, port=5, transport=rt,
                                 allocator=R.core.PortAllocator())
        acc = R.core.pvary(jnp.zeros((iters,), jnp.float32), rc)
        arrived = R.core.pvary(jnp.zeros((iters,), jnp.float32), rc)
        for i in range(iters):
            if i < N:
                chan = R.ch.push(chan, jnp.float32(i + 1))
            chan, val, valid = R.ch.pop(chan)
            acc = jnp.where(valid, acc.at[i].set(val), acc)
            arrived = jnp.where(valid, arrived.at[i].set(1.0), arrived)
        return acc, arrived, chan.pushed, chan.popped

    want = R.run(ref_fn, "ring1x8", np.zeros((8, 1), np.float32), n_out=4)
    pt = _pt(backend)
    chan = pch.open_channel(port_comm("ring1x8"), count=N, src=SRC, dst=DST, port=5,
                            transport=pt, allocator=PortAllocator())
    acc, arrived = torch.zeros((P, iters)), torch.zeros((P, iters))
    for i in range(iters):
        if i < N:
            chan = pch.push(chan, float(i + 1))
        chan, val, valid = pch.pop(chan)
        acc = _col(acc, i, valid, val)
        arrived = _col(arrived, i, valid, torch.ones(P))
    for name, g, w in zip(("acc", "arrived", "pushed", "popped"),
                          (acc, arrived, chan.pushed, chan.popped), want):
        bits_equal(g, w, f"{name} over {backend}")
    stats_equal(pt, rt, backend)
    assert pt.stats.tag_counts("port5") == (pt.stats.steps, pt.stats.bytes_moved) != (0, 0)
    want_arrival = np.zeros(iters)
    want_arrival[hops - 1:hops - 1 + N] = 1.0
    bits_equal(arrived[DST], want_arrival.astype(np.float32), "arrival = hops")
    assert chan.pushed.tolist() == [N] + [0] * 7
    assert chan.popped.tolist() == [N if r == DST else 0 for r in range(P)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_p2p_transfer_tagged_stats_match_netsim(R, backend):
    """A p2p channel's tagged stats equal ``predict_channel_stats`` to the
    byte, and its message equals the reference's bit for bit."""
    shape, n_chunks, dst = (32,), 4, 5
    x = _f32(8, *shape, seed=3)
    rc = R.comm("ring1x8")
    rt = R.transport(backend)
    want = R.run(lambda v: R.ch.open_channel(
        rc, src=0, dst=dst, port=6, transport=rt, n_chunks=n_chunks,
        allocator=R.core.PortAllocator()).transfer(v), "ring1x8", x)
    pt = _pt(backend)
    ch = pch.open_channel(port_comm("ring1x8"), src=0, dst=dst, port=6, transport=pt,
                          n_chunks=n_chunks, allocator=PortAllocator())
    got = pch.channel_transfer(ch, torch.from_numpy(x))
    bits_equal(got, want, backend)
    stats_equal(pt, rt, backend)
    spec = R.ch.ChannelSpec(comm=rc, kind="p2p", src=0, dst=dst, port=6, transport=backend,
                            n_chunks=n_chunks)
    assert pt.stats.tag_counts("port6") == R.predict(spec, shape=shape)
    assert pt.stats.tag_counts("port6") == (pt.stats.steps, pt.stats.bytes_moved)


# ---------------------------------------------------------------------------
# collective channels: element-level push/pop
# ---------------------------------------------------------------------------


def _ref_pop_loop(R, opener, layout, x, iters, n_take):
    """The reference tests' fori loop: push element min(i, n_take - 1) of
    each rank's row, pop, record value and validity."""
    jax, jnp = R.jax, R.jnp
    rc = R.comm(layout)

    def fn(v):
        chan = opener(rc)
        acc = R.core.pvary(jnp.zeros((iters,), jnp.float32), rc)
        hit = R.core.pvary(jnp.zeros((iters,), jnp.float32), rc)

        def body(i, carry):
            chan, acc, hit = carry
            chan = chan.push(jax.lax.dynamic_index_in_dim(v, jnp.minimum(i, n_take - 1), 0,
                                                          keepdims=False))
            chan, val, valid = chan.pop()
            return (chan, jnp.where(valid, acc.at[i].set(val), acc),
                    jnp.where(valid, hit.at[i].set(1.0), hit))

        chan, acc, hit = jax.lax.fori_loop(0, iters, body, (chan, acc, hit))
        return acc, hit, chan.popped, chan.pushed

    return R.run(fn, layout, x, n_out=4)


def _port_pop_loop(chan, x, iters, n_take):
    acc, hit = torch.zeros((P, iters)), torch.zeros((P, iters))
    for i in range(iters):
        chan = chan.push(x[:, min(i, n_take - 1)])
        chan, val, valid = chan.pop()
        acc = _col(acc, i, valid, val)
        hit = _col(hit, i, valid, torch.ones(P))
    return acc, hit, chan.popped, chan.pushed


@pytest.mark.parametrize("case", ["bcast_ring", "bcast_line_mid_root", "reduce",
                                  "reduce_fused_op_max"])
def test_chain_channels_push_pop_match_reference(R, case):
    """bcast (latency = ring distance; on a bus the chain splits at the
    root) and reduce (the root pops the sums after the chain latency)."""
    N = 4 if case == "bcast_ring" else 3
    layout = "bus8" if case == "bcast_line_mid_root" else "ring1x8"
    root = 3 if case == "bcast_line_mid_root" else 0
    x = _f32(8, N, seed={"bcast_ring": 0, "bcast_line_mid_root": 1}.get(case, 2))
    iters = N + P
    kind = "bcast" if case.startswith("bcast") else "reduce"
    backend = "fused" if case == "reduce_fused_op_max" else None
    ref_op = R.jnp.maximum if case == "reduce_fused_op_max" else None
    port_op = torch.maximum if case == "reduce_fused_op_max" else None

    def ref_open(rc):
        if kind == "bcast":
            return R.ch.open_bcast_channel(rc, count=N, root=root, port=None)
        return R.ch.open_reduce_channel(rc, count=N, root=root, port=None, op=ref_op,
                                        transport=backend)

    want = _ref_pop_loop(R, ref_open, layout, x, iters, N)
    comm = port_comm(layout)
    chan = (pch.open_bcast_channel(comm, count=N, root=root, port=None) if kind == "bcast"
            else pch.open_reduce_channel(comm, count=N, root=root, port=None, op=port_op,
                                         transport=backend))
    got = _port_pop_loop(chan, torch.from_numpy(x), iters, N)
    for name, g, w in zip(("acc", "hit", "popped", "pushed"), got, want):
        bits_equal(g, w, f"{name} ({case})")
    hits = got[1].numpy()
    if kind == "bcast":
        for r in range(P):
            dist = abs(r - root) if layout == "bus8" else (r - root) % P
            want_hits = np.zeros(iters)
            want_hits[max(dist - 1, 0):max(dist - 1, 0) + N] = 1.0
            np.testing.assert_array_equal(hits[r], want_hits)
    else:
        assert hits[root].sum() == N and hits[1:].sum() == 0


def test_round_channels_push_pop_match_reference(R):
    """scatter / allreduce / gather: one schedule round a pop; the count
    gates a round past it invalid."""
    N = 2
    rng = np.random.RandomState(4)
    rows = rng.randn(N, P).astype(np.float32)  # the scatter payloads (replicated)
    mine = rng.randn(8, N).astype(np.float32)  # every rank's elements
    jnp = R.jnp
    rc = R.comm("ring1x8")

    def ref_fn(v, rws):
        sc = R.ch.open_scatter_channel(rc, count=N, root=0, port=None)
        ar = R.ch.open_allreduce_channel(rc, count=N, port=None)
        ga = R.ch.open_gather_channel(rc, count=N, root=0, port=None)
        outs = []
        for i in range(N + 1):
            j = min(i, N - 1)
            sc, ar, ga = sc.push(rws[j]), ar.push(v[j]), ga.push(v[j])
            sc, s_val, s_ok = sc.pop()
            ar, a_val, a_ok = ar.pop()
            ga, g_val, g_ok = ga.pop()
            outs.append((s_val, a_val, g_val, s_ok.astype(jnp.float32),
                         a_ok.astype(jnp.float32), g_ok.astype(jnp.float32)))
        return tuple(jnp.stack([o[k] for o in outs]) for k in range(6))

    want = R.run(ref_fn, "ring1x8", mine, rows, n_out=6, replicated=(1,))
    comm = port_comm("ring1x8")
    sc = pch.open_scatter_channel(comm, count=N, root=0, port=None)
    ar = pch.open_allreduce_channel(comm, count=N, port=None)
    ga = pch.open_gather_channel(comm, count=N, root=0, port=None)
    tm, trows = torch.from_numpy(mine), torch.from_numpy(rows)
    outs = []
    for i in range(N + 1):
        j = min(i, N - 1)
        sc, ar, ga = sc.push(trows[j]), ar.push(tm[:, j]), ga.push(tm[:, j])
        sc, s_val, s_ok = sc.pop()
        ar, a_val, a_ok = ar.pop()
        ga, g_val, g_ok = ga.pop()
        outs.append((s_val, a_val, g_val, s_ok.float(), a_ok.float(), g_ok.float()))
    for k, name in enumerate(("scatter", "allreduce", "gather", "s_ok", "a_ok", "g_ok")):
        bits_equal(torch.stack([o[k] for o in outs], dim=1), want[k], name)
    assert not outs[N][3].any() and outs[0][3].all()  # the count gates round N


def test_p2p_count_caps_validity_matches_reference(R):
    COUNT, SRC, DST = 2, 0, 2
    rc = R.comm("ring1x8")
    hops = rc.route_table.n_hops(SRC, DST)
    iters = 4 + hops
    jnp = R.jnp

    def ref_fn(dummy):
        chan = R.ch.open_channel(rc, count=COUNT, src=SRC, dst=DST, port=None)
        acc = R.core.pvary(jnp.zeros((iters,), jnp.float32), rc)
        for i in range(iters):
            if i < 4:
                chan = R.ch.push(chan, jnp.float32(i + 1))
            chan, val, valid = R.ch.pop(chan)
            acc = jnp.where(valid, acc.at[i].set(val), acc)
        return acc, chan.popped

    want = R.run(ref_fn, "ring1x8", np.zeros((8, 1), np.float32), n_out=2)
    chan = pch.open_channel(port_comm("ring1x8"), count=COUNT, src=SRC, dst=DST, port=None)
    acc = torch.zeros((P, iters))
    for i in range(iters):
        if i < 4:
            chan = pch.push(chan, float(i + 1))
        chan, val, valid = pch.pop(chan)
        acc = _col(acc, i, valid, val)
    bits_equal(acc, want[0], "acc")
    bits_equal(chan.popped, want[1], "popped")
    assert int(chan.popped[DST]) == COUNT
    assert acc[DST][acc[DST] != 0].tolist() == [1.0, 2.0]


def test_collective_push_overrun_refused_matches_reference(R):
    """Pushes past the P-deep credit window are refused, never overwriting
    an undelivered element."""
    N = 10
    x = _f32(8, N, seed=6)
    jax, jnp = R.jax, R.jnp
    rc = R.comm("ring1x8")

    def ref_fn(v):
        chan = R.ch.open_bcast_channel(rc, count=N, root=0, port=None)
        for i in range(N):
            chan = chan.push(v[i])
        accepted = chan.pushed
        acc = R.core.pvary(jnp.zeros((N,), jnp.float32), rc)

        def body(i, carry):
            chan, acc = carry
            chan, val, valid = chan.pop()
            return chan, jnp.where(valid, acc.at[jnp.minimum(i, N - 1)].set(val), acc)

        chan, acc = jax.lax.fori_loop(0, N + P, body, (chan, acc))
        return acc, accepted, chan.popped

    want = R.run(ref_fn, "ring1x8", x, n_out=3)
    chan = pch.open_bcast_channel(port_comm("ring1x8"), count=N, root=0, port=None)
    tx = torch.from_numpy(x)
    for i in range(N):
        chan = chan.push(tx[:, i])
    accepted = chan.pushed
    acc = torch.zeros((P, N))
    for i in range(N + P):
        chan, val, valid = chan.pop()
        acc = _col(acc, min(i, N - 1), valid, val)
    for name, g, w in zip(("acc", "accepted", "popped"), (acc, accepted, chan.popped), want):
        bits_equal(g, w, name)
    assert int(accepted[0]) == P and int(chan.popped[0]) == P
    bits_equal(acc[0, :P], x[0, :P], "the first P pushes unmangled")


# ---------------------------------------------------------------------------
# collective channels: transfer == stream_* on every backend and layout
# ---------------------------------------------------------------------------


def _codec_atol(x, hops_quantised=1):
    """The reference's bound (tests/test_compressed.py): ``hops_quantised``
    independent int8 roundings of data bounded by max|x|, half a step of
    max|x| / 127 each."""
    return hops_quantised * float(np.max(np.abs(x))) / 254.0 * 1.05 + 1e-6


#: how far the port's and the reference's results over the int8 wire may
#: part: the reference's XLA fuses a dequantise and the add after it into
#: one FMA, which rounds once where the port rounds twice, so a code can
#: land one step apart.  A value quantised once (bcast, gather, scatter)
#: stays within two half steps; the all-reduce within the reference's own
#: bound (P once-quantised contributions, then the reduced blocks once) on
#: each side; the reduce chain re-rounds its travelling partial at each of
#: P - 1 hops, each at most max|partial| = the sum of |x| over ranks.
LOSSY_ATOL = {
    "bcast": lambda x, g, f: 2 * _codec_atol(x),
    "gather": lambda x, g, f: 2 * _codec_atol(g),
    "scatter": lambda x, g, f: 2 * _codec_atol(f),
    "allreduce": lambda x, g, f: 2 * (_codec_atol(x, P) + _codec_atol(x.sum(0))),
    "reduce": lambda x, g, f: 2 * _codec_atol(np.abs(x).sum(0), P - 1),
}


@pytest.mark.parametrize("layout", ["ring1x8", "torus2x4"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_collective_channels_match_stream_and_reference(R, layout, backend):
    """bcast / reduce / gather / scatter / allreduce over transient
    collective channels equal the deprecated ``stream_*`` shims (which warn)
    bit for bit on all four backends, and the reference's channels bit for
    bit on the raw wires (within :data:`LOSSY_ATOL` on the int8 one), with
    equal stats; on the exact wires they are the true results."""
    rng = np.random.RandomState(7)
    x = rng.randn(P, 4, 3).astype(np.float32)
    g = rng.randn(P, 2, 3).astype(np.float32)
    full = rng.randn(P * 2, 3).astype(np.float32)
    rc, rt = R.comm(layout), R.transport(backend)

    def ref_fn(v, gv, fv):
        ch = R.ch
        return (ch.open_bcast_channel(rc, root=1, port=None, transport=rt, n_chunks=2).transfer(v),
                ch.open_reduce_channel(rc, root=0, port=None, transport=rt,
                                       n_chunks=2).transfer(v),
                ch.open_gather_channel(rc, root=0, port=None, transport=rt).transfer(gv),
                ch.open_scatter_channel(rc, root=0, port=None, transport=rt).transfer(fv),
                ch.open_allreduce_channel(rc, port=None, transport=rt).transfer(v))

    want = R.run(ref_fn, layout, x, g, full, n_out=5, replicated=(2,))
    comm, pt = port_comm(layout), _pt(backend)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tf = torch.from_numpy(np.broadcast_to(full, (P,) + full.shape).copy())
    got = (pch.open_bcast_channel(comm, root=1, port=None, transport=pt, n_chunks=2).transfer(tx),
           pch.open_reduce_channel(comm, root=0, port=None, transport=pt,
                                   n_chunks=2).transfer(tx),
           pch.open_gather_channel(comm, root=0, port=None, transport=pt).transfer(tg),
           pch.open_scatter_channel(comm, root=0, port=None, transport=pt).transfer(tf),
           pch.open_allreduce_channel(comm, port=None, transport=pt).transfer(tx))
    with pytest.warns(DeprecationWarning, match="deprecated transient-channel shim"):
        st = _pt(backend)
        shims = (pc.stream_bcast(tx, comm, root=1, n_chunks=2, transport=st),
                 pc.stream_reduce(tx, comm, root=0, n_chunks=2, transport=st),
                 pc.stream_gather(tg, comm, root=0, transport=st),
                 pc.stream_scatter(tf, comm, root=0, transport=st),
                 pc.stream_allreduce(tx, comm, transport=st))
    for kind, a, b, w in zip(("bcast", "reduce", "gather", "scatter", "allreduce"), got, shims,
                             want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{kind} vs shim"
        if backend != "compressed":
            bits_equal(a, w, f"{kind} channel vs reference on {backend}@{layout}")
        else:  # same codec bits; XLA fuses dequantise-and-add into an FMA
            np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=LOSSY_ATOL[kind](x, g, full),
                                       err_msg=f"{kind} on {layout}")
    stats_equal(pt, rt, f"{backend}@{layout}")
    if backend != "compressed":
        b, r, gt, s, a = (o.numpy() for o in got)
        for rr in range(P):
            np.testing.assert_allclose(b[rr], x[1], rtol=1e-6)
            np.testing.assert_allclose(a[rr], x.sum(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[0], x.sum(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gt[0].reshape(P, 2, 3), g, rtol=1e-6)
        np.testing.assert_allclose(s.reshape(P * 2, 3), full, rtol=1e-6)


def test_collective_channel_plan_path_keeps_tag(R):
    """A planned collective transfer moves through the channel's backend and
    accounts every step under its stats tag."""
    from repro.netsim.tune import Plan as RefPlan

    from repro_torch.netsim import Plan

    x = _f32(8, 4, 3, seed=11)
    rc, rt = R.comm("ring1x8"), R.transport("static")
    plan = RefPlan(transport="static", n_chunks=2, algo="ring", wire="raw")
    want = R.run(lambda v: R.ch.open_bcast_channel(
        rc, root=0, port=4, transport=rt, plan=plan,
        allocator=R.core.PortAllocator()).transfer(v), "ring1x8", x)
    pt = _pt("static")
    got = pch.open_bcast_channel(port_comm("ring1x8"), root=0, port=4, transport=pt,
                                 plan=Plan("static", 2, "ring"),
                                 allocator=PortAllocator()).transfer(torch.from_numpy(x))
    bits_equal(got, want, "planned bcast")
    stats_equal(pt, rt)
    assert pt.stats.tag_counts("port4") == (pt.stats.steps, pt.stats.bytes_moved) != (0, 0)


# ---------------------------------------------------------------------------
# GESUMMV (paper §5.4.1) against benchmarks/gesummv.py's arithmetic
# ---------------------------------------------------------------------------


def test_gesummv_matches_the_benchmark_arithmetic(R):
    """``y = 1.5 A x + 2.5 B x`` on one rank and over two stacked ranks whose
    partial GEMVs meet through a channel, within the benchmark's 2e-4 of
    the reference's JAX single-rank result (both GEMVs are float32
    products, summed in other orders)."""
    import importlib
    import sys
    from pathlib import Path

    from repro_torch.apps import gesummv, gesummv_two_ranks

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    bench = importlib.import_module("benchmarks.gesummv")
    N = 256
    rng = np.random.RandomState(0)
    A, B = rng.randn(N, N).astype(np.float32), rng.randn(N, N).astype(np.float32)
    x = rng.randn(N).astype(np.float32)
    jnp = R.jnp
    want = np.asarray(bench.ALPHA * (jnp.asarray(A) @ jnp.asarray(x))
                      + bench.BETA * (jnp.asarray(B) @ jnp.asarray(x)))
    tA, tB, tx = (torch.from_numpy(a) for a in (A, B, x))
    one = gesummv(tA, tB, tx, alpha=bench.ALPHA, beta=bench.BETA)
    two = gesummv_two_ranks(torch.stack([tA, tB]), tx, Communicator.create("x", (2,),
                                                                          device="cpu"))
    np.testing.assert_allclose(one.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(two[1].numpy(), want, rtol=2e-4, atol=2e-4)
    assert not two[0].any()


# ---------------------------------------------------------------------------
# on the card: the gates of chip_smoke.py's channel phases
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels A and C have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["static", "fused", "packet"])
def test_push_pop_latency_gate_on_card(wire, cuda_device):
    """The latency phase's gate: the first of 64 elements arrives on the
    ``hops``-th pop and all 64 arrive, at 1, 4 and 7 hops; over the packet
    wire every pop launches kernel C."""
    from repro_torch.kernels.router import router_run
    from repro_torch.launch.channels import HOPS, _check_push_pop, bus_comm, push_pop

    comm = bus_comm(cuda_device)
    for dst, hops in HOPS:
        before = router_run.launches
        ch, oks, vals = push_pop(comm, dst, get_transport(wire, device=cuda_device), 64)
        _check_push_pop(ch, oks, vals, dst, hops, 64, f"{wire} hops={hops}")
        assert (router_run.launches - before == 64 + hops - 1) == (wire == "packet")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring1x8", "torus2x4"])
def test_collective_channels_on_card_launch_kernel_a(layout, cuda_device):
    """The collective-channel phase's gate at a small size: every kind over
    ``smi:fused`` equals ``smi:static`` bit for bit; the reduce channel's
    folds and the all-reduce's ring steps launch kernel A."""
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    comm = port_comm(layout, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((P, 4096), generator=gen, device=cuda_device)
    outs = {}
    for wire in ("static", "fused"):
        before = (fused_accumulate.launches, fused_shift_accumulate.launches)
        outs[wire] = [
            pch.open_bcast_channel(comm, root=1, port=None, transport=wire).transfer(x),
            pch.open_reduce_channel(comm, root=0, port=None, transport=wire).transfer(x),
            pch.open_gather_channel(comm, root=0, port=None, transport=wire).transfer(x),
            pch.open_scatter_channel(comm, root=0, port=None, transport=wire).transfer(x),
            pch.open_allreduce_channel(comm, port=None, transport=wire).transfer(x)]
        launched = (fused_accumulate.launches - before[0],
                    fused_shift_accumulate.launches - before[1])
        assert launched == ((P - 1, P - 1) if wire == "fused" else (0, 0)), launched
    for a, b in zip(outs["static"], outs["fused"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_compressed_wire_on_card_equals_cpu(cuda_device):
    """The int8 wire's codes and scales, and a compressed all-reduce, are
    the same bits on the card as on the CPU."""
    from repro_torch.transport.compressed import _pack_wire, _quantize_rows

    x = torch.from_numpy(_f32(P, 3000, seed=12) * 10)
    bits_equal(_pack_wire(*_quantize_rows(x.to(cuda_device), 256)),
               _pack_wire(*_quantize_rows(x, 256)).numpy(), "wire")
    card = pch.open_allreduce_channel(port_comm("ring1x8", cuda_device), port=None,
                                      transport="compressed:static").transfer(x.to(cuda_device))
    cpu = pch.open_allreduce_channel(port_comm("ring1x8"), port=None,
                                     transport="compressed:static").transfer(x)
    bits_equal(card, cpu.numpy(), "compressed all-reduce")


@pytest.mark.cuda
def test_gesummv_on_card(cuda_device):
    from repro_torch.apps import gesummv, gesummv_two_ranks

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    AB = torch.randn((2, 1024, 1024), generator=gen, device=cuda_device)
    x = torch.randn(1024, generator=gen, device=cuda_device)
    want = gesummv(AB[0], AB[1], x)
    got = gesummv_two_ranks(AB, x, Communicator.create("x", (2,), device=cuda_device))
    torch.testing.assert_close(got[1], want, rtol=2e-4, atol=2e-4)
