"""The port's compressed wire (``repro_torch.transport.compressed``) against
``repro.transport.compressed``.

* **codec** — ``quantize_int8``'s codes and scales and ``dequantize_int8``
  equal the reference's compiled codec (the form its wire runs under
  ``jit``) bit for bit;
* **tolerance** — the collectives over ``compressed`` and
  ``compressed:fused`` (and an all-reduce over ``compressed:packet``) stay
  within the reference's own bounds of the raw result (tests/test_compressed
  .py's ``_codec_atol``), on ring(1x8), torus(2x4) and the snake bus;
  values that cross the wire once (p2p) equal the reference's bit for bit;
* **wire accounting** — steps and bytes equal the reference's transports
  and ``repro.netsim.predict_transport_stats`` exactly (int8 payload and
  scale sidecar);
* **reduce-scatter** — the once-quantised schedule's error stays bounded as
  P grows while re-rounding the accumulator grows with P, and its residual
  lives for one call: two calls on one instance equal two calls on fresh
  ones;
* **plumbing** — registry keys, the deprecated ``quantize=``/``dequantize=``
  keywords, lossy-dtype errors, and an int8 plan on integer data.

The reference's rolled-loop stat scaling and its cross-trace reuse guard
have no counterpart in the eager port; the optimiser's error feedback
comes with a later item, and tuned int8 plans are held in
tests/test_torch_netsim.py.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.core.collectives as pc
from repro_torch.core import Communicator, Topology, snake_bus
from repro_torch.core.collectives import make_int8_codec, stream_allgather, stream_reduce_scatter
from repro_torch.netsim import Plan
from repro_torch.transport import get_transport, is_transport_key, resolve_comm_mode
from repro_torch.transport.compressed import CompressedTransport, dequantize_int8, quantize_int8

P = 8
#: name -> (axis names, axis sizes, topology maker)
TOPOS = {"ring": (("x",), (8,), lambda s: Topology.ring(8)),
         "torus": (("x", "y"), (2, 4), lambda s: None),
         "snake_bus": (("x", "y"), (2, 4), snake_bus)}


@pytest.fixture(scope="module")
def R():
    """The reference side (imports JAX)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    import repro.core as rcore
    from repro.core import make_test_mesh, run_spmd
    from repro.netsim import predict_transport_stats
    from repro.transport import available_transports
    from repro.transport import get_transport as ref_get

    available_transports()
    from repro.core.router import snake_bus as ref_snake
    from repro.transport import compressed as rcomp

    makers = {"ring": lambda s: rcore.Topology.ring(8), "torus": lambda s: None,
              "snake_bus": ref_snake}

    def comm(topo):
        names, sizes, _ = TOPOS[topo]
        return rcore.Communicator.create(names, sizes, topology=makers[topo](sizes))

    def run(fn, topo, x):
        names, sizes, _ = TOPOS[topo]
        spec = PS(names[0]) if len(names) == 1 else PS(names)
        return np.asarray(run_spmd(lambda v: fn(v[0])[None], make_test_mesh(sizes, names),
                                   (spec,), spec, x))

    return SimpleNamespace(jax=jax, jnp=jnp, core=rcore, comm=comm, run=run, get=ref_get,
                           comp=rcomp, predict=predict_transport_stats)


def port_comm(topo, device="cpu"):
    names, sizes, make = TOPOS[topo]
    return Communicator.create(names, sizes, topology=make(sizes), device=device)


def _pt(key):
    return get_transport(key, device="cpu")


def _f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _codec_atol(x, hops_quantised=1):
    """The reference's bound: ``hops_quantised`` independent int8 roundings
    of data bounded by max|x| (half a step of max|x| / 127 each)."""
    return hops_quantised * float(np.max(np.abs(x))) / 254.0 * 1.05 + 1e-6


def _bits(a, b, msg=""):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape and a.tobytes() == b.tobytes(), msg


# ---------------------------------------------------------------------------
# codec units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis_elems", [((100, 7), 64), ((1000,), 128), ((4, 3), 256),
                                              ((512,), None), ((3, 5, 2), 7), ((1,), 256)])
def test_codec_matches_reference_bits(R, shape, axis_elems):
    """Codes, scales and the dequantised values equal the reference's
    compiled codec; each element is within half its block's step."""
    v = _f32(*shape, seed=sum(shape), scale=3.0)
    rq, rs = R.jax.jit(lambda a: R.comp.quantize_int8(a, axis_elems))(R.jnp.asarray(v))
    rdq = R.jax.jit(lambda q, s: R.comp.dequantize_int8((q, s), axis_elems))(rq, rs)
    q, s = quantize_int8(torch.from_numpy(v), axis_elems)
    assert q.dtype == torch.int8 and q.shape == v.shape
    _bits(q, rq, "codes")
    _bits(s, rs, "scales")
    back = dequantize_int8((q, s), axis_elems)
    _bits(back, rdq, "dequantised")
    n = v.size
    ae = n if axis_elems is None else min(axis_elems, n)
    per_elem = np.repeat(s.numpy(), ae)[:n].reshape(shape)
    assert np.all(np.abs(back.numpy() - v) <= per_elem / 2 * 1.01 + 1e-8)


def test_codec_axis_elems_localises_scales():
    """Blockwise scales beat one scale a tensor on mixed magnitudes."""
    rng = np.random.RandomState(1)
    v = torch.from_numpy(np.concatenate([rng.randn(256) * 1e3,
                                         rng.randn(256) * 1e-2]).astype(np.float32))

    def err(axis_elems):
        back = dequantize_int8(quantize_int8(v, axis_elems), axis_elems)
        return float((back[256:] - v[256:]).abs().max())

    assert err(256) < err(None) / 100


def test_codec_requantisation_idempotent():
    v = torch.from_numpy(_f32(1000, seed=2))
    q, s = quantize_int8(v, 128)
    q2, _ = quantize_int8(dequantize_int8((q, s), 128), 128)
    assert torch.equal(q, q2)


def test_make_int8_codec_matches_reference(R):
    v = _f32(512, seed=3)
    for axis_elems, n_scales in ((64, 8), (None, 1)):
        q, dq = make_int8_codec(axis_elems=axis_elems)
        rq, rdq = R.core.make_int8_codec(axis_elems=axis_elems)
        wire = q(torch.from_numpy(v))
        assert wire[1].shape == (n_scales,)
        rwire = R.jax.jit(rq)(R.jnp.asarray(v))
        _bits(wire[0], rwire[0]), _bits(wire[1], rwire[1])
        np.testing.assert_allclose(dq(wire).numpy(), v, atol=_codec_atol(v))


def test_codec_rejects_integer_payloads():
    with pytest.raises(TypeError, match="floating"):
        quantize_int8(torch.arange(8, dtype=torch.int32))


# ---------------------------------------------------------------------------
# collectives within the codec's bound, stats equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("backend", ["compressed", "compressed:fused"])
def test_collectives_within_codec_bound(R, topo, backend):
    """bcast / allgather / allreduce over the int8 wire: within the
    reference's bounds of the raw static result (and of the reference's own
    result over the same wire), with the reference's steps and bytes."""
    import repro_torch.channels as pch

    x = _f32(8, 64, seed=4)
    rc = R.comm(topo)
    outs = {}
    for key in ("static", backend):
        rt = R.get(key)
        ref = [R.run(lambda v: R.core.open_bcast_channel(
                   rc, root=0, port=None, transport=rt, n_chunks=4).transfer(v), topo, x),
               R.run(lambda v: R.core.stream_allgather(v, rc, transport=rt), topo, x),
               R.run(lambda v: R.core.open_allreduce_channel(rc, port=None,
                                                             transport=rt).transfer(v), topo, x)]
        comm, pt = port_comm(topo), _pt(key)
        tx = torch.from_numpy(x)
        got = [pch.open_bcast_channel(comm, root=0, port=None, transport=pt,
                                      n_chunks=4).transfer(tx).numpy(),
               stream_allgather(tx, comm, transport=pt).numpy(),
               pch.open_allreduce_channel(comm, port=None, transport=pt).transfer(tx).numpy()]
        assert (pt.stats.steps, pt.stats.bytes_moved) == (rt.stats.steps, rt.stats.bytes_moved)
        outs[key] = (got, ref)
    (raw, raw_ref), (got, ref) = outs["static"], outs[backend]
    for a, b in zip(raw, raw_ref):
        _bits(a, b, "raw wire")
    atol = [_codec_atol(x), _codec_atol(x), _codec_atol(x, 8) + _codec_atol(raw[2])]
    for name, g, w, r, tol in zip(("bcast", "allgather", "allreduce"), got, raw, ref, atol):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)
        np.testing.assert_allclose(g, r, atol=2 * tol, rtol=0, err_msg=f"{name} vs reference")
    _bits(got[0], ref[0], "bcast: each value crosses the wire once")


def test_compressed_over_packet_router(R):
    """The int8 wire rides the packet router with no loss."""
    import repro_torch.channels as pch

    x = _f32(8, 64, seed=5)
    t = _pt("compressed:packet")
    y = pch.open_allreduce_channel(port_comm("ring"), port=None, transport=t).transfer(
        torch.from_numpy(x))
    assert int(t.inner.stats.overflow.sum()) == 0 and t.stats is t.inner.stats
    want = x.sum(axis=0)
    np.testing.assert_allclose(y[0].numpy(), want, atol=_codec_atol(x, 8) + _codec_atol(want))
    static = pch.open_allreduce_channel(port_comm("ring"), port=None,
                                        transport="compressed").transfer(torch.from_numpy(x))
    assert torch.equal(y, static)  # the packet wire moves the int8 rows exactly


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_p2p_matches_reference_and_bound(R, topo):
    from repro_torch.core import stream_p2p

    x = _f32(8, 16, 4, seed=6)
    rc, rt = R.comm(topo), R.get("compressed")
    want = R.run(lambda v: rt.p2p(v, src=0, dst=5, comm=rc, n_chunks=2), topo, x)
    pt = _pt("compressed")
    with pytest.warns(DeprecationWarning):
        y = stream_p2p(torch.from_numpy(x), src=0, dst=5, comm=port_comm(topo), n_chunks=2,
                       transport=pt)
    _bits(y, want, "p2p")
    np.testing.assert_allclose(y[5].numpy(), x[0], atol=_codec_atol(x))
    assert not torch.cat((y[:5], y[6:])).any()
    assert (pt.stats.steps, pt.stats.bytes_moved) == (rt.stats.steps, rt.stats.bytes_moved)


# ---------------------------------------------------------------------------
# reduce-scatter: bounded in P; the residual lives for one call
# ---------------------------------------------------------------------------


def _rs_rel_error(Pn, path, m=256, seed=0):
    """Max relative error of an int8 ring reduce-scatter at ``Pn`` ranks:
    the once-quantised schedule (``"contribution"``) or the generic lossy
    ``shift_accumulate`` re-rounding the accumulator (``"accumulator"``)."""
    comm = Communicator.create("x", (Pn,), topology=Topology.ring(Pn), device="cpu")
    x = np.random.RandomState(seed).randn(Pn, Pn * m).astype(np.float32)
    t = _pt("compressed")
    tx = torch.from_numpy(x)
    if path == "contribution":
        y = stream_reduce_scatter(tx, comm, transport=t)
    else:
        xb = tx.reshape(Pn, Pn, m)
        r = comm.rank()
        y = pc._take(xb, (r - 1) % Pn)
        for s in range(1, Pn):
            y = t.shift_accumulate(y, pc._take(xb, (r - s - 1) % Pn), comm, +1)
    want = x.sum(axis=0).reshape(Pn, m)
    return float(np.abs(y.numpy() - want).max()) / float(np.abs(want).max())


def test_reduce_scatter_error_bounded_in_P():
    """The reference's own regression bounds: the once-quantised schedule's
    error saturates in P (P = 4 -> 8 within 15%, under 4/254), the
    re-rounded accumulator grows by 30% a doubling."""
    new = {Pn: _rs_rel_error(Pn, "contribution") for Pn in (2, 4, 8)}
    old = {Pn: _rs_rel_error(Pn, "accumulator") for Pn in (2, 4, 8)}
    assert new[8] <= new[4] * 1.15 and new[8] <= 4.0 / 254.0, new
    assert old[8] >= old[4] * 1.3 and old[4] >= old[2] * 1.3, old
    assert new[8] < old[8]


def test_error_feedback_residual_lives_for_one_call(R):
    """Two calls on one instance equal two calls on fresh instances (the
    reference's residual lives for one trace); each stays within the
    reference's bound, and near the reference's own result."""
    comm = port_comm("ring")
    rc = R.comm("ring")
    t = _pt("compressed")
    for seed, m in ((8, 8), (9, 8), (10, 4)):  # the same shape twice, then another
        x = _f32(8, 8 * m, seed=seed)
        got = stream_reduce_scatter(torch.from_numpy(x), comm, transport=t)
        fresh = stream_reduce_scatter(torch.from_numpy(x), comm, transport=_pt("compressed"))
        assert torch.equal(got, fresh), seed
        want = x.sum(axis=0).reshape(8, -1)
        np.testing.assert_allclose(got.numpy(), want, atol=_codec_atol(x, 8))
        ref = R.run(lambda v: R.core.stream_reduce_scatter(
            v, rc, transport=R.get("compressed")), "ring", x)
        np.testing.assert_allclose(got.numpy(), ref, atol=2 * _codec_atol(x, 8))


# ---------------------------------------------------------------------------
# wire-byte accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_wire_bytes_exact_p2p(R, topo):
    shape, n_chunks, dst = (8, 16), 4, 5
    t = _pt("compressed")
    t.p2p(torch.from_numpy(_f32(8, *shape, seed=10)), src=0, dst=dst, comm=port_comm(topo),
          n_chunks=n_chunks)
    steps, nbytes = R.predict(R.comm(topo), "p2p", shape=shape, src=0, dst=dst,
                              n_chunks=n_chunks, transport="compressed")
    assert (t.stats.steps, t.stats.bytes_moved) == (steps, nbytes)
    assert nbytes < 128 * 4 * steps


def test_wire_bytes_exact_shift_and_allgather(R):
    from repro.netsim import int8_wire_nbytes

    shape = (4, 8)
    x = torch.from_numpy(_f32(8, *shape, seed=11))
    t = _pt("compressed")
    t.shift(x, port_comm("ring"))
    pred = R.predict(R.comm("ring"), "shift", shape=shape, transport="compressed")
    assert (t.stats.steps, t.stats.bytes_moved) == pred and pred[1] == int8_wire_nbytes(32)
    t2 = _pt("compressed")
    stream_allgather(x, port_comm("ring"), transport=t2)
    assert (t2.stats.steps, t2.stats.bytes_moved) == R.predict(
        R.comm("ring"), "allgather", shape=shape, transport="compressed")


def test_chunked_chain_stats_match_reference(R):
    """The chunked bcast chain over both wires tallies what the reference's
    rolled loop scales to."""
    import repro_torch.channels as pch

    x = _f32(8, 16, seed=12)
    rc = R.comm("ring")
    for key in ("static", "compressed"):
        rt, pt = R.get(key), _pt(key)
        R.run(lambda v: R.core.open_bcast_channel(rc, root=0, port=None, transport=rt,
                                                  n_chunks=4).transfer(v), "ring", x)
        pch.open_bcast_channel(port_comm("ring"), root=0, port=None, transport=pt,
                               n_chunks=4).transfer(torch.from_numpy(x))
        assert (pt.stats.steps, pt.stats.bytes_moved) == (rt.stats.steps, rt.stats.bytes_moved)


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------


def test_registry_wrapper_keys():
    t = _pt("compressed")
    assert isinstance(t, CompressedTransport) and t.inner.name == "static"
    assert t.stats is t.inner.stats
    assert _pt("compressed:packet").inner.name == "packet"
    assert is_transport_key("compressed:fused") and not is_transport_key("compressed:warp-drive")
    with pytest.raises(KeyError):
        _pt("compressed:warp-drive")
    assert resolve_comm_mode("smi:compressed") == ("smi", "compressed")
    assert resolve_comm_mode("smi:compressed:packet") == ("smi", "compressed:packet")
    t.reset_stats()
    assert t.stats is t.inner.stats and t.stats.steps == 0


def test_deprecated_quantize_kwargs_shim(R):
    """The legacy keywords warn and take the compressed transport's
    once-quantised schedule with the caller's codec."""
    x = _f32(8, 64, seed=14)
    q, dq = make_int8_codec(axis_elems=64)
    with pytest.warns(DeprecationWarning, match="transport='compressed'"):
        y = pc.stream_allreduce(torch.from_numpy(x), port_comm("ring"), quantize=q,
                                dequantize=dq)
    want = x.sum(axis=0)
    np.testing.assert_allclose(y[0].numpy(), want, atol=_codec_atol(x, 8))
    rc = R.comm("ring")
    rq, rdq = R.core.make_int8_codec(axis_elems=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = R.run(lambda v: R.core.open_allreduce_channel(rc, port=None).transfer(
            v, quantize=rq, dequantize=rdq), "ring", x)
    np.testing.assert_allclose(y.numpy(), ref, atol=2 * _codec_atol(x, 8))


def test_compressed_integer_allreduce_raises():
    x = torch.ones((8, 16), dtype=torch.int32)
    with pytest.raises(TypeError, match="lossy"):
        pc.allreduce(x, port_comm("ring"), transport="compressed")


def test_int8_plan_moves_integer_payloads_raw():
    """An int8-wire plan applies to floating payloads only: integer data
    moves raw and exactly."""
    x = torch.from_numpy(np.random.RandomState(15).randint(-1000, 1000, (8, 256))
                         .astype(np.int32))
    plan = Plan("static", 4, "ring", wire="int8")
    y = pc.bcast(x, port_comm("ring"), root=0, plan=plan)
    assert torch.equal(y, x[0].expand_as(x))
    f = torch.from_numpy(_f32(8, 256, seed=16))
    yf = pc.bcast(f, port_comm("ring"), root=0, plan=plan)
    assert not torch.equal(yf, f[0].expand_as(f))
    np.testing.assert_allclose(yf.numpy(), np.broadcast_to(f[0].numpy(), f.shape),
                               atol=_codec_atol(f.numpy()))
