"""The port's tensor-parallel prefill path against the reference's, on the
CPU.

The reference runs each rank under ``jax.shard_map`` on the host devices
of tests/conftest.py, over a ``(1, P)`` mesh; the port runs the same inputs
as one rank-stacked tensor.  Weights come from the reference's ``init_lm``
(norm weights and biases perturbed with numpy noise so that they count),
cross with ``params_from_reference`` and are split by ``shard_params``;
inputs come from ``numpy.random.RandomState``.

* the overlap engine's collective matmuls on ring(1x8), static and fused:
  values within 1e-6 of the largest magnitude (float32; the two sum each
  dot product in another order) and the transport's steps, bytes and
  ``by_tag`` equal;
* every ``parallel/layers.py`` function at tp = 4 over ``smi:static``,
  ``smi:fused`` and ``bulk``: values within 1e-6, captured ledgers equal;
* ``lm_prefill`` of the smoke yi-6b, glm4-9b (qkv biases, 2 KV heads < tp)
  and minitron-4b (GELU) at meshes (1, 4) and (1, 8) (yi's 4 heads pad to 8
  there), over the three comm modes, with and without the shared gather.
  The reference's products are its Pallas kernel D in interpret mode
  (``matmul_fn``), its attention the Pallas flash kernel in interpret
  mode; the port's products are its ``matmul`` (the plain version on the
  CPU).  Gate: float32, 1e-5 of the largest magnitude.  The port's ledger
  of the whole prefill equals a closed form, and its one-layer share the
  reference's capture (which traces the layer period once);
* the tp > 1 prefill equal to the port's tp = 1 prefill of the same
  weights within 1e-5, ``shard_params`` equal to the reference's
  ``NamedSharding`` shards, and the options that still raise.
"""

import functools
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ref import (
    TRANSPORTS,
    assert_stats_equal,
    port_comm,
    port_transport,
    ref_comm,
    ref_transport,
    run_ref,
    to_port,
)
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

import repro.core.overlap as ref_overlap
import repro_torch.core.overlap as port_overlap
from repro import configs as ref_configs
from repro.core import make_test_mesh
from repro.kernels.matmul import matmul as ref_matmul
from repro.mesh.api import make_ctx as ref_make_ctx
from repro.models import model as ref_model
from repro.parallel import layers as ref_layers
from repro.parallel import ledger as ref_ledger
from repro_torch import configs
from repro_torch.interop import params_from_reference, shard_params
from repro_torch.kernels.matmul import matmul
from repro_torch.launch.steps import build_prefill
from repro_torch.mesh.api import make_ctx
from repro_torch.models import gather_hidden, init_lm, lm_caches, lm_decode_step, lm_prefill
from repro_torch.models import lm_specs
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.parallel import layers, ledger
from repro_torch.serving import ContinuousEngine, ServeEngine

RTOL = 1e-5
COLL_TOL = 1e-6
MODES = ("smi:static", "smi:fused", "bulk")
ARCHS = ("yi-6b", "glm4-9b", "minitron-4b")
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _mesh(P):
    return make_test_mesh((1, P), ("data", "model"))


def _randn(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} * {scale}"


def _cfgs(arch, **kw):
    return (ref_configs.smoke(ref_configs.get_arch(arch)).scaled(**kw),
            configs.smoke(configs.get_arch(arch)).scaled(**kw))


def _ctxs(P, mode, **kw):
    """(reference context, port context) of a (1, P) mesh."""
    rctx = ref_make_ctx(_mesh(P), comm_mode=mode, **kw)
    pkw = dict(kw)
    if "matmul_fn" in pkw:
        pkw["matmul_fn"] = matmul
    return rctx, make_ctx((1, P), comm_mode=mode, device="cpu", **pkw)


@contextmanager
def _ref_capture():
    """The reference's ledger capture, with every transport it mirrors kept
    alive to the end of the capture.  ``CommLedger.attach`` remembers the
    instances it has patched by ``id()``; once a layer call's fresh
    transport is collected, a later one can be given the same id, and its
    tallies then go unmirrored (seen in this suite: the capture of glm4-9b's
    prefill at tp = 4 over ``smi:fused`` lacked ``tp.mlp.down``).  Holding
    the instances keeps the ids distinct; the port's ledger holds them
    itself."""
    held = []
    attach = ref_ledger.CommLedger.attach

    def holding_attach(self, t):
        held.append(t)
        return attach(self, t)

    with mock.patch.object(ref_ledger.CommLedger, "attach", holding_attach), \
            ref_ledger.capture() as led:
        yield led


def _run_tp(fn, P, *stacks):
    """``fn(*per_rank_args)`` on every rank of the (1, P) mesh; each stack
    is ``(P, ...)`` with rank r's argument in row r.  Returns ``(P, ...)``."""
    body = jax.shard_map(lambda *v: fn(*[a[0] for a in v])[None], mesh=_mesh(P),
                         in_specs=(PS("model"),) * len(stacks), out_specs=PS("model"),
                         check_vma=False)
    return np.asarray(jax.jit(body)(*stacks))


# -- the overlap engine on ring(1x8) --------------------------------------------------


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("bidir", [False, True])
def test_stream_allgather_matmul_matches_reference(bidir, gathered, transport):
    x, w = _randn((8, 3, 5), 1), _randn((8, 5, 4), 2)
    rcomm, rt = ref_comm("ring"), ref_transport(transport)

    def ref_fn(a, b):
        out = ref_overlap.stream_allgather_matmul(a, b, rcomm, bidir=bidir,
                                                  return_gathered=gathered, transport=rt)
        return jnp.concatenate(out, axis=-1) if gathered else out

    with rt.tagged("tp.attn.qkv"):
        want = run_ref(ref_fn, "ring", x, w)
    pt = port_transport(transport)
    with pt.tagged("tp.attn.qkv"):
        got = port_overlap.stream_allgather_matmul(to_port(x), to_port(w), port_comm("ring"),
                                                   bidir=bidir, return_gathered=gathered,
                                                   transport=pt)
    got = torch.cat(got, dim=-1) if gathered else got
    _close(got, want, COLL_TOL, "stream_allgather_matmul")
    assert_stats_equal(pt, rt, "stream_allgather_matmul")


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_stream_matmul_reducescatter_matches_reference(transport):
    x, w = _randn((8, 8 * 3, 5), 3), _randn((8, 5, 4), 4)
    rcomm, rt = ref_comm("ring"), ref_transport(transport)
    with rt.tagged("tp.mlp.down"):
        want = run_ref(lambda a, b: ref_overlap.stream_matmul_reducescatter(a, b, rcomm,
                                                                            transport=rt),
                       "ring", x, w)
    pt = port_transport(transport)
    with pt.tagged("tp.mlp.down"):
        got = port_overlap.stream_matmul_reducescatter(to_port(x), to_port(w),
                                                       port_comm("ring"), transport=pt)
    _close(got, want, COLL_TOL, "stream_matmul_reducescatter")
    assert_stats_equal(pt, rt, "stream_matmul_reducescatter")


def test_collective_matmuls_take_an_injected_matmul():
    """The injected product is what multiplies each ring step: all P
    ranks' blocks in one call."""
    calls = []

    def mm(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return torch.matmul(a, b)

    comm = port_comm("ring")
    x, w = to_port(_randn((8, 3, 5), 5)), to_port(_randn((8, 5, 4), 6))
    y = port_overlap.stream_allgather_matmul(x, w, comm, matmul=mm)
    assert calls == [((8, 3, 5), (8, 5, 4))] * 8
    _close(y, port_overlap.stream_allgather_matmul(x, w, comm), 0.0, "injected")
    calls.clear()
    port_overlap.stream_matmul_reducescatter(to_port(_randn((8, 24, 5), 7)), w, comm, matmul=mm)
    assert calls == [((8, 3, 5), (8, 5, 4))] * 8


# -- every parallel layer at tp = 4 ----------------------------------------------------

P4 = 4
#: layer function -> (call, the per-rank arguments' shapes; ``None`` marks
#: the replicated token ids)
LAYER_CASES = {
    "column_parallel_linear": (
        lambda L, c, x, w: L.column_parallel_linear(x, w, c, tag="tp.attn.qkv"),
        [(P4, 6, 8), (P4, 8, 5)]),
    "column_parallel_linear_gathered": (
        lambda L, c, x, w: _cat(L.column_parallel_linear(x, w, c, tag="tp.mlp.up",
                                                         return_gathered=True)),
        [(P4, 6, 8), (P4, 8, 5)]),
    "row_parallel_linear": (
        lambda L, c, x, w: L.row_parallel_linear(x, w, c, tag="tp.attn.out"),
        [(P4, P4 * 3, 5), (P4, 5, 8)]),
    "gather_sequence": (lambda L, c, x: L.gather_sequence(x, c, tag="tp.attn.kv"),
                        [(P4, 3, 7)]),
    "gather_sequence_axis1": (lambda L, c, x: L.gather_sequence(x, c, 1, tag="tp.attn.kv"),
                              [(P4, 2, 3, 7)]),
    "reduce_scatter_sequence": (
        lambda L, c, x: L.reduce_scatter_sequence(x, c, tag="tp.embed"), [(P4, P4 * 2, 7)]),
    "all_reduce": (lambda L, c, x: L.all_reduce(x, c, tag="tp.mlp.down"), [(P4, 5, 3)]),
    "psum_tagged": (lambda L, c, x: L.psum_tagged(x, c, "tp.attn.out"), [(P4, 5, 3)]),
    "pmax_tagged": (lambda L, c, x: L.pmax_tagged(x, c, "tp.attn.out"), [(P4, 5, 3)]),
    "parallel_embedding_partial": (
        lambda L, c, t, ids: L.parallel_embedding_partial(t, ids, c), [(P4, 6, 5), None]),
    "parallel_embedding": (
        lambda L, c, t, ids: L.parallel_embedding(t, ids, c), [(P4, 6, 5), None]),
}


def _cat(out):
    y, g = out
    return (jnp.concatenate([y, g], axis=-1) if isinstance(y, jax.Array)
            else torch.cat([y, g], dim=-1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_parallel_layer_matches_reference(case, mode):
    call, shapes = LAYER_CASES[case]
    ids = np.random.RandomState(9).randint(0, P4 * 6, (2, 5)).astype(np.int32)
    stacks = [np.broadcast_to(ids, (P4,) + ids.shape).copy() if s is None else
              _randn(s, 10 + i) for i, s in enumerate(shapes)]
    rctx, pctx = _ctxs(P4, mode)
    with _ref_capture() as rled:
        want = _run_tp(lambda *a: call(ref_layers, rctx, *a), P4, *stacks)
    port_args = [torch.from_numpy(ids) if s is None else to_port(a)
                 for s, a in zip(shapes, stacks)]
    with ledger.capture() as pled:
        got = call(layers, pctx, *port_args)
    _close(got, want, COLL_TOL, case)
    assert pled.by_tag == rled.by_tag and pled.steps == rled.steps


# -- lm_prefill at tp > 1 -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _np_params(arch, P, n_layers=None):
    """The reference's init_lm at tp = P (heads padded to a multiple of P),
    norms and biases perturbed, as numpy."""
    kw = {} if n_layers is None else dict(n_layers=n_layers)
    ref_cfg, _ = _cfgs(arch, **kw)
    rctx, _ = _ctxs(P, "smi:static")
    p = ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, rctx)
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        a = np.asarray(leaf)
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name or name in ("bq", "bk", "bv"):
            a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


def _tokens(seed=7):
    return np.random.RandomState(seed).randint(0, 512, (B, S)).astype(np.int32)


def _ref_prefill(arch, P, mode, shared, n_layers=None):
    """The reference's sharded prefill with the Pallas kernels in interpret
    mode; returns ((B, S, D), its captured ledger)."""
    kw = {} if n_layers is None else dict(n_layers=n_layers)
    ref_cfg, _ = _cfgs(arch, **kw)
    rctx, _ = _ctxs(P, mode, opt_shared_gather=shared,
                    matmul_fn=functools.partial(ref_matmul, interpret=True))
    fn = jax.shard_map(
        lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, rctx, capacity=S, interp=True),
        mesh=_mesh(P), in_specs=(ref_model.lm_specs(ref_cfg, rctx), PS()),
        out_specs=PS(None, "model", None), check_vma=False)
    with _ref_capture() as led:
        out = jax.jit(fn)(_np_params(arch, P, n_layers), _tokens())
    return np.asarray(out), led


def _port_prefill(arch, P, mode, shared, n_layers=None):
    kw = {} if n_layers is None else dict(n_layers=n_layers)
    _, cfg = _cfgs(arch, **kw)
    _, pctx = _ctxs(P, mode, opt_shared_gather=shared, matmul_fn=True)
    params = shard_params(params_from_reference(_np_params(arch, P, n_layers), cfg, "cpu"),
                          cfg, pctx)
    with ledger.capture() as led:
        h = lm_prefill(params, torch.from_numpy(_tokens()), cfg, pctx, capacity=S)
    assert tuple(h.shape) == (P, B, S // P, cfg.d_model)
    return gather_hidden(h), led, cfg


def _closed_form(cfg, P, shared):
    """Per tag, (steps, bytes) of one rank's wire traffic in one prefill:
    each streamed call moves (P - 1) ring steps of one rank's rows (B*S/P)
    of the model width in float32; per layer the Q, K/V, out, MLP-up (two
    calls for SwiGLU without the shared gather) and MLP-down calls, and the
    embedding's reduce-scatter once."""
    step = (P - 1) * (B * S // P) * cfg.d_model * 4
    calls = {"tp.attn.qkv": 1, "tp.attn.out": 1, "tp.mlp.down": 1,
             "tp.mlp.up": 1 if shared or cfg.mlp_type != "swiglu" else 2}
    if not shared:
        calls["tp.attn.kv"] = 1
    want = {tag: {"steps": (P - 1) * n * cfg.n_layers, "bytes": step * n * cfg.n_layers}
            for tag, n in calls.items()}
    want["tp.embed"] = {"steps": P - 1, "bytes": step}
    return want


def _one_layer_share(led, cfg):
    return {tag: e["bytes"] if tag == "tp.embed" else e["bytes"] // cfg.n_layers
            for tag, e in led.by_tag.items()}


@pytest.mark.parametrize("shared", [False, True], ids=["ring_per_call", "shared_gather"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_matches_reference(arch, P, mode, shared):
    want, rled = _ref_prefill(arch, P, mode, shared)
    got, pled, cfg = _port_prefill(arch, P, mode, shared)
    _close(got, want, RTOL, f"{arch} tp={P} {mode}")
    if mode == "bulk":
        assert pled.by_tag == {} and rled.by_tag == {}
        return
    assert pled.by_tag == _closed_form(cfg, P, shared)
    assert _one_layer_share(pled, cfg) == rled.tag_bytes()


@pytest.mark.parametrize("n_layers", [2, 4])
def test_ledger_one_layer_share_matches_reference(n_layers):
    """The reference's capture traces the layer period once under
    ``lax.scan``, so it holds one layer's traffic whatever the depth; the
    port's holds every layer's."""
    _, rled = _ref_prefill("yi-6b", 4, "smi:fused", False, n_layers)
    _, pled, cfg = _port_prefill("yi-6b", 4, "smi:fused", False, n_layers)
    assert cfg.n_layers == n_layers
    assert pled.by_tag == _closed_form(cfg, 4, False)
    assert _one_layer_share(pled, cfg) == rled.tag_bytes()


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_matches_tp1_prefill(arch, P):
    """``build_prefill`` on a (1, P) mesh over ``smi:static`` (products by
    ``torch.matmul``) against the tp = 1 prefill of the same weights: at
    P = 8 the smoke yi's padded heads are masked at tp = 1 as well."""
    _, cfg = _cfgs(arch)
    params = params_from_reference(_np_params(arch, P), cfg, "cpu")
    tokens = torch.from_numpy(_tokens(3))
    shape = configs.ShapeConfig("t", S, B, "prefill")
    want = build_prefill(cfg, shape, device="cpu")(params, tokens)
    step = build_prefill(cfg, shape, mesh=(1, P), comm_mode="smi:static", device="cpu")
    assert step.ctx.tp == P and step.ctx.matmul_fn is None
    _close(step(shard_params(params, cfg, step.ctx), tokens), want, RTOL, f"{arch} tp={P}")


# -- the tuned layer plan (plan="auto", the bare "smi") ------------------------------


@contextmanager
def _one_table(P):
    """Both packages' tuning caches hold, for the (1, P) mesh's model ring,
    the table of one model (the port's default), and are emptied after."""
    from repro.netsim import LinkModel as RefLinkModel
    from repro.netsim import tune as ref_tune
    from repro_torch.netsim import LinkModel
    from repro_torch.netsim import tune

    rcomm, pcomm = ref_make_ctx(_mesh(P), comm_mode="smi").model_comm, make_ctx(
        (1, P), comm_mode="smi", device="cpu").model_comm
    fields = {f: getattr(LinkModel(), f) for f in ("hop_latency", "link_bw", "injection_base",
                                                   "switch_cycles", "quant_latency",
                                                   "unfused_add_latency")}
    tune.clear_cache(), ref_tune.clear_cache()
    try:
        want = ref_tune.tuning_table_for(rcomm.topology, rcomm.route_table,
                                         model=RefLinkModel(**fields))
        got = tune.tuning_table_for(pcomm.topology, pcomm.route_table, model=LinkModel())
        assert got.entries == want.entries
        yield got
    finally:
        tune.clear_cache(), ref_tune.clear_cache()


@pytest.mark.parametrize("P", [4, 8])
def test_bare_smi_prefill_matches_reference(P):
    """``build_prefill`` on a (1, P) mesh with its default bare ``"smi"``
    (the config's ``comm_plan="auto"``: the tuning table picks every layer's
    wire) against the reference's ``shard_map`` prefill with the same plan,
    under one table: within float32 1e-5; both ledgers record the same
    backend for every layer tag, and the port's bytes equal the closed
    form."""
    ref_cfg, cfg = _cfgs("yi-6b")
    assert cfg.comm_plan == ref_cfg.comm_plan == "auto"
    with _one_table(P):
        rctx = ref_make_ctx(_mesh(P), comm_mode="smi", plan=ref_cfg.comm_plan)
        fn = jax.shard_map(
            lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, rctx, capacity=S, interp=True),
            mesh=_mesh(P), in_specs=(ref_model.lm_specs(ref_cfg, rctx), PS()),
            out_specs=PS(None, "model", None), check_vma=False)
        with _ref_capture() as rled:
            want = np.asarray(jax.jit(fn)(_np_params("yi-6b", P), _tokens()))
        step = build_prefill(cfg, configs.ShapeConfig("t", S, B, "prefill"), mesh=(1, P),
                             device="cpu")
        assert step.ctx.plan == "auto" and step.ctx.comm_mode == "smi"
        params = shard_params(params_from_reference(_np_params("yi-6b", P), cfg, "cpu"), cfg,
                              step.ctx)
        with ledger.capture() as pled:
            got = step(params, torch.from_numpy(_tokens()))
    _close(got, want, RTOL, f"bare smi tp={P}")
    assert pled.plans == rled.plans and set(pled.plans) == set(pled.by_tag)
    if all(k in ("static", "fused") for k in pled.plans.values()):
        assert pled.by_tag == _closed_form(cfg, P, False)


def test_auto_plan_layer_records_its_choice():
    """A ``plan="auto"`` layer call resolves its backend from the tuning
    table at one rank's bytes and records it under its tag; a Plan on the
    int8 wire moves an integer payload raw; a pinned transport wins."""
    from repro_torch.netsim import Plan

    ctx = make_ctx((1, 4), comm_mode="smi", plan="auto", device="cpu")
    x = torch.from_numpy(_randn((4, 6, 8), 5))
    with ledger.capture() as led:
        got = layers.gather_sequence(x, ctx)
        ints = layers.gather_sequence(torch.arange(4 * 6 * 8, dtype=torch.int32).reshape(4, 6, 8),
                                      ctx, tag="tp.ints", plan=Plan("static", 1, "ring", "int8"))
        layers.all_reduce(x, ctx, tag="tp.pinned", transport="static")
    tuned = ctx.model_comm.plan("allreduce", 6 * 8 * 4)
    assert led.plans == {"tp.gather": tuned.transport_key, "tp.ints": "static"}
    assert torch.equal(got, layers.all_gather_rows(x))
    assert torch.equal(ints, layers.all_gather_rows(
        torch.arange(4 * 6 * 8, dtype=torch.int32).reshape(4, 6, 8)))
    assert led.tag_counts("tp.pinned")[0] == 2 * 3


# -- shard_params and the specs -------------------------------------------------------


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_match_reference_shards(arch, P):
    """Every leaf's slice for rank r equals the shard the reference's
    ``NamedSharding`` puts on the device of model rank r; a replicated leaf
    stays the one global copy."""
    ref_cfg, cfg = _cfgs(arch)
    rctx, pctx = _ctxs(P, "smi:static")
    np_params = _np_params(arch, P)
    rspecs = ref_model.lm_specs(ref_cfg, rctx)
    placed = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(_mesh(P), sp)),
                          np_params, rspecs, is_leaf=lambda x: isinstance(x, PS))
    ref_leaves = jax.tree_util.tree_leaves_with_path(placed)
    spec_leaves = jax.tree.leaves(rspecs, is_leaf=lambda x: isinstance(x, PS))
    port_specs = tree_leaves_with_path(lm_specs(cfg, pctx))
    sharded = tree_leaves_with_path(shard_params(params_from_reference(np_params, cfg, "cpu"),
                                                 cfg, pctx))
    assert len(sharded) == len(ref_leaves) == len(spec_leaves) == len(port_specs)
    rank_of = {d: r for r, d in enumerate(_mesh(P).devices[0])}
    for (path, leaf), (_, arr), rsp, (_, psp) in zip(sharded, ref_leaves, spec_leaves,
                                                       port_specs):
        assert tuple(psp) == tuple(rsp), path
        split = "model" in tuple(rsp)
        stacked = "periods" in path
        for shard in arr.addressable_shards:
            r = rank_of[shard.device]
            mine = (leaf[:, r] if stacked else leaf[r]) if split else leaf
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data), str(path))
        if not split:
            assert tuple(leaf.shape) == arr.shape, path


def test_shard_params_layout():
    """A period's sharded leaves lie (L, P, ...), rank slices contiguous;
    replicated leaves are not copied; tp = 1 returns the params as they
    are."""
    _, cfg = _cfgs("yi-6b")
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    _, pctx = _ctxs(4, "smi:static")
    sp = shard_params(params, cfg, pctx)
    blk, gblk = sp["stack"]["periods"][0], params["stack"]["periods"][0]
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    assert tuple(blk["attn"]["wq"].shape) == (L, 4, D, cfg.n_heads * hd // 4)
    assert tuple(blk["attn"]["wo"].shape) == (L, 4, cfg.n_heads * hd // 4, D)
    assert tuple(blk["mlp"]["w_down"].shape) == (L, 4, cfg.d_ff // 4, D)
    assert blk["attn"]["wq"][1, 2].is_contiguous()
    assert tuple(sp["embed"].shape) == (4, cfg.padded_vocab // 4, D)
    assert tuple(sp["head"].shape) == (4, D, cfg.padded_vocab // 4)
    assert blk["attn"]["wk"] is gblk["attn"]["wk"] and blk["norm1"] is gblk["norm1"]
    torch.testing.assert_close(blk["attn"]["wq"][1, 2], gblk["attn"]["wq"][1, :, 2 * 16:3 * 16])
    assert shard_params(params, cfg, make_ctx()) is params


def test_tp_attention_needs_whole_heads():
    """The smoke yi's 4 heads do not split over 8 ranks unless the global
    params were drawn with the TP context, which pads them to 8."""
    _, cfg = _cfgs("yi-6b")
    _, pctx = _ctxs(8, "smi:static")
    tokens = torch.from_numpy(_tokens())
    unpadded = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, pctx)
    with pytest.raises(ValueError, match="whole heads"):
        lm_prefill(unpadded, tokens, cfg, pctx, capacity=S)
    padded = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=pctx), cfg,
                          pctx)
    assert tuple(lm_prefill(padded, tokens, cfg, pctx, capacity=S).shape) == \
        (8, B, S // 8, cfg.d_model)


def test_init_lm_pads_heads_like_the_reference():
    ref_cfg, cfg = _cfgs("yi-6b")
    rctx, pctx = _ctxs(8, "smi:static")
    want = jax.eval_shape(lambda: ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, rctx))
    got = init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=pctx)
    assert [tuple(t.shape) for _, t in tree_leaves_with_path(got)] == \
        [tuple(a.shape) for a in jax.tree.leaves(want)]
    assert got["stack"]["periods"][0]["attn"]["wq"].shape[-1] == 8 * cfg.hd


# -- what the slice does not run --------------------------------------------------------


def test_options_outside_the_slice_raise():
    _, cfg = _cfgs("yi-6b")
    _, ssm_cfg = _cfgs("mamba2-2.7b")
    _, pctx = _ctxs(4, "smi:static")
    tp_params = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, pctx)
    # a data axis, ring attention, decode and serving at tp > 1 run (item 9,
    # ported), and so does FSDP over the data axis (item 13, ported)
    assert make_ctx((2, 4), comm_mode="smi:static", device="cpu").dp == 2
    assert make_ctx((1, 4), comm_mode="smi:static", opt_ring_attn=True,
                    device="cpu").opt_ring_attn
    caches = lm_caches(cfg, 2, 8, pctx, device="cpu")
    assert tuple(caches["periods"][0]["k"].shape) == (cfg.n_layers, 4, 2, 2, cfg.n_kv_heads,
                                                      cfg.hd)
    logits, _ = lm_decode_step(tp_params, caches, torch.zeros(2, dtype=torch.long), 0, cfg, pctx)
    assert tuple(logits.shape) == (4, 2, cfg.padded_vocab)
    assert ServeEngine(cfg, tp_params, ctx=pctx).ctx.tp == 4
    with ContinuousEngine(cfg, tp_params, ctx=pctx) as eng:
        assert eng.ctx.tp == 4 and eng.pool is None
    pre = build_prefill(cfg, configs.ShapeConfig("t", S, B, "prefill"), mesh=(2, 4),
                        comm_mode="smi:static", fsdp=True, device="cpu")
    assert pre.plan is not None and pre.ctx.data_comm is not None
    # mamba2's ssm block at tp > 1 runs (item 14, ported): its specs, its
    # split and its prefill
    assert tuple(lm_specs(ssm_cfg, pctx)["stack"]["periods"][0]["ssm"]["w_out"]) == \
        (None, "model", None)
    ssm_params = shard_params(init_lm(ssm_cfg, torch.Generator().manual_seed(0), "cpu"),
                              ssm_cfg, pctx)
    assert tuple(lm_prefill(ssm_params, torch.from_numpy(_tokens()), ssm_cfg, pctx,
                            capacity=S).shape) == (4, B, S // 4, ssm_cfg.d_model)
    # the lossy wire runs the compressed link: within the int8 codec's bound
    # (half a step of max|x| / 127) of the raw gather
    xr = torch.from_numpy(np.random.RandomState(3).randn(4, 2, 8).astype(np.float32))
    raw, lossy = layers.gather_sequence(xr, pctx), layers.gather_sequence(xr, pctx, wire="int8")
    assert (lossy - raw).abs().max() <= xr.abs().max() / 254 * 1.05
    # tp = 1 stays what it was, whatever the comm mode
    for mode in ("smi", "smi:fused", "bulk"):
        ctx = make_ctx(comm_mode=mode, matmul_fn=matmul)
        assert ctx.tp == 1 and ctx.rank() == 0 and ctx.matmul_fn is None
