"""The port's tensor-parallel decode and serving against the reference's, on
the CPU.

The reference runs each rank under ``jax.shard_map`` on the 8 host devices
of tests/conftest.py (its ``launch.steps`` builders); the port runs the same
inputs as one rank-stacked tensor.  Weights come from the reference's
``init_lm`` drawn with the TP context (heads padded to a multiple of P),
norms and biases perturbed with numpy noise so that they count, carried
over with ``params_from_reference`` and split by ``shard_params``; tokens
come from ``numpy.random.RandomState``.

* ``lm_decode_step`` (the wave decode step of ``build_serve``) at meshes
  (1, 4), (1, 8) and (2, 4), over ``bulk`` and ``smi:static``, on the smoke
  yi-6b and glm4-9b (8 heads, as ``tests/test_continuous.py`` has it):
  float32 logits within 1e-5 of the largest magnitude, step after step;
* the windowed KV cap (``_pow2_pad(local_window, tp)``) and the psums'
  retag under a serving pool, each against the reference;
* the TP continuous engine on ``build_continuous_serve``'s ChannelPool
  runtime: tokens equal to the reference's tp = 1 wave oracle on (1, 8) and
  (2, 4) over ``static``, ``fused`` and ``packet``; a migrated slot's
  tokens unchanged; the pool's ports held until shutdown;
* the decode ledger equal to ``predict_decode_step_stats`` per ``serve.*``
  tag with one migration, the predictor equal to the reference's on five
  archs, three meshes and four wires, and the reference's traced ledger;
* the ring-attention prefill at (1, 4) and (1, 8) within float32 1e-5 of
  the reference's ``shard_map`` prefill with ``opt_ring_attn=True``;
* ``launch.serve`` at a (1, 4) mesh and its ``--validate-comm`` at (2, 4).

Oracles are reference paths that pass in this suite's runs: its decode and
prefill hold no Pallas kernel here (``matmul_fn`` is None, ring attention
and decode attention are ``jnp``), and its ledger is captured with its
transports held (``_ref_capture``, see test_torch_tensor_parallel.py).
"""

import dataclasses
import functools
import gc
import json
from contextlib import contextmanager
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_mesh
from repro.mesh.api import ParallelCtx as RefCtx
from repro.mesh.api import make_ctx as ref_make_ctx
from repro.models import init_lm as ref_init_lm
from repro.models import model as ref_model
from repro.netsim import predict_decode_step_stats as ref_predict
from repro.parallel import ledger as ref_ledger
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefWave
from repro_torch import configs
from repro_torch.channels import PORTS, ChannelPool
from repro_torch.interop import params_from_reference, shard_params
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import build_continuous_serve, build_prefill, build_serve
from repro_torch.mesh.api import make_ctx
from repro_torch.models import lm_caches
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.netsim import predict_decode_step_stats
from repro_torch.parallel import ledger, psum_tagged
from repro_torch.serving import ContinuousEngine, Request

RTOL = 1e-5
MESHES = {"1x4": (1, 4), "1x8": (1, 8), "2x4": (2, 4)}
B, CAP = 4, 16


@functools.lru_cache(maxsize=None)
def _mesh(dims):
    return make_mesh(dims, ("data", "model"))


def _cfgs(arch, **kw):
    """(reference, port) smoke configs; glm4-9b with 8 heads, as the
    reference's own TP serving tests have it."""
    if arch == "glm4-9b":
        kw = dict(n_heads=8, d_model=128, d_ff=128, **kw)
    return (ref_configs.smoke(ref_configs.get_arch(arch)).scaled(**kw),
            configs.smoke(configs.get_arch(arch)).scaled(**kw))


@functools.lru_cache(maxsize=None)
def _np_params(arch, tp, kw=()):
    """The reference's init_lm with the heads padded for ``tp``, norms and
    biases perturbed, as numpy."""
    ref_cfg, _ = _cfgs(arch, **dict(kw))
    rctx = ref_make_ctx(_mesh((1, tp)), comm_mode="smi:static") if tp > 1 else RefCtx()
    p = ref_init_lm(jax.random.PRNGKey(0), ref_cfg, rctx)
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        a = np.asarray(leaf)
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name or name in ("bq", "bk", "bv"):
            a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} * {scale}"


@contextmanager
def _ref_capture():
    """The reference's ledger capture with every transport it mirrors held
    to the end (its ``attach`` keys transports by ``id()``)."""
    held = []
    attach = ref_ledger.CommLedger.attach

    def holding_attach(self, t):
        held.append(t)
        return attach(self, t)

    with mock.patch.object(ref_ledger.CommLedger, "attach", holding_attach), \
            ref_ledger.capture() as led:
        yield led


# -- lm_decode_step at tp > 1 ---------------------------------------------------------


def _ref_decode(arch, dims, mode, steps, kw=()):
    """The reference's ``build_serve`` step (``shard_map``, the batch split
    over the data axis where it divides) over ``steps`` decode steps;
    returns each step's (B, V) logits and the final caches' local shapes."""
    ref_cfg, _ = _cfgs(arch, **dict(kw))
    rt = ref_steps.build_serve(ref_cfg, _mesh(dims), ref_configs.ShapeConfig("t", CAP, B, "decode"),
                               comm_mode=mode)
    cspecs = ref_model.lm_cache_specs(ref_cfg, rt["ctx"], shard_batch=rt["B_loc"] != B)
    init = jax.jit(jax.shard_map(
        lambda: ref_model.lm_caches(ref_cfg, rt["B_loc"], capacity=CAP, ctx=rt["ctx"]),
        mesh=_mesh(dims), in_specs=(), out_specs=cspecs, check_vma=False),
        out_shardings=rt["cache_sharding"])
    caches = init()
    params = _np_params(arch, dims[1], kw)
    out = []
    for t, tok in enumerate(steps):
        logits, caches = rt["step"](params, caches, tok, np.int32(t))
        out.append(np.asarray(logits))
    return out


def _tokens(n_steps, seed=5):
    return [np.random.RandomState(seed + t).randint(0, 512, (B,)).astype(np.int32)
            for t in range(n_steps)]


def _port_decode(arch, dims, mode, steps, kw=()):
    _, cfg = _cfgs(arch, **dict(kw))
    rt = build_serve(cfg, configs.ShapeConfig("t", CAP, B, "decode"), mesh=dims, comm_mode=mode,
                     device="cpu")
    params = shard_params(params_from_reference(_np_params(arch, dims[1], kw), cfg, "cpu"), cfg,
                          rt["ctx"])
    caches = lm_caches(cfg, B, CAP, rt["ctx"], "cpu")
    out = []
    for t, tok in enumerate(steps):
        logits, caches = rt["step"](params, caches, torch.from_numpy(tok), t)
        out.append(logits)
    return out, caches, rt["ctx"]


@pytest.mark.parametrize("mode", ["bulk", "smi:static"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["yi-6b", "glm4-9b"])
def test_lm_decode_step_matches_reference(arch, mesh, mode, devices8):
    """Four decode steps of ``build_serve``'s step against the reference's
    ``shard_map`` decode: float32 logits within 1e-5, step by step."""
    dims = MESHES[mesh]
    steps = _tokens(4)
    want = _ref_decode(arch, dims, mode, steps)
    got, caches, ctx = _port_decode(arch, dims, mode, steps)
    assert ctx.tp == dims[1] and ctx.dp == dims[0]
    for t, (g, w) in enumerate(zip(got, want, strict=True)):
        _close(g, w, f"{arch} {mesh} {mode} step {t}")


def test_decode_logits_gathered_on_every_rank():
    """``gather_logits=True`` gathers the vocabulary shards over the
    ``tp.loss.gather`` channel: every rank's copy equals the assembled
    shards, and the ledger holds P - 1 shifts of one shard."""
    from repro_torch.models import assemble_logits, lm_decode_step

    _, cfg = _cfgs("yi-6b")
    ctx = make_ctx((1, 4), comm_mode="smi:static", device="cpu")
    params = shard_params(params_from_reference(_np_params("yi-6b", 4), cfg, "cpu"), cfg, ctx)
    tok = torch.from_numpy(_tokens(1)[0])
    shards, _ = lm_decode_step(params, lm_caches(cfg, B, CAP, ctx, "cpu"), tok, 0, cfg, ctx,
                               gather_logits=False)
    with ledger.capture() as led:
        full, _ = lm_decode_step(params, lm_caches(cfg, B, CAP, ctx, "cpu"), tok, 0, cfg, ctx)
    assert tuple(full.shape) == (4, B, cfg.padded_vocab)
    for r in range(4):
        torch.testing.assert_close(full[r], assemble_logits(shards), rtol=0, atol=0)
    assert led.tag_counts("tp.loss.gather") == (3, 3 * B * cfg.padded_vocab // 4 * 4)


@pytest.mark.parametrize("mode", ["smi:static", "smi:fused", "bulk"])
def test_decode_row_does_not_depend_on_its_slot(mode):
    """In bfloat16 at tp = 4, a row's logits are the same bits whichever
    slot it sits in (the batch permuted, six steps): the MLP all-reduce sums
    every row's elements in one rank order.  The reference's ring, fed the
    flattened (B, D), sums them in an order that follows the slot, so a
    request's tokens could change with where it was admitted."""
    from repro_torch.models import init_lm, lm_decode_step

    _, cfg = _cfgs("yi-6b", dtype="bfloat16", d_model=256, d_ff=512)
    ctx = make_ctx((1, 4), comm_mode=mode, device="cpu")
    params = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=ctx,
                                  dtype=torch.bfloat16), cfg, ctx)
    perm = torch.tensor([3, 0, 2, 1])
    ca, cb = lm_caches(cfg, B, CAP, ctx, "cpu"), lm_caches(cfg, B, CAP, ctx, "cpu")
    for t, tok in enumerate(_tokens(6, seed=11)):
        tok = torch.from_numpy(tok)
        la, _ = lm_decode_step(params, ca, tok, t, cfg, ctx, gather_logits=False)
        lb, _ = lm_decode_step(params, cb, tok[perm], t, cfg, ctx, gather_logits=False)
        assert torch.equal(la[:, perm], lb), f"{mode} step {t}"


# -- the two repairs -----------------------------------------------------------------


def test_windowed_kv_cap_matches_reference(devices8):
    """A windowed attention layer keeps ``_pow2_pad(local_window, tp)`` of
    the slots (the reference's cap): a window of 6 at tp = 4 keeps 8, two a
    rank, where the port once kept 6.  Cache shapes equal the reference's
    per-device shapes, and ten decode steps (past the window) its logits."""
    kw = (("local_window", 6),)
    ref_cfg, cfg = _cfgs("yi-6b", **dict(kw))
    rctx = ref_make_ctx(_mesh((1, 4)), comm_mode="smi:static")
    want = jax.eval_shape(jax.shard_map(
        lambda: ref_model.lm_caches(ref_cfg, B, capacity=CAP, ctx=rctx), mesh=_mesh((1, 4)),
        in_specs=(), out_specs=ref_model.lm_cache_specs(ref_cfg, rctx, shard_batch=False),
        check_vma=False))
    ctx = make_ctx((1, 4), comm_mode="smi:static", device="cpu")
    got = lm_caches(cfg, B, CAP, ctx, "cpu")
    want_local = [tuple(int(d) // (4 if i == 2 else 1) for i, d in enumerate(a.shape))
                  for a in jax.tree.leaves(want)]
    assert [tuple(t.shape[:1] + t.shape[2:]) for _, t in tree_leaves_with_path(got)] == \
        want_local
    assert got["periods"][0]["k"].shape[3] == 2
    steps = _tokens(10, seed=9)
    for t, (g, w) in enumerate(zip(_port_decode("yi-6b", (1, 4), "smi:static", steps, kw)[0],
                                   _ref_decode("yi-6b", (1, 4), "smi:static", steps, kw),
                                   strict=True)):
        _close(g, w, f"window 6 tp=4 step {t}")


def test_tagged_psums_retag_under_a_pool(devices8):
    """Under a serving pool the tagged psum and pmax tally under the pool's
    bucket (``serve.tp.embed``), as the reference's do."""
    from repro.channels import ChannelPool as RefPool
    from repro.parallel import pmax_tagged as ref_pmax
    from repro.parallel import psum_tagged as ref_psum
    from repro_torch.parallel import pmax_tagged

    rctx = ref_make_ctx(_mesh((1, 4)), comm_mode="smi:static")
    rctx = dataclasses.replace(rctx, channels=RefPool(rctx.model_comm))
    x = np.random.RandomState(2).randn(4, 3, 5).astype(np.float32)
    with _ref_capture() as rled:
        jax.jit(jax.shard_map(
            lambda v: ref_pmax(ref_psum(v, rctx, "tp.embed"), rctx, "tp.attn.out"),
            mesh=_mesh((1, 4)), in_specs=PS("model"), out_specs=PS("model"),
            check_vma=False))(x)
    ctx = make_ctx((1, 4), comm_mode="smi:static", device="cpu")
    ctx = dataclasses.replace(ctx, channels=ChannelPool(ctx.model_comm))
    with ledger.capture() as led:
        pmax_tagged(psum_tagged(torch.from_numpy(x), ctx, "tp.embed"), ctx, "tp.attn.out")
    assert led.by_tag == rled.by_tag == {"serve.tp.embed": {"steps": 1, "bytes": 60},
                                         "serve.tp.attn.out": {"steps": 1, "bytes": 60}}


# -- the continuous engine on a ChannelPool --------------------------------------------

PROMPTS = [[5, 7, 9], [11, 3], [4, 8]]


def _reqs(cls, max_new=3):
    return [cls(uid=i, prompt=list(p), max_new=max_new) for i, p in enumerate(PROMPTS)]


@functools.lru_cache(maxsize=None)
def _wave_oracle():
    """The reference's tp = 1 wave engine on the 8-head glm4-9b."""
    ref_cfg, _ = _cfgs("glm4-9b")
    wave = RefWave(ref_cfg, _np_params("glm4-9b", 1), batch_slots=2, capacity=32)
    for r in _reqs(RefRequest):
        wave.submit(r)
    return {r.uid: list(r.out) for r in wave.run(max_steps=200)}


def _tp_engine(dims, mode, slots=2):
    _, cfg = _cfgs("glm4-9b")
    rt = build_continuous_serve(cfg, mesh=dims, comm_mode=mode, batch_slots=slots, capacity=32,
                                device="cpu")
    params = shard_params(params_from_reference(_np_params("glm4-9b", 1), cfg, "cpu"), cfg,
                          rt["ctx"])
    return ContinuousEngine(cfg, params, runtime=rt)


@pytest.mark.parametrize("backend", ["static", "fused", "packet"])
@pytest.mark.parametrize("mesh", ["1x8", "2x4"])
def test_tp_continuous_matches_reference_wave_oracle(mesh, backend, devices8):
    """The TP continuous engine on the pool's persistent channels emits the
    reference's tp = 1 wave tokens; every layer channel is one pool spec."""
    with _tp_engine(MESHES[mesh], f"smi:{backend}") as eng:
        for r in _reqs(Request):
            eng.submit(r)
        got = {r.uid: r.out for r in eng.run(max_steps=200)}
        tags = set(eng.pool.ports())
    assert got == _wave_oracle()
    assert {"serve.tp.attn.qkv", "serve.tp.mlp.down", "serve.migrate#gather"} <= tags


def test_tp_migration_leaves_tokens_unchanged(devices8):
    """A slot migrated over the pool's gather/scatter pair, with two decode
    ticks of the other slots while its image is in flight, decodes the same
    tokens as without the migration; the legs tally under
    ``serve.migrate``."""
    def run(migrate):
        with _tp_engine((1, 8), "smi:static", slots=3) as eng, ledger.capture() as led:
            eng.submit(Request(uid=0, prompt=[5, 7, 9], max_new=6))
            eng.submit(Request(uid=1, prompt=[11, 3], max_new=6))
            done = []
            for _ in range(4):
                done += eng.tick()
            if migrate:
                eng.migrate(0, 2, overlap_ticks=2)
            done += eng.run(max_steps=100)
            return {r.uid: r.out for r in done}, led

    want, _ = run(False)
    got, led = run(True)
    assert got == want
    assert led.tag_counts("serve.migrate")[0] == 2 * 7


def test_persistent_pool_lifecycle(devices8):
    """The pool's port claims are strong: they survive the steps that used
    them and a collection, and come back only at the engine's shutdown."""
    eng = _tp_engine((1, 8), "smi:static")
    pool, comm = eng.pool, eng.ctx.model_comm
    assert pool is not None and not pool.closed
    eng.submit(Request(uid=0, prompt=[5, 7], max_new=2))
    eng.tick()
    ports = pool.ports()
    assert len(ports) > 2 and all(tag.startswith("serve.") for tag in ports)
    assert set(ports.values()) <= set(PORTS.in_use(comm))
    gc.collect()
    assert set(ports.values()) <= set(PORTS.in_use(comm))
    eng.run(max_steps=20)
    assert pool.ports() == ports and not pool.closed
    eng.shutdown()
    assert pool.closed and not set(ports.values()) & set(PORTS.in_use(comm))
    eng.shutdown()  # idempotent


# -- the decode ledger and its predictor ----------------------------------------------


class _St(SimpleNamespace):
    comm_mode = "smi:static"


def test_decode_ledger_equals_prediction(devices8):
    """One continuous decode step plus one migration at (2, 4): the port's
    ledger equals ``predict_decode_step_stats(..., eager=True)`` per tag, to
    the byte and the step; the traced table (``eager=False``) equals the
    reference's captured ledger, and its every-layer share equals the
    port's."""
    ref_cfg, cfg = _cfgs("yi-6b")
    st = _St()
    rt = build_continuous_serve(cfg, mesh=(2, 4), comm_mode=st.comm_mode, batch_slots=2,
                                capacity=32, device="cpu")
    params = shard_params(params_from_reference(_np_params("yi-6b", 4), cfg, "cpu"), cfg,
                          rt["ctx"])
    caches = rt["init_caches"]()
    with ledger.capture() as led:
        rt["step"](params, caches, torch.zeros(2, dtype=torch.int32),
                   torch.zeros(2, dtype=torch.int32))
        rt["migrate_finish"](caches, rt["migrate_start"](caches, 0), 1)
    rt["pool"].close()
    assert led.by_tag == predict_decode_step_stats(cfg, (2, 4), 2, st, capacity=32,
                                                   migrations=1, eager=True)

    rrt = ref_steps.build_continuous_serve(ref_cfg, _mesh((2, 4)), comm_mode=st.comm_mode,
                                           batch_slots=2, capacity=32)
    pshapes = jax.eval_shape(lambda: ref_init_lm(jax.random.PRNGKey(0), ref_cfg, rrt["ctx"]))
    cshapes = jax.eval_shape(rrt["init_caches"])
    tok = jax.ShapeDtypeStruct((2,), np.int32)
    slot = jax.ShapeDtypeStruct((), np.int32)
    with _ref_capture() as rled:
        rrt["step"].lower(pshapes, cshapes, tok, tok)
        infl = jax.eval_shape(rrt["migrate_start"], cshapes, slot)
        rrt["migrate_start"].lower(cshapes, slot)
        rrt["migrate_finish"].lower(cshapes, infl, slot)
    rrt["pool"].close()
    assert rled.by_tag == predict_decode_step_stats(cfg, (2, 4), 2, st, capacity=32,
                                                    migrations=1)


PREDICT_ARCHS = ("yi-6b", "glm4-9b", "mamba2-2.7b", "qwen3-moe-30b-a3b", "recurrentgemma-9b")


@pytest.mark.parametrize("mode", ["smi:static", "smi:fused", "smi:packet",
                                  "smi:compressed:static"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", PREDICT_ARCHS)
def test_predictor_matches_reference(arch, mesh, mode):
    """The port's table equals the reference's for the full and the smoke
    config, with one migration and without, per tag."""
    st = SimpleNamespace(comm_mode=mode)
    for ref_cfg, cfg in ((ref_configs.get_arch(arch), configs.get_arch(arch)),
                         (ref_configs.smoke(ref_configs.get_arch(arch)),
                          configs.smoke(configs.get_arch(arch)))):
        for migrations in (0, 1):
            assert predict_decode_step_stats(cfg, MESHES[mesh], 4, st, capacity=64,
                                             migrations=migrations) == \
                ref_predict(ref_cfg, MESHES[mesh], 4, st, capacity=64, migrations=migrations)


# -- ring-attention prefill ----------------------------------------------------------

S_RING = 32


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("arch", ["yi-6b", "glm4-9b"])
def test_ring_attention_prefill_matches_reference(arch, P, devices8):
    """``build_prefill(mesh=(1, P), ring_attn=True)`` against the
    reference's ``shard_map`` prefill with ``opt_ring_attn=True``: float32
    hidden states within 1e-5, and the port's ledger the reference's
    one-layer capture times the depth (its embedding once)."""
    ref_cfg, cfg = _cfgs(arch)
    rctx = ref_make_ctx(_mesh((1, P)), comm_mode="smi:static", opt_ring_attn=True)
    tokens = np.random.RandomState(7).randint(0, 512, (2, S_RING)).astype(np.int32)
    fn = jax.shard_map(
        lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, rctx, capacity=S_RING),
        mesh=_mesh((1, P)), in_specs=(ref_model.lm_specs(ref_cfg, rctx), PS()),
        out_specs=PS(None, "model", None), check_vma=False)
    with _ref_capture() as rled:
        want = np.asarray(jax.jit(fn)(_np_params(arch, P), tokens))
    step = build_prefill(cfg, configs.ShapeConfig("t", S_RING, 2, "prefill"), mesh=(1, P),
                         comm_mode="smi:static", ring_attn=True, device="cpu")
    assert step.ctx.opt_ring_attn
    params = shard_params(params_from_reference(_np_params(arch, P), cfg, "cpu"), cfg, step.ctx)
    with ledger.capture() as led:
        got = step(params, torch.from_numpy(tokens))
    _close(got, want, f"ring attention {arch} tp={P}")
    assert "tp.attn.ring" in led.by_tag and "tp.attn.kv" not in led.by_tag
    assert {t: e["bytes"] if t == "tp.embed" else e["bytes"] // cfg.n_layers
            for t, e in led.by_tag.items()} == rled.tag_bytes()


S_LONG = 2048


@pytest.mark.parametrize("window", [None, 700], ids=["causal", "local_window"])
def test_ring_attention_multi_chunk_matches_reference(window, devices8):
    """At P = 2 and 2048 tokens each rank's K/V block holds 1024 keys, two
    512-key chunks of the online-softmax loop; with ``local_window=700``
    the window's edge falls inside a chunk of a block that arrives over the
    ring.  Hidden states within float32 1e-5 of the reference's
    ``shard_map`` prefill with ``opt_ring_attn=True``."""
    kw = (("local_window", window),) if window else ()
    ref_cfg, cfg = _cfgs("yi-6b", **dict(kw))
    rctx = ref_make_ctx(_mesh((1, 2)), comm_mode="smi:static", opt_ring_attn=True)
    tokens = np.random.RandomState(8).randint(0, 512, (1, S_LONG)).astype(np.int32)
    fn = jax.shard_map(
        lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, rctx, capacity=S_LONG),
        mesh=_mesh((1, 2)), in_specs=(ref_model.lm_specs(ref_cfg, rctx), PS()),
        out_specs=PS(None, "model", None), check_vma=False)
    want = np.asarray(jax.jit(fn)(_np_params("yi-6b", 2, kw), tokens))
    step = build_prefill(cfg, configs.ShapeConfig("t", S_LONG, 1, "prefill"), mesh=(1, 2),
                         comm_mode="smi:static", ring_attn=True, device="cpu")
    params = shard_params(params_from_reference(_np_params("yi-6b", 2, kw), cfg, "cpu"), cfg,
                          step.ctx)
    _close(step(params, torch.from_numpy(tokens)), want, f"ring attention window={window}")


def test_ring_attention_ragged_shard_raises():
    """A shard of 600 keys a rank (over 512, not a multiple of it) raises,
    as the reference's reshape does, instead of leaving keys out."""
    from repro_torch.core.overlap import stream_ring_attention

    ctx = make_ctx((1, 2), comm_mode="smi:static", device="cpu")
    q = torch.zeros(2, 1, 600, 2, 4)
    with pytest.raises(ValueError, match="multiple"):
        stream_ring_attention(q, q[..., :1, :], q[..., :1, :], ctx.model_comm)


# -- the launcher ----------------------------------------------------------------------


def test_serve_cli_tensor_parallel_on_cpu(tmp_path):
    """``launch.serve --smoke --device cpu --mesh 1,4`` runs both engines to
    the same tokens; ``--validate-comm --mesh 2,4 --comm-mode smi:static``
    exits 0 with every tag equal."""
    outs = []
    for engine in ("wave", "continuous"):
        out = tmp_path / f"{engine}.json"
        assert launch_serve.main(["--smoke", "--device", "cpu", "--mesh", "1,4", "--comm-mode",
                                  "smi:static", "--engine", engine, "--json", str(out)]) == 0
        outs.append(json.loads(out.read_text())["out"])
    assert outs[0] == outs[1] and len(outs[0]) == 4
    assert launch_serve.main(["--smoke", "--device", "cpu", "--mesh", "1,4"]) == 0
    out = tmp_path / "validate.json"
    assert launch_serve.main(["--smoke", "--device", "cpu", "--mesh", "2,4", "--comm-mode",
                              "smi:static", "--validate-comm", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["predicted"] == res["measured"] and "serve.migrate" in res["measured"]


def test_serve_cli_compressed_wire_on_cpu(tmp_path):
    """``--comm-mode smi:compressed`` (one of the reference's choices, the
    int8 wire over static schedules) serves every request at a (1, 4) mesh,
    and its ``--validate-comm`` at (2, 4) exits 0 with every tag equal."""
    out = tmp_path / "serve.json"
    assert launch_serve.main(["--smoke", "--device", "cpu", "--mesh", "1,4", "--comm-mode",
                              "smi:compressed", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["completed"] == res["requests"] == 4
    out = tmp_path / "validate.json"
    assert launch_serve.main(["--smoke", "--device", "cpu", "--mesh", "2,4", "--comm-mode",
                              "smi:compressed", "--validate-comm", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["predicted"] == res["measured"] and "serve.tp.mlp.down" in res["measured"]
