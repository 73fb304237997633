"""The port's RG-LRU hybrid (recurrentgemma-9b: ``("rec", "rec", "attn")``
blocks with a 16-token local window at smoke size) against the reference's,
on the CPU, at tensor-parallel degrees 1, 4 and 8.

The reference runs each rank under ``jax.shard_map`` on the 8 host devices
of tests/conftest.py, its Pallas kernels (the GEMM, flash attention) in
interpret mode; the port runs the same inputs as one rank-stacked tensor.
Weights come from the reference's ``init_lm`` (the gate vectors, the decay
and the norms perturbed with numpy noise so that they count), cross with
``params_from_reference`` and are split by ``shard_params``.  The smoke
config is cut to 5 layers (one period of 3 and two remainder ``rec``
layers, ``params["rem"]``) and given 8 query heads (one KV head), so that
heads split whole at P = 8.  Tolerance, float32: the largest difference at
most 1e-5 of the largest reference magnitude.

* the scan (``linear_scan``) against ``jax.lax.associative_scan`` and a
  sequential loop, the gates against the reference's, on values whose
  ``log a`` reaches -10 a step;
* ``apply_rglru`` and ``decode_rglru`` at tp = 1, 4 and 8, with and without
  ``opt_shared_gather``;
* ``lm_prefill`` at (1, 4) and (1, 8) over ``smi:static``, ``smi:fused``
  and ``bulk`` against the reference's ``shard_map`` prefill, and the
  ledger against its closed form and the reference's capture;
* 40 decode steps past the window (the KV ring wraps twice) at tp = 1, 4
  and 8 against the reference's tp = 1 decode, and ``build_serve``'s step
  at (1, 4), (1, 8) and (2, 4) against the reference's ``shard_map``
  decode;
* a row's bfloat16 logits the same bits whichever slot it sits in (the
  ``ssm.out`` all-reduce rings ``(D, B)``);
* the decode ledger equal to ``predict_decode_step_stats`` with a
  migration, and a slot image of the reference's bytes; both engines'
  tokens equal to the reference's tp = 1 wave oracle; the specs and
  ``shard_params`` equal to the reference's shards (the remainder layers
  among them); ``launch.serve --arch recurrentgemma-9b`` on the CPU.
"""

import dataclasses
import functools
import json
from contextlib import contextmanager
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

from repro import configs as ref_configs
from repro.kernels.matmul import matmul as ref_matmul
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_mesh
from repro.mesh.api import ParallelCtx as RefCtx
from repro.mesh.api import make_ctx as ref_make_ctx
from repro.models import model as ref_model
from repro.models import rglru as ref_rglru
from repro.parallel import ledger as ref_ledger
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefWave
from repro.serving.continuous import slot_nbytes as ref_slot_nbytes
from repro_torch import configs
from repro_torch.interop import params_from_reference, shard_params, shard_tree
from repro_torch.kernels.matmul import matmul
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import build_continuous_serve, build_prefill, build_serve
from repro_torch.mesh.api import ParallelCtx, make_ctx
from repro_torch.models import gather_hidden, init_lm, lm_cache_specs, lm_caches
from repro_torch.models import lm_decode_step, lm_prefill, lm_specs
from repro_torch.models import rglru
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.netsim import predict_decode_step_stats
from repro_torch.parallel import ledger
from repro_torch.serving import ContinuousEngine, Request, ServeEngine
from repro_torch.serving.continuous import cache_batch_dim, pack_slot

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "recurrentgemma-9b"
RTOL = 1e-5
#: one period of (rec, rec, attn) and two remainder rec layers; 8 query heads
KW = (("n_layers", 5), ("n_heads", 8))
MODES = ("smi:static", "smi:fused", "bulk")
MESHES = {"1x4": (1, 4), "1x8": (1, 8), "2x4": (2, 4)}
B, S, CAP = 2, 32, 16
#: the leaves perturbed so that a wrong rank or channel order shows
NOISY = ("lam", "wa", "ba", "wi", "bi")


@functools.lru_cache(maxsize=None)
def _mesh(dims):
    return make_mesh(dims, ("data", "model"))


def _cfgs(**kw):
    kw = {**dict(KW), **kw}
    return (ref_configs.smoke(ref_configs.get_arch(ARCH)).scaled(**kw),
            configs.smoke(configs.get_arch(ARCH)).scaled(**kw))


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} * {scale}"


def _noise(path, a, rng):
    name = str(getattr(path[-1], "key", ""))
    if "norm" in name or name in NOISY:
        return a + 0.5 * rng.randn(*a.shape).astype(a.dtype)
    return a


@functools.lru_cache(maxsize=None)
def _np_params():
    """The reference's init_lm, the gate vectors, the decay and the norms
    perturbed (at init they are 0 and 1: a wrong channel order would not
    show), as numpy."""
    ref_cfg, _ = _cfgs()
    p = ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, RefCtx())
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map_with_path(lambda path, a: _noise(path, np.asarray(a), rng), p)


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


def _tokens(seed=7, n=S):
    return np.random.RandomState(seed).randint(0, 512, (B, n)).astype(np.int32)


# -- the scan and the gates ---------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 100])
def test_linear_scan_matches_associative_scan(n):
    """``linear_scan`` is ``jax.lax.associative_scan`` with the reference's
    combine, along the sequence axis of a (2, n, 5) stack: within 1e-6 of
    it and of a sequential loop, at every length's odd/even split."""
    rng = np.random.RandomState(n)
    a = rng.uniform(0.0, 1.0, (2, n, 5)).astype(np.float32)
    b = rng.randn(2, n, 5).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    h, seq = np.zeros((2, 5), np.float64), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), rtol=1e-5, atol=1e-5)


def test_gates_match_reference():
    """The gates in float32 from a conv output whose gate pre-activations
    reach +-30: ``log a = -8 softplus(lam) r`` down to about -10 a step,
    ``1 - a^2`` clamped at 1e-12 where ``a`` rounds to 1."""
    _, cfg = _cfgs()
    rng = np.random.RandomState(3)
    W = 16
    p = {k: (rng.randn(W) * 3).astype(np.float32) for k in NOISY}
    p["lam"][:4] = [-40.0, 0.0, 0.3, 2.0]
    u = (rng.randn(2, 9, W) * 10).astype(np.float32)
    ra, rb = ref_rglru._gates({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(u))
    pa, pb = rglru._gates({k: torch.from_numpy(v)[None] for k, v in p.items()},
                          torch.from_numpy(u)[None])
    assert float(np.log(np.asarray(ra)).min()) < -9.0
    _close(pa[0], ra, "a")
    _close(pb[0], rb, "b")


# -- the block at tp = 1, 4, 8 ------------------------------------------------------


def _block_params(seed=3):
    """One RG-LRU block's params from the reference's init, the vectors
    perturbed, as numpy."""
    ref_cfg, _ = _cfgs()
    p = jax.tree.map(np.asarray, ref_rglru.init_rglru(jax.random.PRNGKey(seed), ref_cfg, RefCtx()))
    rng = np.random.RandomState(seed)
    return {k: (v + 0.5 * rng.randn(*v.shape).astype(np.float32) if k in NOISY else v)
            for k, v in p.items()}


def _port_block(np_p, cfg, ctx):
    glob = {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}
    return glob if ctx.tp == 1 else shard_tree(glob, rglru.rglru_specs(cfg, ctx), ctx)


def test_init_rglru_layout_matches_reference():
    _, cfg = _cfgs()
    p = _block_params()
    got = rglru.init_rglru(torch.Generator().manual_seed(0), cfg, ParallelCtx())
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in p.items()}
    assert (got["lam"] == 1).all() and not got["wa"].any() and not got["bi"].any()


@pytest.mark.parametrize("shared", [False, True], ids=["ring_per_call", "shared_gather"])
@pytest.mark.parametrize("P", [1, 4, 8])
def test_apply_rglru_matches_reference(P, shared, devices8):
    """``apply_rglru`` over sequence shards against the reference's under
    ``shard_map`` (at tp = 1 called directly): the gathered rows reordered
    from (P, B, S_loc) into (B, S) and back for the out-projection."""
    ref_cfg, cfg = _cfgs()
    np_p = _block_params()
    x = np.random.RandomState(4).randn(B, S, cfg.d_model).astype(np.float32)
    if P == 1:
        rctx = dataclasses.replace(RefCtx(), opt_shared_gather=shared)
        want = ref_rglru.apply_rglru(np_p, jnp.asarray(x), ref_cfg, rctx)
        ctx = make_ctx(opt_shared_gather=shared)
        got = rglru.apply_rglru(_port_block(np_p, cfg, ctx), torch.from_numpy(x), cfg, ctx)
        _close(got, want, "tp=1")
        return
    rctx = ref_make_ctx(_mesh((1, P)), comm_mode="smi:static", opt_shared_gather=shared)
    fn = jax.jit(jax.shard_map(lambda p, xs: ref_rglru.apply_rglru(p, xs, ref_cfg, rctx),
                               mesh=_mesh((1, P)),
                               in_specs=(ref_rglru.rglru_specs(ref_cfg, rctx),
                                         PS(None, "model", None)),
                               out_specs=PS(None, "model", None), check_vma=False))
    want = fn(np_p, x)
    ctx = make_ctx((1, P), comm_mode="smi:static", opt_shared_gather=shared, device="cpu")
    xs = torch.from_numpy(x).unflatten(1, (P, S // P)).transpose(0, 1)
    got = rglru.apply_rglru(_port_block(np_p, cfg, ctx), xs, cfg, ctx)
    _close(gather_hidden(got), want, f"tp={P}")


@pytest.mark.parametrize("P", [1, 4, 8])
def test_decode_rglru_matches_reference(P, devices8):
    """Twelve steps of ``decode_rglru`` (the conv window fills and shifts):
    outputs and both cache leaves (the conv window, the float32 state)
    within 1e-5 of the reference's at every step, each rank its own
    slice."""
    ref_cfg, cfg = _cfgs()
    np_p = _block_params(seed=5)
    if P == 1:
        rctx, ctx = RefCtx(), ParallelCtx()

        def step(p, x, c):
            return ref_rglru.decode_rglru(p, x, c, ref_cfg, rctx)

        rcache = ref_rglru.init_rglru_cache(ref_cfg, B, rctx, jnp.float32)
    else:
        rctx = ref_make_ctx(_mesh((1, P)), comm_mode="smi:static")
        ctx = make_ctx((1, P), comm_mode="smi:static", device="cpu")
        cspec = ref_rglru.rglru_cache_specs(rctx, shard_batch=False)
        step = jax.jit(jax.shard_map(
            lambda p, x, c: ref_rglru.decode_rglru(p, x, c, ref_cfg, rctx), mesh=_mesh((1, P)),
            in_specs=(ref_rglru.rglru_specs(ref_cfg, rctx), PS(), cspec), out_specs=(PS(), cspec),
            check_vma=False))
        rcache = jax.jit(jax.shard_map(
            lambda: ref_rglru.init_rglru_cache(ref_cfg, B, rctx, jnp.float32), mesh=_mesh((1, P)),
            in_specs=(), out_specs=cspec, check_vma=False))()
    port_p = _port_block(np_p, cfg, ctx)
    cache = rglru.init_rglru_cache(cfg, B, ctx, torch.float32, "cpu")
    rng = np.random.RandomState(6)
    for t in range(12):
        x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        want, rcache = step(np_p, x, rcache)
        xp = torch.from_numpy(x)
        got, cache = rglru.decode_rglru(port_p, xp if P == 1 else xp.expand(P, B, 1, -1), cache,
                                        cfg, ctx)
        for r in range(P):
            _close(got if P == 1 else got[r], want, f"tp={P} step {t} rank {r}")
    for name in ("conv", "h"):
        want = np.asarray(rcache[name])
        if P == 1:
            _close(cache[name], want, name)
            continue
        for r in range(P):
            _close(cache[name][r], np.split(want, P, axis=-1)[r], f"cache {name} rank {r}")


# -- lm_prefill at tp > 1 ---------------------------------------------------------------


def _ref_prefill(P, mode, shared):
    ref_cfg, _ = _cfgs()
    rctx = ref_make_ctx(_mesh((1, P)), comm_mode=mode, opt_shared_gather=shared,
                        matmul_fn=functools.partial(ref_matmul, interpret=True))
    fn = jax.shard_map(
        lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, rctx, capacity=S, interp=True),
        mesh=_mesh((1, P)), in_specs=(ref_model.lm_specs(ref_cfg, rctx), PS()),
        out_specs=PS(None, "model", None), check_vma=False)
    with _ref_capture() as led:
        out = jax.jit(fn)(_np_params(), _tokens())
    return np.asarray(out), led


def _closed_form(cfg, P, shared):
    """Per tag, (steps, bytes) of one rank's wire traffic in one prefill:
    every streamed call moves P - 1 ring steps of one rank's rows (B*S/P)
    of the model width in float32.  A rec layer: ``ssm.in`` twice (once
    with the shared gather), ``ssm.out``, ``tp.mlp.up`` twice (SwiGLU; once
    with the shared gather) and ``tp.mlp.down``; an attention layer:
    ``tp.attn.qkv``, ``tp.attn.kv`` (none with the shared gather),
    ``tp.attn.out`` and the same MLP; the embedding's reduce-scatter
    once."""
    step = (P - 1) * (B * S // P) * cfg.d_model * 4
    kinds = cfg.layer_pattern
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    calls = {"ssm.in": (1 if shared else 2) * n_rec, "ssm.out": n_rec,
             "tp.mlp.up": (1 if shared else 2) * (n_rec + n_attn),
             "tp.mlp.down": n_rec + n_attn, "tp.attn.qkv": n_attn, "tp.attn.out": n_attn}
    if not shared:
        calls["tp.attn.kv"] = n_attn
    want = {tag: {"steps": (P - 1) * n, "bytes": step * n} for tag, n in calls.items()}
    want["tp.embed"] = {"steps": P - 1, "bytes": step}
    return want


#: (mode, shared gather) of the prefill cases: every wire with a ring a call,
#: the shared gather on the static wire
PREFILL_CASES = [("smi:static", False), ("smi:static", True), ("smi:fused", False),
                 ("bulk", False)]


@pytest.mark.parametrize("mode, shared", PREFILL_CASES,
                         ids=[f"{m}-{'shared' if s else 'ring'}" for m, s in PREFILL_CASES])
@pytest.mark.parametrize("P", [4, 8])
def test_rglru_prefill_matches_reference(P, mode, shared, devices8):
    """The 5-layer smoke hybrid's TP prefill (the two remainder layers
    included), kernel D injected (its plain version on the CPU), against
    the reference's ``shard_map`` prefill with its Pallas kernels in
    interpret mode; the ledger equals the closed form, and the reference's
    capture (which records one period and the remainder, as it traces
    them)."""
    want, rled = _ref_prefill(P, mode, shared)
    _, cfg = _cfgs()
    ctx = make_ctx((1, P), comm_mode=mode, opt_shared_gather=shared, matmul_fn=matmul,
                   device="cpu")
    params = shard_params(params_from_reference(_np_params(), cfg, "cpu"), cfg, ctx)
    rem = params["stack"]["rem"]
    assert len(rem) == 2 and set(rem[1]) == {"norm1", "rec", "norm2", "mlp"}
    with ledger.capture() as led:
        h = lm_prefill(params, torch.from_numpy(_tokens()), cfg, ctx, capacity=S)
    assert tuple(h.shape) == (P, B, S // P, cfg.d_model)
    _close(gather_hidden(h), want, f"recurrentgemma tp={P} {mode}")
    if mode == "bulk":
        assert led.by_tag == {} and rled.by_tag == {}
        return
    assert led.by_tag == _closed_form(cfg, P, shared)
    assert {t: e["bytes"] for t, e in led.by_tag.items()} == rled.tag_bytes()


@pytest.mark.parametrize("P", [1, 4, 8])
def test_rglru_lm_prefill_matches_reference_tp1(P):
    """``build_prefill`` at tp = 1 against the reference's prefill, and at
    (1, P) over ``smi:static`` against the port's tp = 1 prefill of the same
    weights; at 40 tokens at tp = 1 (an odd/even split at every level of the
    scan: 40, 20, 10, 5, 2)."""
    ref_cfg, cfg = _cfgs()
    params = params_from_reference(_np_params(), cfg, "cpu")
    n = 40 if P == 1 else S
    tokens = _tokens(9, n)
    shape = configs.ShapeConfig("t", n, B, "prefill")
    tp1 = build_prefill(cfg, shape, device="cpu")(params, torch.from_numpy(tokens))
    if P == 1:
        want = jax.jit(lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, RefCtx(), capacity=n,
                                                         interp=True))(_np_params(), tokens)
        _close(tp1, want, "tp=1")
        return
    step = build_prefill(cfg, shape, mesh=(1, P), comm_mode="smi:static", device="cpu")
    _close(step(shard_params(params, cfg, step.ctx), torch.from_numpy(tokens)), tp1,
           f"tp={P} vs tp=1")


def test_wrong_row_order_is_seen():
    """The gathered rows reordered wrongly ((B, P_src) in place of
    (P_src, B)) give another answer, which the tp = 1 prefill tells
    apart."""
    _, cfg = _cfgs()
    params = params_from_reference(_np_params(), cfg, "cpu")
    tokens = torch.from_numpy(_tokens(4))
    shape = configs.ShapeConfig("t", S, B, "prefill")
    want = build_prefill(cfg, shape, device="cpu")(params, tokens)
    step = build_prefill(cfg, shape, mesh=(1, 4), comm_mode="bulk", device="cpu")
    tp_params = shard_params(params, cfg, step.ctx)
    conv = rglru._causal_conv

    def misordered(x, w):  # (P, B, S, W): the batch rows' sequences swapped in halves
        return conv(x.unflatten(-2, (4, S // 4)).transpose(1, 2).flatten(1, 2)
                    .reshape(x.shape), w)

    _close(step(tp_params, tokens), want, "ordered")
    with mock.patch.object(rglru, "_causal_conv", misordered):
        bad = step(tp_params, tokens)
    assert float((bad - want).abs().max()) > 1e-3 * float(want.abs().max())


# -- the specs and shard_params ----------------------------------------------------------


@pytest.mark.parametrize("P", [4, 8])
def test_specs_and_shards_match_reference(P, devices8):
    """``lm_specs`` and ``lm_cache_specs`` equal the reference's at tp = P,
    the remainder layers' among them; every leaf's rank slice equals the
    shard the reference's ``NamedSharding`` puts on model rank r's device;
    a cache leaf's batch dimension is where the slot helpers look."""
    ref_cfg, cfg = _cfgs()
    rctx = ref_make_ctx(_mesh((1, P)), comm_mode="smi:static")
    pctx = make_ctx((1, P), comm_mode="smi:static", device="cpu")
    rspecs = ref_model.lm_specs(ref_cfg, rctx)
    leaves = jax.tree.leaves(rspecs, is_leaf=lambda x: isinstance(x, PS))
    assert [tuple(s) for _, s in tree_leaves_with_path(lm_specs(cfg, pctx))] == \
        [tuple(s) for s in leaves]
    rcs = jax.tree.leaves(ref_model.lm_cache_specs(ref_cfg, rctx),
                          is_leaf=lambda x: isinstance(x, PS))
    assert [tuple(s) for _, s in tree_leaves_with_path(lm_cache_specs(cfg, pctx))] == \
        [tuple(s) for s in rcs]
    placed = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(_mesh((1, P)), sp)),
                          _np_params(), rspecs, is_leaf=lambda x: isinstance(x, PS))
    glob = params_from_reference(_np_params(), cfg, "cpu")
    sharded = tree_leaves_with_path(shard_params(glob, cfg, pctx))
    rank_of = {d: r for r, d in enumerate(_mesh((1, P)).devices[0])}
    for (path, leaf), (_, arr), sp in zip(sharded, jax.tree_util.tree_leaves_with_path(placed),
                                          leaves, strict=True):
        split = "model" in tuple(sp)
        for shard in arr.addressable_shards:
            r = rank_of[shard.device]
            mine = (leaf[:, r] if "periods" in path else leaf[r]) if split else leaf
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data), str(path))
    caches = lm_caches(cfg, 3, CAP, pctx, "cpu")
    for path, leaf in tree_leaves_with_path(caches):
        assert leaf.shape[cache_batch_dim(path, P)] == 3, path
        if "rem" in path:
            assert leaf.shape[0] == P, path


# -- decode -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_decode_tp1(n_steps, cap):
    """The reference's tp = 1 decode of ``n_steps`` steps over a ``cap``-slot
    cache (windowed layers at min(cap, window)): the tokens and the logits."""
    ref_cfg, _ = _cfgs()
    rng = np.random.RandomState(8)
    caches = ref_model.lm_caches(ref_cfg, B, cap, RefCtx())
    step = jax.jit(lambda p, c, t, pos: ref_model.lm_decode_step(p, c, t, pos, ref_cfg,
                                                                 RefCtx()))
    toks, out = [], []
    for t in range(n_steps):
        tok = rng.randint(0, 512, (B,)).astype(np.int32)
        pos = np.array([t, t + 3], np.int32)
        logits, caches = step(_np_params(), caches, tok, pos)
        toks.append((tok, pos))
        out.append(np.asarray(logits))
    return toks, out


@pytest.mark.parametrize("P", [1, 4, 8])
def test_decode_past_the_window(P):
    """40 steps (``bulk``, the wires being held elsewhere), positions one
    per row (t and t + 3), past the 16-token window: the windowed KV ring
    (16 slots, ``16 / P`` a rank) wraps twice; the logits within 1e-5 of the
    reference's tp = 1 decode at every step, each row's ring holding its
    last 16 positions, and the state of every rec layer (the remainder's
    too) finite."""
    _, cfg = _cfgs()
    assert cfg.local_window == 16
    steps, want = _ref_decode_tp1(40, 64)
    ctx = make_ctx() if P == 1 else make_ctx((1, P), comm_mode="bulk", device="cpu")
    params = shard_params(params_from_reference(_np_params(), cfg, "cpu"), cfg, ctx)
    caches = lm_caches(cfg, B, 64, ctx, "cpu")
    assert caches["periods"][2]["slot_pos"].shape[-1] * P == 16
    for t, ((tok, pos), w) in enumerate(zip(steps, want, strict=True)):
        got, caches = lm_decode_step(params, caches, torch.from_numpy(tok),
                                     torch.from_numpy(pos), cfg, ctx)
        _close(got if P == 1 else got[0], w, f"tp={P} step {t}")
    # each row's ring holds its last 16 positions
    slot_pos = caches["periods"][2]["slot_pos"][0]
    rows = slot_pos if P == 1 else slot_pos.transpose(0, 1).reshape(B, 16)
    for row, last in zip(rows, (39, 42)):
        assert sorted(row.tolist()) == list(range(last - 15, last + 1))
    assert all(torch.isfinite(c["h"]).all() for c in caches["rem"])


def _ref_decode(dims, mode, steps):
    ref_cfg, _ = _cfgs()
    rt = ref_steps.build_serve(ref_cfg, _mesh(dims), ref_configs.ShapeConfig("t", CAP, 4,
                                                                             "decode"),
                               comm_mode=mode)
    cspecs = ref_model.lm_cache_specs(ref_cfg, rt["ctx"], shard_batch=rt["B_loc"] != 4)
    caches = jax.jit(jax.shard_map(
        lambda: ref_model.lm_caches(ref_cfg, rt["B_loc"], capacity=CAP, ctx=rt["ctx"]),
        mesh=_mesh(dims), in_specs=(), out_specs=cspecs, check_vma=False),
        out_shardings=rt["cache_sharding"])()
    out = []
    for t, tok in enumerate(steps):
        logits, caches = rt["step"](_np_params(), caches, tok, np.int32(t))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("mode", ["bulk", "smi:static"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_lm_decode_step_matches_reference(mesh, mode, devices8):
    """Four decode steps of ``build_serve``'s step against the reference's
    ``shard_map`` decode: float32 logits within 1e-5, step by step."""
    dims = MESHES[mesh]
    steps = [np.random.RandomState(5 + t).randint(0, 512, (4,)).astype(np.int32)
             for t in range(4)]
    want = _ref_decode(dims, mode, steps)
    _, cfg = _cfgs()
    rt = build_serve(cfg, configs.ShapeConfig("t", CAP, 4, "decode"), mesh=dims, comm_mode=mode,
                     device="cpu")
    params = shard_params(params_from_reference(_np_params(), cfg, "cpu"), cfg, rt["ctx"])
    caches = lm_caches(cfg, 4, CAP, rt["ctx"], "cpu")
    for t, (tok, w) in enumerate(zip(steps, want, strict=True)):
        got, caches = rt["step"](params, caches, torch.from_numpy(tok), t)
        _close(got, w, f"{mesh} {mode} step {t}")


@pytest.mark.parametrize("mode", MODES)
def test_decode_row_does_not_depend_on_its_slot(mode):
    """In bfloat16 at tp = 4, a row's logits are the same bits whichever
    slot it sits in (the batch permuted, six steps): the ``ssm.out`` and
    ``tp.mlp.down`` all-reduces sum every row's elements in one rank order.
    The reference's ``decode_rglru`` rings the flattened (B, D), whose sums
    follow the slot."""
    _, cfg = _cfgs(dtype="bfloat16", d_model=128, lru_width=128)
    ctx = make_ctx((1, 4), comm_mode=mode, device="cpu")
    params = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                                  dtype=torch.bfloat16, ctx=ctx), cfg, ctx)
    perm = torch.tensor([3, 0, 2, 1])
    ca, cb = lm_caches(cfg, 4, CAP, ctx, "cpu"), lm_caches(cfg, 4, CAP, ctx, "cpu")
    for t in range(6):
        tok = torch.from_numpy(np.random.RandomState(11 + t).randint(0, 512, (4,)))
        la, _ = lm_decode_step(params, ca, tok, t, cfg, ctx, gather_logits=False)
        lb, _ = lm_decode_step(params, cb, tok[perm], t, cfg, ctx, gather_logits=False)
        assert torch.equal(la[:, perm], lb), f"{mode} step {t}"


# -- the decode ledger ------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x8", "2x4"])
def test_decode_ledger_equals_prediction(mesh):
    """One continuous decode step plus one migration: the ledger equals
    ``predict_decode_step_stats(..., eager=True)`` per tag, to the byte and
    the step; ``ssm.out`` is its closed form, a ring all-reduce a rec layer
    of one rank's (D, B) partial in 2 (P - 1) shifts of a P-th of it; the
    slot image a rank is the reference's ``slot_nbytes`` (the float32 state
    and the remainder layers included)."""
    _, cfg = _cfgs()
    dims = MESHES[mesh]
    P, slots, cap = dims[1], 2, 32
    st = SimpleNamespace(comm_mode="smi:static")
    rt = build_continuous_serve(cfg, mesh=dims, comm_mode=st.comm_mode, batch_slots=slots,
                                capacity=cap, device="cpu")
    params = shard_params(params_from_reference(_np_params(), cfg, "cpu"), cfg, rt["ctx"])
    caches = rt["init_caches"]()
    with ledger.capture() as led:
        rt["step"](params, caches, torch.zeros(slots, dtype=torch.int32),
                   torch.zeros(slots, dtype=torch.int32))
        rt["migrate_finish"](caches, rt["migrate_start"](caches, 0), 1)
    rt["pool"].close()
    assert led.by_tag == predict_decode_step_stats(cfg, dims, slots, st, capacity=cap,
                                                   migrations=1, eager=True)
    n_rec = cfg.layer_pattern.count("rec")
    chunk = -(-slots * cfg.d_model // P) * 4
    assert led.by_tag["serve.ssm.out"] == {"steps": 2 * (P - 1) * n_rec,
                                           "bytes": 2 * (P - 1) * chunk * n_rec}
    ref_cfg, _ = _cfgs()
    rctx = ref_make_ctx(_mesh((1, P)), comm_mode="smi:static")
    shapes = jax.eval_shape(lambda: ref_model.lm_caches(ref_cfg, slots, capacity=cap, ctx=rctx))
    assert tuple(pack_slot(caches, 0, P).shape) == (P, ref_slot_nbytes(shapes))


# -- serving ----------------------------------------------------------------------------

PROMPTS = [[5, 7, 9], [11, 3], [4, 8]]


@functools.lru_cache(maxsize=None)
def _wave_oracle():
    """The reference's tp = 1 wave engine."""
    ref_cfg, _ = _cfgs()
    wave = RefWave(ref_cfg, _np_params(), batch_slots=2, capacity=32)
    for i, p in enumerate(PROMPTS):
        wave.submit(RefRequest(uid=i, prompt=list(p), max_new=6))
    return {r.uid: list(r.out) for r in wave.run(max_steps=200)}


@pytest.mark.parametrize("engine", ["wave", "continuous"])
@pytest.mark.parametrize("mesh", ["1x1", *MESHES])
def test_engines_match_reference_wave_oracle(mesh, engine, devices8):
    """Both engines at tp = 1 and tp > 1 over ``smi:static`` emit the
    reference's tp = 1 wave tokens; the continuous engine migrates a slot
    (its conv window and float32 state among the leaves) between two ticks
    with one tick in flight."""
    _, cfg = _cfgs()
    dims = (1, 1) if mesh == "1x1" else MESHES[mesh]
    glob = params_from_reference(_np_params(), cfg, "cpu")
    if engine == "wave":
        rt = build_serve(cfg, configs.ShapeConfig("t", 32, 2, "decode"), mesh=dims,
                         comm_mode="smi:static", device="cpu")
        eng = ServeEngine(cfg, shard_params(glob, cfg, rt["ctx"]), runtime=rt)
    else:
        rt = build_continuous_serve(cfg, mesh=dims, comm_mode="smi:static", batch_slots=4,
                                    capacity=32, device="cpu")
        eng = ContinuousEngine(cfg, shard_params(glob, cfg, rt["ctx"]), runtime=rt)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=i, prompt=list(p), max_new=6))
    done = []
    if engine == "continuous":
        done = eng.tick() + eng.tick()
        eng.migrate(0, 3, overlap_ticks=1)
    done += eng.run(max_steps=200)
    if engine == "continuous":
        eng.shutdown()
    assert {r.uid: r.out for r in done} == _wave_oracle()


def test_serve_cli_recurrentgemma_on_cpu(tmp_path):
    """``launch.serve --arch recurrentgemma-9b --smoke --mesh 1,8`` runs
    both engines to the same tokens (once refused: item 11), and its
    ``--validate-comm`` exits 0 at (1, 8) and (2, 4) with every tag equal,
    ``serve.ssm.out`` and ``serve.migrate`` among them."""
    outs = []
    for engine in ("wave", "continuous"):
        out = tmp_path / f"{engine}.json"
        assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "1,8",
                                  "--comm-mode", "smi:static", "--engine", engine,
                                  "--requests", "3", "--max-new", "4", "--json", str(out)]) == 0
        outs.append(json.loads(out.read_text())["out"])
    assert outs[0] == outs[1] and len(outs[0]) == 3
    for mesh in ("1,8", "2,4"):
        out = tmp_path / "validate.json"
        assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", mesh,
                                  "--comm-mode", "smi:static", "--validate-comm", "--json",
                                  str(out)]) == 0
        res = json.loads(out.read_text())
        assert res["predicted"] == res["measured"]
        assert {"serve.ssm.out", "serve.migrate", "serve.tp.mlp.down"} <= set(res["measured"])
