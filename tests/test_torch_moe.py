"""The port's MoE block (``models/moe.py``) at tensor-parallel degree 1 and
P > 1 against the reference's, on the CPU; and its combine's determinism
on the card.

The reference runs each rank under ``jax.shard_map`` on the 8 host devices
of tests/conftest.py, over a ``(data, model)`` mesh; the port runs the same
inputs as one rank-stacked tensor.  Weights come from the reference's
``init_moe``/``init_lm`` (norm weights perturbed with numpy noise so that
they count) and cross as numpy; inputs come from
``numpy.random.RandomState``.  The smoke configs of qwen3-moe-30b-a3b
(top-2 of 8 experts) and llama4-scout-17b-a16e (top-1 of 8 experts and a
shared expert) are cut to 8 experts, so that they split over 8 ranks; a
third case routes with ``capacity_factor`` 0.5, so that tokens overflow
their experts and are dropped.

* ``route``: the chosen experts equal the reference's ``lax.top_k`` of its
  router softmax, and the gate values within float32 1e-6;
* ``apply_moe`` (prefill) and ``apply_moe_replicated`` (decode) and their
  load-balancing loss at tp = 1, (1, 4) and (1, 8): float32 within 1e-5
  of the largest magnitude;
* ``lm_prefill`` at (1, 4) and (1, 8) against the reference's ``shard_map``
  prefill (its Pallas kernels in interpret mode), the ledger's ``ep.*`` and
  ``tp.*`` tags equal to a closed form; ``lm_decode_step`` at (1, 4), (1, 8)
  and (2, 4) against the reference's ``build_serve`` step;
* the decode ledger equal to ``predict_decode_step_stats`` with a
  migration at (1, 8) and (2, 4); both engines' tokens equal to the
  reference's tp = 1 wave oracle; a row's bfloat16 logits independent of
  its slot (the ``ep.combine`` all-reduce rings ``(D, B)``);
* on the card (``cuda``): the combine's bits equal run after run, and a
  token's output the same bits whichever row it sits in.

The reference (JAX) is imported only in the CPU cases, so on a machine with
a card and no JAX the ``cuda`` cases run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_moe.py
"""

import functools
import json
from contextlib import contextmanager
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.interop import params_from_reference, shard_params, shard_tree
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import build_continuous_serve, build_serve
from repro_torch.mesh.api import make_ctx
from repro_torch.models import gather_hidden, init_lm, lm_caches, lm_decode_step, lm_prefill
from repro_torch.models import moe as port_moe
from repro_torch.netsim import predict_decode_step_stats
from repro_torch.parallel import ledger
from repro_torch.serving import ContinuousEngine, Request, ServeEngine

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-5
#: case -> (arch, config overrides)
CASES = {
    "qwen3": ("qwen3-moe-30b-a3b", (("n_experts", 8),)),
    "scout": ("llama4-scout-17b-a16e", (("n_experts", 8),)),
    "qwen3_drops": ("qwen3-moe-30b-a3b", (("n_experts", 8), ("capacity_factor", 0.5))),
}
MESHES = {"1x4": (1, 4), "1x8": (1, 8), "2x4": (2, 4)}
B, S, CAP = 2, 32, 16


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (imports JAX)."""
    import jax
    from jax.sharding import PartitionSpec

    from repro import configs as ref_configs
    from repro.kernels.matmul import matmul as ref_matmul
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_mesh
    from repro.mesh.api import ParallelCtx
    from repro.mesh.api import make_ctx as ref_make_ctx
    from repro.models import model as ref_model
    from repro.models import moe as ref_moe
    from repro.parallel import ledger as ref_ledger
    from repro.serving import Request as RefRequest
    from repro.serving import ServeEngine as RefWave

    return SimpleNamespace(jax=jax, PS=PartitionSpec, configs=ref_configs, matmul=ref_matmul,
                           steps=ref_steps, make_mesh=functools.lru_cache(None)(make_mesh),
                           Ctx=ParallelCtx, make_ctx=ref_make_ctx, model=ref_model, moe=ref_moe,
                           ledger=ref_ledger, Request=RefRequest, Wave=RefWave)


def _cfg(case, **extra):
    arch, kw = CASES[case]
    return configs.smoke(configs.get_arch(arch)).scaled(**dict(kw), **extra)


def _ref_cfg(ref, case, **extra):
    arch, kw = CASES[case]
    return ref.configs.smoke(ref.configs.get_arch(arch)).scaled(**dict(kw), **extra)


def _close(got, want, what="", tol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} * {scale}"


def _mesh(ref, dims):
    return ref.make_mesh(dims, ("data", "model"))


def _ctxs(ref, P, mode="smi:static", **kw):
    """(reference context, port context) of a (1, P) mesh; tp = 1 at P = 1."""
    if P == 1:
        return ref.Ctx(), make_ctx()
    return (ref.make_ctx(_mesh(ref, (1, P)), comm_mode=mode, **kw),
            make_ctx((1, P), comm_mode=mode, device="cpu", **kw))


@contextmanager
def _ref_capture(ref):
    """The reference's ledger capture with every transport it mirrors held
    to the end (its ``attach`` keys transports by ``id()``)."""
    held = []
    attach = ref.ledger.CommLedger.attach

    def holding_attach(self, t):
        held.append(t)
        return attach(self, t)

    with mock.patch.object(ref.ledger.CommLedger, "attach", holding_attach), \
            ref.ledger.capture() as led:
        yield led


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _np_moe(case):
    """The reference's ``init_moe`` at tp = 1 (global shapes), as numpy."""
    import jax

    from repro import configs as ref_configs
    from repro.mesh.api import ParallelCtx
    from repro.models import moe as ref_moe

    arch, kw = CASES[case]
    rcfg = ref_configs.smoke(ref_configs.get_arch(arch)).scaled(**dict(kw))
    return jax.tree.map(np.asarray, ref_moe.init_moe(jax.random.PRNGKey(3), rcfg, ParallelCtx()))


# -- routing and the block ---------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_matches_reference(case, ref):
    """The chosen experts equal the reference's (its router softmax and
    ``lax.top_k``, as ``_dispatch_compute`` computes them), the gate values
    and the load-balancing loss within float32 1e-6 (the port counts the
    choices where the reference sums 1/(T k) a choice)."""
    jnp = ref.jax.numpy
    cfg, rcfg = _cfg(case), _ref_cfg(ref, case)
    np_p = _np_moe(case)
    xf = np.random.RandomState(2).randn(B * S, cfg.d_model).astype(np.float32)
    probs = ref.jax.nn.softmax((jnp.asarray(xf) @ np_p["router"]).astype(jnp.float32), axis=-1)
    want_vals, want_idx = ref.jax.lax.top_k(probs, rcfg.top_k)
    want_vals = want_vals / jnp.maximum(want_vals.sum(-1, keepdims=True), 1e-9)
    vals, idx, aux = port_moe.route(torch.from_numpy(np.array(np_p["router"])),
                                    torch.from_numpy(xf), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(vals, want_vals, "gate values", 1e-6)
    _, want_aux = ref.moe._dispatch_compute(np_p, jnp.asarray(xf), rcfg, ref.Ctx())
    _close(aux, want_aux, "aux", 1e-6)


def _shard_moe(np_p, cfg, ctx):
    p = _to_port(np_p)
    return p if ctx.tp == 1 else shard_tree(p, port_moe.moe_specs(cfg, ctx), ctx)


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_reference(case, P, ref, devices8):
    """The prefill block on the sequence-sharded stream (a gathered view of
    B*S = 64 tokens routed once), its output and loss against the
    reference's ``apply_moe`` under ``shard_map``; every rank's choices
    equal (each routes its own gathered copy)."""
    cfg, rcfg = _cfg(case), _ref_cfg(ref, case)
    rctx, pctx = _ctxs(ref, P)
    np_p = _np_moe(case)
    x = np.random.RandomState(4).randn(B, S, cfg.d_model).astype(np.float32)
    if P == 1:
        want, want_aux = ref.moe.apply_moe(np_p, x, rcfg, rctx)
    else:
        fn = ref.jax.shard_map(lambda p, v: ref.moe.apply_moe(p, v, rcfg, rctx),
                               mesh=_mesh(ref, (1, P)),
                               in_specs=(ref.moe.moe_specs(rcfg, rctx), ref.PS(None, "model")),
                               out_specs=(ref.PS(None, "model"), ref.PS()), check_vma=False)
        want, want_aux = ref.jax.jit(fn)(np_p, x)
    xs = torch.from_numpy(x)
    if P > 1:
        xs = xs.reshape(B, P, S // P, -1).transpose(0, 1).contiguous()
    params = _shard_moe(np_p, cfg, pctx)
    with ledger.capture() as led:
        got, aux = port_moe.apply_moe(params, xs, cfg, pctx)
    _close(gather_hidden(got) if P > 1 else got, want, f"{case} tp={P}")
    _close(aux, want_aux, f"{case} tp={P} aux")
    if P > 1:
        step = (P - 1) * (B * S // P) * cfg.d_model * 4
        assert {t: led.by_tag[t] for t in ("ep.dispatch", "ep.combine")} == \
            {t: {"steps": P - 1, "bytes": step} for t in ("ep.dispatch", "ep.combine")}
        xf = port_moe.moe_dispatch(xs.reshape(P, B * S // P, -1), pctx)
        choices = [port_moe.route(params["router"], xf[r], cfg)[1] for r in range(P)]
        assert all(torch.equal(c, choices[0]) for c in choices)


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_replicated_matches_reference(case, P, ref, devices8):
    """The decode block on replicated rows (4 tokens, no drops: an expert
    takes at least 8), its output and loss against the reference's
    ``apply_moe_replicated`` under ``shard_map``; every rank's rows equal."""
    cfg, rcfg = _cfg(case), _ref_cfg(ref, case)
    rctx, pctx = _ctxs(ref, P)
    np_p = _np_moe(case)
    x = np.random.RandomState(5).randn(4, 1, cfg.d_model).astype(np.float32)
    if P == 1:
        want, want_aux = ref.moe.apply_moe_replicated(np_p, x, rcfg, rctx)
    else:
        fn = ref.jax.shard_map(lambda p, v: ref.moe.apply_moe_replicated(p, v, rcfg, rctx),
                               mesh=_mesh(ref, (1, P)),
                               in_specs=(ref.moe.moe_specs(rcfg, rctx), ref.PS()),
                               out_specs=(ref.PS(), ref.PS()), check_vma=False)
        want, want_aux = ref.jax.jit(fn)(np_p, x)
    xs = torch.from_numpy(x)
    if P > 1:
        xs = xs.expand(P, *x.shape)
    got, aux = port_moe.apply_moe_replicated(_shard_moe(np_p, cfg, pctx), xs, cfg, pctx)
    for r in range(P if P > 1 else 0):
        _close(got[r], want, f"{case} tp={P} rank {r}")
    if P == 1:
        _close(got, want, f"{case} tp=1")
    _close(aux, want_aux, f"{case} tp={P} aux")


@pytest.mark.parametrize("rank", [1, 3])
def test_dispatch_refuses_unequal_rank_copies(rank):
    """Routing is computed once, from rank 0's copy of the gathered view:
    a view whose copy on any other rank differs (a gather that delivered
    other rows there) raises instead of being routed from rank 0 alone."""
    cfg = _cfg("qwen3")
    ctx = make_ctx((1, 4), comm_mode="smi:static", device="cpu")
    p = shard_tree(port_moe.init_moe(torch.Generator().manual_seed(0), cfg, ctx),
                   port_moe.moe_specs(cfg, ctx), ctx)
    xf = torch.from_numpy(np.random.RandomState(5).randn(B * S, cfg.d_model)
                          .astype(np.float32)).expand(4, -1, -1).clone()
    port_moe._dispatch_compute(p, xf, cfg, ctx)
    xf[rank, 7, 3] += 1.0
    with pytest.raises(RuntimeError, match="replicated view differ"):
        port_moe._dispatch_compute(p, xf, cfg, ctx)


@pytest.mark.parametrize("P", [1, 4])
def test_combine_sums_in_ascending_expert_order(P):
    """A token's contributions are summed one add at a time in ascending
    expert order, each rank over its own experts: in bfloat16 the partials
    equal that sum, bit for bit, whatever order top-k gave them in (at
    P = 1, six contributions a token, summing in top-k order gives other
    bits)."""
    rng = np.random.RandomState(6)
    T, k, E, D = 32, 6, 8, 16
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k] for _ in range(T)]))
    tok_out = torch.from_numpy(rng.randn(T * k, D).astype(np.float32) * 100).bfloat16()
    y = port_moe.combine(tok_out, idx, E // P, P)
    by_topk = torch.zeros(P, T, D, dtype=torch.bfloat16)
    for t in range(T):
        want = torch.zeros(P, D, dtype=torch.bfloat16)
        for j in idx[t].argsort():
            r = int(idx[t, j]) // (E // P)
            want[r] = want[r] + tok_out[t * k + j]
        for j in range(k):
            r = int(idx[t, j]) // (E // P)
            by_topk[r, t] = by_topk[r, t] + tok_out[t * k + j]
        assert torch.equal(y[:, t], want), t
    assert P > 1 or not torch.equal(y, by_topk)


# -- the model ----------------------------------------------------------------------------


def _lm_cfg(case, **kw):
    """The model case's smoke config with 8 heads (whole heads on 8 ranks)."""
    return _cfg(case, n_heads=8, **kw)


@functools.lru_cache(maxsize=None)
def _np_lm(case):
    import jax

    from repro import configs as ref_configs
    from repro.mesh.api import ParallelCtx
    from repro.models import model as ref_model

    arch, kw = CASES[case]
    rcfg = ref_configs.smoke(ref_configs.get_arch(arch)).scaled(n_heads=8, **dict(kw))
    p = ref_model.init_lm(jax.random.PRNGKey(0), rcfg, ParallelCtx())
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        a = np.asarray(leaf)
        if "norm" in str(getattr(path[-1], "key", "")):
            a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


def _closed_form(cfg, P):
    """Per tag, (steps, bytes) of one rank's wire traffic in one prefill:
    each streamed call moves P - 1 ring steps of one rank's rows (B*S/P) of
    the model width in float32; per layer the attention's Q, K/V and out
    calls, ``ep.dispatch`` and ``ep.combine`` once each, and a shared
    expert's two up-projections and its down-projection; the embedding's
    reduce-scatter once."""
    step = (P - 1) * (B * S // P) * cfg.d_model * 4
    calls = {"tp.attn.qkv": 1, "tp.attn.kv": 1, "tp.attn.out": 1, "ep.dispatch": 1,
             "ep.combine": 1}
    if cfg.shared_expert:
        calls.update({"tp.mlp.up": 2, "tp.mlp.down": 1})
    want = {tag: {"steps": (P - 1) * n * cfg.n_layers, "bytes": step * n * cfg.n_layers}
            for tag, n in calls.items()}
    want["tp.embed"] = {"steps": P - 1, "bytes": step}
    return want


@pytest.mark.parametrize("mode", ["smi:static", "bulk"])
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("case", ["qwen3", "scout"])
def test_lm_prefill_matches_reference(case, P, mode, ref, devices8):
    """The smoke model's TP prefill (kernel D injected, its plain version on
    the CPU) against the reference's ``shard_map`` prefill with its Pallas
    kernels in interpret mode, and the tp = 1 prefill of the same weights;
    the ledger equals its closed form and its one-layer share the
    reference's capture."""
    cfg = _lm_cfg(case)
    rcfg = _ref_cfg(ref, case, n_heads=8)
    from repro_torch.kernels.matmul import matmul

    rctx = ref.make_ctx(_mesh(ref, (1, P)), comm_mode=mode,
                        matmul_fn=functools.partial(ref.matmul, interpret=True))
    tokens = np.random.RandomState(7).randint(0, 512, (B, S)).astype(np.int32)
    fn = ref.jax.shard_map(
        lambda p, t: ref.model.lm_prefill(p, t, rcfg, rctx, capacity=S, interp=True),
        mesh=_mesh(ref, (1, P)), in_specs=(ref.model.lm_specs(rcfg, rctx), ref.PS()),
        out_specs=ref.PS(None, "model", None), check_vma=False)
    with _ref_capture(ref) as rled:
        want = np.asarray(ref.jax.jit(fn)(_np_lm(case), tokens))
    ctx = make_ctx((1, P), comm_mode=mode, matmul_fn=matmul, device="cpu")
    glob = params_from_reference(_np_lm(case), cfg, "cpu")
    with ledger.capture() as led:
        h = lm_prefill(shard_params(glob, cfg, ctx), torch.from_numpy(tokens), cfg, ctx,
                       capacity=S)
    _close(gather_hidden(h), want, f"{case} tp={P} {mode}")
    _close(lm_prefill(glob, torch.from_numpy(tokens), cfg, make_ctx(), capacity=S), want,
           f"{case} tp=1")
    if mode == "bulk":
        assert led.by_tag == {} and rled.by_tag == {}
        return
    assert led.by_tag == _closed_form(cfg, P)
    assert {t: e["bytes"] if t == "tp.embed" else e["bytes"] // cfg.n_layers
            for t, e in led.by_tag.items()} == rled.tag_bytes()


@pytest.mark.parametrize("mode", ["smi:static", "bulk"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["qwen3", "scout"])
def test_lm_decode_step_matches_reference(case, mesh, mode, ref, devices8):
    """Four decode steps of ``build_serve``'s step against the reference's
    ``shard_map`` decode: float32 logits within 1e-5, step by step."""
    dims = MESHES[mesh]
    cfg = _lm_cfg(case)
    rcfg = _ref_cfg(ref, case, n_heads=8)
    rt = ref.steps.build_serve(rcfg, _mesh(ref, dims),
                               ref.configs.ShapeConfig("t", CAP, 4, "decode"), comm_mode=mode)
    cspecs = ref.model.lm_cache_specs(rcfg, rt["ctx"], shard_batch=rt["B_loc"] != 4)
    rcaches = ref.jax.jit(ref.jax.shard_map(
        lambda: ref.model.lm_caches(rcfg, rt["B_loc"], capacity=CAP, ctx=rt["ctx"]),
        mesh=_mesh(ref, dims), in_specs=(), out_specs=cspecs, check_vma=False),
        out_shardings=rt["cache_sharding"])()
    prt = build_serve(cfg, configs.ShapeConfig("t", CAP, 4, "decode"), mesh=dims,
                      comm_mode=mode, device="cpu")
    params = shard_params(params_from_reference(_np_lm(case), cfg, "cpu"), cfg, prt["ctx"])
    caches = lm_caches(cfg, 4, CAP, prt["ctx"], "cpu")
    for t in range(4):
        tok = np.random.RandomState(5 + t).randint(0, 512, (4,)).astype(np.int32)
        want, rcaches = rt["step"](_np_lm(case), rcaches, tok, np.int32(t))
        got, caches = prt["step"](params, caches, torch.from_numpy(tok), t)
        _close(got, np.asarray(want), f"{case} {mesh} {mode} step {t}")


@pytest.mark.parametrize("mesh", ["1x8", "2x4"])
@pytest.mark.parametrize("case", ["qwen3", "scout"])
def test_decode_ledger_equals_prediction(case, mesh):
    """One continuous decode step plus one migration: the ledger equals
    ``predict_decode_step_stats(..., eager=True)`` per tag, to the byte and
    the step; ``ep.combine`` is a ring all-reduce a layer of one rank's
    (D, B) partial in 2 (P - 1) shifts of a P-th of it."""
    cfg = _lm_cfg(case)
    dims = MESHES[mesh]
    P, slots, cap = dims[1], 2, 32
    st = SimpleNamespace(comm_mode="smi:static")
    rt = build_continuous_serve(cfg, mesh=dims, comm_mode=st.comm_mode, batch_slots=slots,
                                capacity=cap, device="cpu")
    params = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, rt["ctx"])
    caches = rt["init_caches"]()
    with ledger.capture() as led:
        rt["step"](params, caches, torch.zeros(slots, dtype=torch.int32),
                   torch.zeros(slots, dtype=torch.int32))
        rt["migrate_finish"](caches, rt["migrate_start"](caches, 0), 1)
    rt["pool"].close()
    assert led.by_tag == predict_decode_step_stats(cfg, dims, slots, st, capacity=cap,
                                                   migrations=1, eager=True)
    chunk = -(-slots * cfg.d_model // P) * 4
    assert led.by_tag["serve.ep.combine"] == {"steps": 2 * (P - 1) * cfg.n_layers,
                                              "bytes": 2 * (P - 1) * chunk * cfg.n_layers}
    assert ("serve.tp.mlp.down" in led.by_tag) == cfg.shared_expert


PROMPTS = [[5, 7, 9], [11, 3], [4, 8]]


@pytest.mark.parametrize("engine", ["wave", "continuous"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["qwen3", "scout"])
def test_tp_engines_match_reference_wave_oracle(case, mesh, engine, ref, devices8):
    """Both engines at tp > 1 over ``smi:static`` emit the reference's
    tp = 1 wave tokens; the continuous engine migrates a slot with one tick
    in flight."""
    cfg = _lm_cfg(case)
    wave = ref.Wave(_ref_cfg(ref, case, n_heads=8), _np_lm(case), batch_slots=2, capacity=32)
    for i, p in enumerate(PROMPTS):
        wave.submit(ref.Request(uid=i, prompt=list(p), max_new=4))
    want = {r.uid: list(r.out) for r in wave.run(max_steps=200)}
    dims = MESHES[mesh]
    glob = params_from_reference(_np_lm(case), cfg, "cpu")
    if engine == "wave":
        rt = build_serve(cfg, configs.ShapeConfig("t", 32, 2, "decode"), mesh=dims,
                         comm_mode="smi:static", device="cpu")
        eng = ServeEngine(cfg, shard_params(glob, cfg, rt["ctx"]), runtime=rt)
    else:
        rt = build_continuous_serve(cfg, mesh=dims, comm_mode="smi:static", batch_slots=4,
                                    capacity=32, device="cpu")
        eng = ContinuousEngine(cfg, shard_params(glob, cfg, rt["ctx"]), runtime=rt)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=i, prompt=list(p), max_new=4))
    done = []
    if engine == "continuous":
        done = eng.tick() + eng.tick()
        eng.migrate(0, 3, overlap_ticks=1)
    done += eng.run(max_steps=200)
    if engine == "continuous":
        eng.shutdown()
    assert {r.uid: r.out for r in done} == want


@pytest.mark.parametrize("mode", ["smi:static", "smi:fused", "bulk"])
@pytest.mark.parametrize("case", ["qwen3", "scout"])
def test_decode_row_does_not_depend_on_its_slot(case, mode):
    """In bfloat16 at tp = 4, a row's logits are the same bits whichever
    slot it sits in (the batch permuted, six steps): the ``ep.combine``
    all-reduce sums every row's elements in one rank order, and the
    expert buffer's rows do not mix."""
    cfg = _lm_cfg(case, dtype="bfloat16", d_model=128, d_ff_expert=128)
    ctx = make_ctx((1, 4), comm_mode=mode, device="cpu")
    params = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                                  dtype=torch.bfloat16), cfg, ctx)
    perm = torch.tensor([3, 0, 2, 1])
    ca, cb = lm_caches(cfg, 4, CAP, ctx, "cpu"), lm_caches(cfg, 4, CAP, ctx, "cpu")
    for t in range(6):
        tok = torch.from_numpy(np.random.RandomState(11 + t).randint(0, 512, (4,)))
        la, _ = lm_decode_step(params, ca, tok, t, cfg, ctx, gather_logits=False)
        lb, _ = lm_decode_step(params, cb, tok[perm], t, cfg, ctx, gather_logits=False)
        assert torch.equal(la[:, perm], lb), f"{mode} step {t}"


def test_shard_params_share_the_expert_storage():
    """An expert leaf (L, E, D, f) split over the model axis is a view,
    (L, P, E/P, D, f), of the global leaf's storage: the tp = 1 and the
    tp = P copies share it; attention leaves are copied."""
    cfg = _lm_cfg("qwen3")
    glob = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    ctx = make_ctx((1, 8), comm_mode="smi:static", device="cpu")
    sp = shard_params(glob, cfg, ctx)
    g, s = glob["stack"]["periods"][0], sp["stack"]["periods"][0]
    for name in ("w_gate", "w_up", "w_down"):
        assert s["moe"][name].data_ptr() == g["moe"][name].data_ptr()
        assert tuple(s["moe"][name].shape) == (cfg.n_layers, 8, 1) + tuple(g["moe"][name].shape[2:])
    assert s["moe"]["router"] is g["moe"]["router"]
    assert s["attn"]["wq"].data_ptr() != g["attn"]["wq"].data_ptr()


def test_serve_cli_moe_tensor_parallel_on_cpu(tmp_path):
    """``launch.serve --arch qwen3-moe-30b-a3b --smoke`` (its 4 experts
    split over 4 ranks) runs at tp = 1 and at (1, 4), both engines to the
    same tokens, and its ``--validate-comm`` exits 0 at (1, 4) and (2, 2)
    with every tag equal, ``serve.ep.combine`` among them."""
    outs = {}
    for mesh in ("1,1", "1,4"):
        for engine in ("wave", "continuous"):
            out = tmp_path / f"{engine}.json"
            assert launch_serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                                      "cpu", "--mesh", mesh, "--comm-mode", "smi:static",
                                      "--engine", engine, "--json", str(out)]) == 0
            outs[mesh, engine] = json.loads(out.read_text())["out"]
    assert outs["1,4", "wave"] == outs["1,4", "continuous"]
    assert outs["1,1", "wave"] == outs["1,1", "continuous"]
    for mesh in ("1,4", "2,2"):
        out = tmp_path / "validate.json"
        assert launch_serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
                                  "--mesh", mesh, "--comm-mode", "smi:static", "--validate-comm",
                                  "--json", str(out)]) == 0
        res = json.loads(out.read_text())
        assert res["predicted"] == res["measured"] and "serve.ep.combine" in res["measured"]


# -- on the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the combine's order on the card)")
    return torch.device("cuda", 0)


def _card_block(dev, d_model=256, n_experts=16, top_k=8, T=64):
    cfg = configs.smoke(configs.get_arch("qwen3-moe-30b-a3b")).scaled(
        d_model=d_model, n_experts=n_experts, top_k=top_k, d_ff_expert=128, dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(3)
    p = port_moe.init_moe(g, cfg, make_ctx(), dtype=torch.bfloat16)
    x = torch.randn((T, d_model), generator=g, device=dev).bfloat16()
    return cfg, p, x


@pytest.mark.cuda
def test_combine_bits_repeat_on_card(cuda_device):
    """The prefill block's partials, in bfloat16 at top-8 of 16 experts,
    are the same bits on ten runs (no atomics in the combine)."""
    cfg, p, x = _card_block(cuda_device)
    ctx = make_ctx()
    first, _ = port_moe._dispatch_compute(p, x, cfg, ctx)
    for _ in range(10):
        again, _ = port_moe._dispatch_compute(p, x, cfg, ctx)
        assert torch.equal(again, first)


@pytest.mark.cuda
def test_combine_row_independent_on_card(cuda_device):
    """Decode on the card: 8 replicated rows (no drops) permuted give each
    row's output the same bits, at tp = 1 and at tp = 4 (the ``(D, B)``
    all-reduce over ``smi:fused``, kernel A)."""
    cfg, p, x = _card_block(cuda_device, T=8)
    perm = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4], device=cuda_device)
    for ctx in (make_ctx(), make_ctx((1, 4), comm_mode="smi:fused", device=cuda_device)):
        pp = p if ctx.tp == 1 else shard_tree(p, port_moe.moe_specs(cfg, ctx), ctx)
        xs = x[:, None] if ctx.tp == 1 else x[:, None].expand(4, 8, 1, -1)
        ya, _ = port_moe.apply_moe_replicated(pp, xs, cfg, ctx)
        yb, _ = port_moe.apply_moe_replicated(pp, xs[..., perm, :, :], cfg, ctx)
        assert torch.equal(ya[..., perm, :, :], yb), ctx.tp


def test_serve_cli_moe_at_2x4(tmp_path):
    """The launcher at ``--mesh 2,4``: qwen3-moe's weights pass the FSDP
    rule's 10 GB a model shard (from the config's count, 30.5 B
    parameters), so the launcher stores them over the data axis (the plan
    checked here at full size, without drawing 61 GB); the smoke config
    stays under the rule, and its gate at (2, 4) passes, and so does the
    serving step's ledger on its continuous runtime with FSDP forced on
    and off."""
    from repro_torch.launch.steps import _fsdp_plan, build_continuous_serve
    from repro_torch.mesh.api import check_fsdp

    full = configs.get_arch("qwen3-moe-30b-a3b")
    assert check_fsdp("auto", (2, 4), full.param_count())
    ctx = make_ctx((2, 4), comm_mode="smi:static", device="cpu")
    plan = _fsdp_plan(full, ctx, "auto", (2, 4))
    assert plan is not None and plan["stack"]["periods"][0]["moe"]["w_up"] >= 0
    small = configs.smoke(full)
    for fsdp in (True, False):
        rt = build_continuous_serve(small, mesh=(2, 4), comm_mode="smi:static", batch_slots=2,
                                    capacity=64, fsdp=fsdp, device="cpu")
        measured, predicted, _ = launch_serve.step_ledger(
            small, rt, SimpleNamespace(comm_mode="smi:static"), 64, "cpu")
        assert predicted == measured
        assert ("fsdp.gather" in measured) == fsdp
    out = tmp_path / "validate.json"
    assert launch_serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
                              "--mesh", "2,4", "--comm-mode", "smi:static",
                              "--validate-comm", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["predicted"] == res["measured"]
