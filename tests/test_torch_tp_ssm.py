"""The port's Mamba2 (``"ssm"``) block at tensor-parallel degree P > 1
against the reference's, on the CPU.

The reference runs each rank under ``jax.shard_map`` on the 8 host devices
of tests/conftest.py, over a ``(data, model)`` mesh; the port runs the same
inputs as one rank-stacked tensor.  Weights come from the reference's
``init_lm`` (the per-head and norm weights perturbed with numpy noise so
that they count), cross with ``params_from_reference`` and are split by
``shard_params``; inputs come from ``numpy.random.RandomState``.

* ``lm_prefill`` of the smoke mamba2 at meshes (1, 4) and (1, 8) over
  ``smi:static``, ``smi:fused`` and ``bulk``, with and without the shared
  gather, against the reference's ``shard_map`` prefill with its Pallas
  kernels (the SSD scan, the GEMM) in interpret mode: float32 within 1e-5 of
  the largest magnitude; the port's ledger equals a closed form, and its
  one-layer share the reference's capture;
* ``decode_ssm`` at tp = 4, and ``lm_decode_step`` (``build_serve``'s step)
  at (1, 4), (1, 8) and (2, 4), against the reference's, step by step,
  within 1e-5; a row's bfloat16 logits the same bits whichever slot it sits
  in (the ``ssm.out`` all-reduce rings ``(D, B)``);
* the decode ledger equal to ``predict_decode_step_stats`` with a migration
  at (1, 8) and (2, 4), and the ``ssm.out`` tag to its closed form;
* both engines' tokens at (1, 4), (1, 8) and (2, 4) equal to the
  reference's tp = 1 wave oracle, a migrated slot's unchanged, and a slot
  image a rank of the reference's bytes;
* the specs and ``shard_params`` equal to the reference's shards, and
  ``launch.serve --arch mamba2-2.7b --mesh 1,8`` (and its
  ``--validate-comm``) on the CPU.
"""

import functools
import json
from contextlib import contextmanager
from types import SimpleNamespace
from unittest import mock

import jax
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
from repro.models import ssm as ref_ssm
from repro.parallel import ledger as ref_ledger
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefWave
from repro.serving.continuous import slot_nbytes as ref_slot_nbytes
from repro_torch import configs
from repro_torch.interop import params_from_reference, shard_params, shard_tree
from repro_torch.kernels.matmul import matmul
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import build_continuous_serve, build_prefill, build_serve
from repro_torch.mesh.api import make_ctx
from repro_torch.models import gather_hidden, init_lm, lm_cache_specs, lm_caches
from repro_torch.models import lm_decode_step, lm_prefill, lm_specs
from repro_torch.models import ssm as port_ssm
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.netsim import predict_decode_step_stats
from repro_torch.parallel import ledger
from repro_torch.serving import ContinuousEngine, Request, ServeEngine
from repro_torch.serving.continuous import pack_slot

ARCH = "mamba2-2.7b"
RTOL = 1e-5
MODES = ("smi:static", "smi:fused", "bulk")
MESHES = {"1x4": (1, 4), "1x8": (1, 8), "2x4": (2, 4)}
B, S, CAP = 2, 32, 16


@functools.lru_cache(maxsize=None)
def _mesh(dims):
    return make_mesh(dims, ("data", "model"))


def _cfgs(**kw):
    return (ref_configs.smoke(ref_configs.get_arch(ARCH)).scaled(**kw),
            configs.smoke(configs.get_arch(ARCH)).scaled(**kw))


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} * {scale}"


@functools.lru_cache(maxsize=None)
def _np_params(kw=()):
    """The reference's init_lm, the per-head and norm weights perturbed (the
    init's dt_bias 0, A_log 0, D_skip 1 and unit norms would hide a wrong
    head or rank order), as numpy."""
    ref_cfg, _ = _cfgs(**dict(kw))
    p = ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, RefCtx())
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        a = np.asarray(leaf)
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name or name in ("gn", "dt_bias", "A_log", "D_skip"):
            a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


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


# -- lm_prefill at tp > 1 -------------------------------------------------------------


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
    each streamed call moves P - 1 ring steps of one rank's rows (B*S/P) of
    the model width in float32; a layer's calls are ``ssm.in`` twice (z and
    x; once with the shared gather), ``ssm.gather`` once (none with the
    shared gather) and ``ssm.out`` once; the embedding's reduce-scatter
    once."""
    step = (P - 1) * (B * S // P) * cfg.d_model * 4
    calls = {"ssm.in": 1 if shared else 2, "ssm.out": 1}
    if not shared:
        calls["ssm.gather"] = 1
    want = {tag: {"steps": (P - 1) * n * cfg.n_layers, "bytes": step * n * cfg.n_layers}
            for tag, n in calls.items()}
    want["tp.embed"] = {"steps": P - 1, "bytes": step}
    return want


@pytest.mark.parametrize("shared", [False, True], ids=["ring_per_call", "shared_gather"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", [4, 8])
def test_ssm_prefill_matches_reference(P, mode, shared, devices8):
    """The smoke mamba2's TP prefill, kernel D injected (its plain version on
    the CPU) and kernel F over every rank's P*B*nh_loc head rows, against
    the reference's with its Pallas kernels in interpret mode."""
    want, rled = _ref_prefill(P, mode, shared)
    _, cfg = _cfgs()
    ctx = make_ctx((1, P), comm_mode=mode, opt_shared_gather=shared, matmul_fn=matmul,
                   device="cpu")
    params = shard_params(params_from_reference(_np_params(), cfg, "cpu"), cfg, ctx)
    with ledger.capture() as led:
        h = lm_prefill(params, torch.from_numpy(_tokens()), cfg, ctx, capacity=S)
    assert tuple(h.shape) == (P, B, S // P, cfg.d_model)
    _close(gather_hidden(h), want, f"mamba2 tp={P} {mode}")
    if mode == "bulk":
        assert led.by_tag == {} and rled.by_tag == {}
        return
    assert led.by_tag == _closed_form(cfg, P, shared)
    assert {t: e["bytes"] if t == "tp.embed" else e["bytes"] // cfg.n_layers
            for t, e in led.by_tag.items()} == rled.tag_bytes()


@pytest.mark.parametrize("P", [4, 8])
def test_ssm_tp_prefill_matches_tp1_prefill(P):
    """``build_prefill`` on a (1, P) mesh over ``smi:static`` against the
    tp = 1 prefill of the same weights, within 1e-5, at a ragged S (the scan
    pads to its chunk)."""
    _, cfg = _cfgs()
    params = params_from_reference(_np_params(), cfg, "cpu")
    tokens = torch.from_numpy(_tokens(3, 40))
    shape = configs.ShapeConfig("t", 40, B, "prefill")
    want = build_prefill(cfg, shape, device="cpu")(params, tokens)
    step = build_prefill(cfg, shape, mesh=(1, P), comm_mode="smi:static", device="cpu")
    _close(step(shard_params(params, cfg, step.ctx), tokens), want, f"tp={P} vs tp=1")


def test_head_rows_follow_the_rank_stack():
    """Kernel F reads head row i's B and C from sequence row i // nh_loc:
    the port lays the head rows (P, B, nh_loc), whose (P, B) sequence rows
    are the B/C rows.  Handing the scan the rows (B, P, nh_loc) instead
    gives another answer, which the tp = 1 prefill tells apart."""
    _, cfg = _cfgs()
    params = params_from_reference(_np_params(), cfg, "cpu")
    tokens = torch.from_numpy(_tokens(4))
    shape = configs.ShapeConfig("t", S, B, "prefill")
    want = build_prefill(cfg, shape, device="cpu")(params, tokens)
    step = build_prefill(cfg, shape, mesh=(1, 4), comm_mode="bulk", device="cpu")
    tp_params = shard_params(params, cfg, step.ctx)
    scan = port_ssm.ssd_scan

    def misordered(x, dt, Bm, Cm, A, **kw):
        def swap(t):  # (P, B, nh, ..) rows read as (B, P, nh, ..)
            return t.reshape((4, B, -1) + t.shape[1:]).transpose(0, 1).reshape(t.shape)
        return swap(scan(swap(x), swap(dt), Bm, Cm, swap(A), **kw))

    _close(step(tp_params, tokens), want, "rank-stacked head rows")
    with mock.patch.object(port_ssm, "ssd_scan", misordered):
        bad = step(tp_params, tokens)
    assert float((bad - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_prefill_refuses_unequal_rank_copies():
    """B/C are computed once, from rank 0's copy of the ``ssm.gather``
    view: a gather that delivers other rows to another rank raises instead
    of going unseen."""
    _, cfg = _cfgs()
    params = params_from_reference(_np_params(), cfg, "cpu")
    tokens = torch.from_numpy(_tokens(4))
    step = build_prefill(cfg, configs.ShapeConfig("t", S, B, "prefill"), mesh=(1, 4),
                         comm_mode="bulk", device="cpu")
    tp_params = shard_params(params, cfg, step.ctx)
    gather = port_ssm.gather_sequence

    def corrupt(x, ctx, **kw):
        out = gather(x, ctx, **kw).clone()
        out[2, 0, 0] += 1.0
        return out

    with mock.patch.object(port_ssm, "gather_sequence", corrupt), \
            pytest.raises(RuntimeError, match="replicated view differ"):
        step(tp_params, tokens)


# -- the specs and shard_params --------------------------------------------------------


@pytest.mark.parametrize("P", [4, 8])
def test_specs_and_shards_match_reference(P, devices8):
    """``lm_specs`` and ``lm_cache_specs`` equal the reference's at tp = P
    (once refused: the ssm block's layout waited for item 14); every leaf's
    rank slice equals the shard the reference's ``NamedSharding`` puts on
    the device of model rank r; replicated leaves are not copied."""
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
    for (path, leaf), (_, arr), sp, (_, g) in zip(
            sharded, jax.tree_util.tree_leaves_with_path(placed), leaves,
            tree_leaves_with_path(glob), strict=True):
        split = "model" in tuple(sp)
        for shard in arr.addressable_shards:
            r = rank_of[shard.device]
            mine = (leaf[:, r] if "periods" in path else leaf[r]) if split else leaf
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data), str(path))
        if not split:
            assert leaf is g, path


# -- decode ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bulk", "smi:static"])
def test_decode_ssm_matches_reference(mode, devices8):
    """Four steps of ``decode_ssm`` at tp = 4 against the reference's under
    ``shard_map``: outputs and every cache leaf (conv windows, float32
    state) within 1e-5, each rank's own slice."""
    ref_cfg, cfg = _cfgs()
    rctx = ref_make_ctx(_mesh((1, 4)), comm_mode=mode)
    pctx = make_ctx((1, 4), comm_mode=mode, device="cpu")
    np_p = jax.tree.map(np.asarray, _np_params()["stack"]["periods"][0]["ssm"])
    layer0 = jax.tree.map(lambda a: a[0], np_p)
    sp = ref_ssm.ssm_specs(ref_cfg, rctx)
    cspec = ref_ssm.ssm_cache_specs(rctx, shard_batch=False)

    def body(p, x, c):
        return ref_ssm.decode_ssm(p, x, c, ref_cfg, rctx)

    step = jax.jit(jax.shard_map(body, mesh=_mesh((1, 4)), in_specs=(sp, PS(), cspec),
                                 out_specs=(PS(), cspec), check_vma=False))
    rcache = jax.jit(jax.shard_map(lambda: ref_ssm.init_ssm_cache(ref_cfg, B, rctx, np.float32),
                                   mesh=_mesh((1, 4)), in_specs=(), out_specs=cspec,
                                   check_vma=False))()
    ports = shard_tree({k: torch.from_numpy(np.array(v)) for k, v in layer0.items()},
                       port_ssm.ssm_specs(cfg, pctx), pctx)
    pcache = port_ssm.init_ssm_cache(cfg, B, pctx, torch.float32, "cpu")
    rng = np.random.RandomState(3)
    for t in range(4):
        x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        want, rcache = step(layer0, x, rcache)
        got, pcache = port_ssm.decode_ssm(ports, torch.from_numpy(x).expand(4, B, 1, -1),
                                          pcache, cfg, pctx)
        for r in range(4):
            _close(got[r], want, f"{mode} step {t} rank {r}")
    for name, spec in cspec.items():
        want = np.asarray(rcache[name])
        d = tuple(spec).index("model") if "model" in tuple(spec) else None
        for r in range(4):
            w = want if d is None else np.split(want, 4, axis=d)[r]
            _close(pcache[name][r], w, f"cache {name} rank {r}")


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


@pytest.mark.parametrize("mode", ["smi:static", "smi:fused", "bulk"])
def test_decode_row_does_not_depend_on_its_slot(mode):
    """In bfloat16 at tp = 4, a row's logits are the same bits whichever
    slot it sits in (the batch permuted, six steps): the ``ssm.out``
    all-reduce sums every row's elements in one rank order.  The
    reference's ring, fed the flattened (B, D), sums them in an order that
    follows the slot."""
    _, cfg = _cfgs(dtype="bfloat16", d_model=128)
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


# -- the decode ledger ------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x8", "2x4"])
def test_decode_ledger_equals_prediction(mesh):
    """One continuous decode step plus one migration: the ledger equals
    ``predict_decode_step_stats(..., eager=True)`` per tag, to the byte and
    the step; ``ssm.out`` is its closed form, a ring all-reduce a layer of
    one rank's (D, B) partial in 2 (P - 1) shifts of a P-th of it; the
    migration's legs move a slot image of the reference's bytes."""
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
    chunk = -(-slots * cfg.d_model // P) * 4
    assert led.by_tag["serve.ssm.out"] == {"steps": 2 * (P - 1) * cfg.n_layers,
                                           "bytes": 2 * (P - 1) * chunk * cfg.n_layers}
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
        wave.submit(RefRequest(uid=i, prompt=list(p), max_new=4))
    return {r.uid: list(r.out) for r in wave.run(max_steps=200)}


@pytest.mark.parametrize("engine", ["wave", "continuous"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_engines_match_reference_wave_oracle(mesh, engine, devices8):
    """Both engines at tp > 1 over ``smi:static`` emit the reference's
    tp = 1 wave tokens; the continuous engine migrates a slot between two
    ticks with one tick in flight, over the pool's ``serve.migrate``."""
    _, cfg = _cfgs()
    dims = MESHES[mesh]
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
        eng.submit(Request(uid=i, prompt=list(p), max_new=4))
    done = []
    if engine == "continuous":
        done = eng.tick() + eng.tick()
        eng.migrate(0, 3, overlap_ticks=1)
    done += eng.run(max_steps=200)
    if engine == "continuous":
        eng.shutdown()
        assert rt["pool"].closed
    assert {r.uid: r.out for r in done} == _wave_oracle()


def test_serve_cli_mamba2_tensor_parallel_on_cpu(tmp_path):
    """``launch.serve --arch mamba2-2.7b --smoke --mesh 1,8`` runs both
    engines to the same tokens (once refused: item 14), and its
    ``--validate-comm`` exits 0 at (1, 8) and (2, 4) with every tag equal,
    ``serve.ssm.out`` and ``serve.migrate`` among them."""
    outs = []
    for engine in ("wave", "continuous"):
        out = tmp_path / f"{engine}.json"
        assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "1,8",
                                  "--comm-mode", "smi:static", "--engine", engine, "--json",
                                  str(out)]) == 0
        outs.append(json.loads(out.read_text())["out"])
    assert outs[0] == outs[1] and len(outs[0]) == 4
    for mesh in ("1,8", "2,4"):
        out = tmp_path / "validate.json"
        assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", mesh,
                                  "--comm-mode", "smi:static", "--validate-comm", "--json",
                                  str(out)]) == 0
        res = json.loads(out.read_text())
        assert res["predicted"] == res["measured"]
        assert {"serve.ssm.out", "serve.migrate"} <= set(res["measured"])
