"""FSDP over the data axis in the port (``repro_torch.mesh.api``,
``parallel/layers.py``, ``interop.py``, ``optim/adamw.py``) against
``repro``.

* **the plan** -- ``build_fsdp_plan``, ``fsdp_storage_specs`` and
  ``opt_specs`` equal the reference's leaf for leaf, for the six model
  families at full size on (2, 4), (4, 2), (2, 1) and (8, 1);
* **the rings** -- ``fsdp_allgather`` and ``grad_allreduce`` over the
  ``"dp"`` communicator equal the reference's under ``shard_map`` on the
  static wire (its fused and packet wires fail under ``shard_map`` on jax
  0.9.0): bit for bit on the raw wire, within the int8 codec's bound on
  the compressed one, with equal steps and bytes;
* **storage** -- the reference's params as numpy become the port's
  FSDP-stored params at (2, 4) and come back unchanged, and a gather at tp
  > 1 tallies one device's bytes;
* **serving on FSDP weights** -- both engines give the tokens of the
  replicated weights at (2, 4);
* **the reference's faults** -- its ``"auto"`` switch counts qwen3-moe's
  parameters in int32 (4.763 B for 30.53 B), and its continuous runtime
  serves FSDP weights ungathered: two tests pin both, so that a fix there
  is flagged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)
from repro import configs as ref_configs
from repro.core import Communicator as RefComm
from repro.core import make_test_mesh, run_spmd
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_mesh
from repro.mesh import api as ref_api
from repro.models import init_lm as ref_init_lm
from repro.models import lm_specs as ref_lm_specs
from repro.optim.adamw import opt_specs as ref_opt_specs
from repro.parallel import fsdp_allgather as ref_fsdp_allgather
from repro.parallel import grad_allreduce as ref_grad_allreduce
from repro.parallel import ledger as ref_ledger
from repro_torch import configs
from repro_torch.core import Communicator
from repro_torch.interop import params_from_reference, shard_params, unshard_params
from repro_torch.launch.steps import build_continuous_serve, build_serve
from repro_torch.mesh import api
from repro_torch.models import init_lm, lm_specs, param_shapes
from repro_torch.models.common import tree_flatten
from repro_torch.optim import opt_specs
from repro_torch.parallel import fsdp_allgather, grad_allreduce, ledger
from repro_torch.serving import ContinuousEngine, Request, ServeEngine

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ("yi-6b", "mamba2-2.7b", "qwen3-moe-30b-a3b", "recurrentgemma-9b", "internvl2-1b",
         "musicgen-medium")
MESHES = ((2, 4), (4, 2), (2, 1), (8, 1))


@functools.lru_cache(maxsize=None)
def _ref_layout(arch, mesh):
    """The reference's global param shapes, model specs and FSDP plan of
    ``arch`` at full size on ``mesh``."""
    cfg = ref_configs.get_arch(arch)
    m = make_mesh(mesh, ("data", "model"))
    ctx = ref_api.make_ctx(m, comm_mode="smi:static")
    shapes = jax.eval_shape(lambda: ref_init_lm(jax.random.PRNGKey(0), cfg, ctx))
    specs = ref_lm_specs(cfg, ctx)
    plan = ref_api.build_fsdp_plan(shapes, specs, m, ("data",))
    return m, shapes, specs, plan


def _spec_list(tree):
    is_spec = (lambda x: isinstance(x, JP))
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=is_spec)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_storage_and_opt_specs_equal_reference(arch, mesh):
    m, ref_shapes, ref_specs, ref_plan = _ref_layout(arch, mesh)
    cfg = configs.get_arch(arch)
    ctx = api.make_ctx(mesh, comm_mode="smi:static", device="cpu")
    shapes, specs = param_shapes(cfg, ctx), lm_specs(cfg, ctx)
    assert [tuple(t.shape) for t in tree_flatten(shapes)] == \
        [tuple(t.shape) for t in jax.tree.leaves(ref_shapes)]
    plan = api.build_fsdp_plan(shapes, specs, mesh, ctx.batch_axes)
    assert tree_flatten(plan) == jax.tree.leaves(ref_plan)
    got = [tuple(s) for s in tree_flatten(api.fsdp_storage_specs(specs, plan, ("data",)))]
    assert got == _spec_list(ref_api.fsdp_storage_specs(ref_specs, ref_plan, ("data",)))
    got = opt_specs(specs, mesh, shapes)
    want = ref_opt_specs(ref_specs, m, ref_shapes)
    assert [tuple(s) for s in tree_flatten(got["m"])] == _spec_list(want["m"])
    assert tuple(got["step"]) == tuple(want["step"])


# -- the rings over the data axis ----------------------------------------------------------

def _dp_comms(dp):
    return (RefComm.create("data", (dp,), name="dp"),
            Communicator.create("data", (dp,), name="dp", device="cpu"))


def _ref_run(fn, dp, x):
    mesh = make_test_mesh((dp,), ("data",))
    with ref_ledger.capture() as led:
        out = np.asarray(run_spmd(lambda v: fn(v[0])[None], mesh, (JP("data"),), JP("data"), x))
    return out, {t: dict(e) for t, e in led.by_tag.items()}


@pytest.mark.parametrize("dp, shape, dim", [(2, (6, 4), 0), (4, (3, 8, 5), 1), (8, (2, 3, 8), 2)])
def test_fsdp_allgather_equals_reference(dp, shape, dim):
    rc, pc = _dp_comms(dp)
    blocks = np.random.RandomState(dp).randn(dp, *shape).astype(np.float32)
    want, ref_tags = _ref_run(lambda b: ref_fsdp_allgather(b, rc, dim), dp, blocks)
    with ledger.capture() as led:
        got = fsdp_allgather(torch.from_numpy(blocks), pc, dim)
    assert np.array_equal(got.numpy(), want)
    assert {t: dict(e) for t, e in led.by_tag.items()} == ref_tags


@pytest.mark.parametrize("wire", ["raw", "int8"])
@pytest.mark.parametrize("dp, n", [(2, 1280), (4, 1001), (8, 37)])
def test_grad_allreduce_equals_reference(dp, n, wire):
    """Sizes that do not split into ``dp`` chunks pad; the int8 wire's
    result stays within the codec's step of the reference's (XLA fuses its
    dequantise into the add, the port rounds apart, ROADMAP.md §3)."""
    rc, pc = _dp_comms(dp)
    g = np.random.RandomState(n).randn(dp, n).astype(np.float32)
    want, ref_tags = _ref_run(lambda v: ref_grad_allreduce(v, rc, wire=wire), dp, g)
    with ledger.capture() as led:
        got = grad_allreduce(torch.from_numpy(g), pc, wire=wire)
    assert {t: dict(e) for t, e in led.by_tag.items()} == ref_tags
    if wire == "raw":
        assert np.array_equal(got.numpy(), want)
    else:
        step = np.abs(g).max() / 127.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * dp * step)
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(g.sum(0), g.shape), rtol=0,
                                   atol=4 * dp * step)


@pytest.mark.parametrize("compressed", [False, True])
def test_grad_sync_rings_each_model_rank(compressed):
    """A leaf rank-stacked over the model axis and stored whole on the data
    axis rings each model rank's block on its own (as each device does):
    the ledger tallies one device's steps and bytes, those of the
    prediction's ``grad`` row."""
    ctx = api.make_ctx((2, 4), comm_mode="smi:static", device="cpu")
    g = torch.from_numpy(np.random.RandomState(3).randn(2, 5, 4, 64).astype(np.float32))
    specs = {"periods": (api.PartitionSpec(None, "model"),)}
    with ledger.capture() as led:
        out = api.grad_sync({"periods": (g,)}, ctx, compressed=compressed, specs=specs)
    got = out["periods"][0]
    want = (g.sum(0, keepdim=True) / 2).expand_as(g)
    torch.testing.assert_close(got, want, rtol=0, atol=0 if not compressed else 0.05)
    with ledger.capture() as one:
        grad_allreduce(g[:, :, 0], ctx.data_comm, wire="int8" if compressed else "raw")
    assert led.by_tag == one.by_tag


# -- storage -------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b", "qwen3-moe-30b-a3b"])
def test_reference_params_round_trip_through_fsdp_storage(arch):
    ref_cfg = ref_configs.smoke(ref_configs.get_arch(arch))
    cfg = configs.smoke(configs.get_arch(arch))
    m = make_mesh((2, 4), ("data", "model"))
    rctx = ref_api.make_ctx(m, comm_mode="smi:static")
    ref = jax.tree.map(np.asarray, ref_init_lm(jax.random.PRNGKey(1), ref_cfg, rctx))
    ctx = api.make_ctx((2, 4), comm_mode="smi:static", device="cpu")
    plan = api.build_fsdp_plan(param_shapes(cfg, ctx), lm_specs(cfg, ctx), (2, 4))
    assert tree_flatten(plan) == jax.tree.leaves(
        ref_api.build_fsdp_plan(jax.tree.map(jnp.asarray, ref), ref_lm_specs(ref_cfg, rctx),
                                m, ("data",)))
    stored = shard_params(params_from_reference(ref, cfg, device="cpu"), cfg, ctx, plan)
    for leaf, dim in zip(tree_flatten(stored), tree_flatten(plan)):
        assert dim < 0 or 2 in tuple(leaf.shape)[:2]
    back = unshard_params(stored, cfg, ctx, plan)
    for a, b in zip(tree_flatten(back), jax.tree.leaves(ref)):
        assert np.array_equal(a.numpy(), b)


def test_fsdp_gather_tallies_one_device():
    """At tp = 4 a block carries four model ranks' shares: the gather's
    steps and bytes are one device's, as the prediction counts them."""
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    ctx = api.make_ctx((2, 4), comm_mode="smi:static", device="cpu")
    specs = lm_specs(cfg, ctx)
    plan = api.build_fsdp_plan(param_shapes(cfg, ctx), specs, (2, 4))
    stored = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=ctx), cfg,
                          ctx, plan)
    with ledger.capture() as led:
        got = api.fsdp_gather({"embed": stored["embed"]}, {"embed": plan["embed"]}, ctx,
                              {"embed": specs["embed"]})
    V, D = cfg.padded_vocab, cfg.d_model
    assert led.by_tag["fsdp.gather"] == {"steps": 1, "bytes": V // 4 * D // 2 * 4}
    full = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=ctx), cfg, ctx)
    assert torch.equal(got["embed"], full["embed"])


# -- serving on FSDP weights ----------------------------------------------------------------

def _requests(cfg, n=3):
    rng = np.random.RandomState(0)
    return [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 4).tolist(), max_new=3)
            for i in range(n)]


@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_serving_on_fsdp_weights_equals_replicated(engine):
    cfg = configs.smoke(configs.get_arch("yi-6b")).scaled(n_heads=8)
    out = {}
    for fsdp in (True, False):
        if engine == "wave":
            rt = build_serve(cfg, configs.ShapeConfig("s", 32, 2, "decode"), mesh=(2, 4),
                             comm_mode="smi:static", fsdp=fsdp, device="cpu")
            cls = ServeEngine
        else:
            rt = build_continuous_serve(cfg, mesh=(2, 4), comm_mode="smi:static",
                                        batch_slots=2, capacity=32, fsdp=fsdp, device="cpu")
            cls = ContinuousEngine
        assert (rt["plan"] is not None) == fsdp
        params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=rt["ctx"])
        eng = cls(cfg, shard_params(params, cfg, rt["ctx"], rt["plan"]), runtime=rt)
        for r in _requests(cfg):
            eng.submit(r)
        with ledger.capture() as led:
            done = eng.run(max_steps=64)
        if engine == "continuous":
            eng.shutdown()
        out[fsdp] = {r.uid: r.out for r in done}
        assert ("fsdp.gather" in led.by_tag) == fsdp
    assert out[True] == out[False] and len(out[True]) == 3


# -- the reference's faults ----------------------------------------------------------------

def test_reference_fault_auto_switch_counts_in_int32():
    """The reference's ``"auto"`` rule sums ``jnp.prod(jnp.asarray(shape))``
    in int32: qwen3-moe's expert leaves wrap, its count is 4.763 B, and
    its rule leaves the weights replicated at (2, 4); the port counts 30.53
    B from the config and shards them."""
    _, shapes, _, _ = _ref_layout("qwen3-moe-30b-a3b", (2, 4))
    ref_total = sum(int(jnp.prod(jnp.asarray(l.shape))) for l in jax.tree.leaves(shapes))
    true_total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(shapes))
    assert abs(ref_total - 4.763e9) < 1e6 and abs(true_total - 30.53e9) < 1e7
    assert not (ref_total / 4) * 2 > 10e9
    assert api.check_fsdp("auto", (2, 4), configs.get_arch("qwen3-moe-30b-a3b").param_count())


def test_reference_fault_continuous_runtime_serves_fsdp_ungathered():
    """The reference's continuous runtime makes its context without batch
    axes, so ``fsdp_gather`` hands back the shards: one decode step's
    logits on FSDP weights differ from replicated weights' (the port's
    equal them, above)."""
    cfg = ref_configs.smoke(ref_configs.get_arch("yi-6b"))
    mesh = make_mesh((2, 4), ("data", "model"))
    logits = {}
    for fsdp in (True, False):
        rt = ref_steps.build_continuous_serve(cfg, mesh, comm_mode="smi:static", batch_slots=2,
                                              capacity=32, fsdp=fsdp)
        ctx = ref_api.make_ctx(mesh, comm_mode="smi:static")
        params = jax.device_put(jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype ==
                                             jnp.float32 else a,
                                             ref_init_lm(jax.random.PRNGKey(0), cfg, ctx)),
                                rt["param_sharding"])
        out, _ = rt["step"](params, rt["init_caches"](), jnp.array([3, 5], jnp.int32),
                            jnp.zeros((2,), jnp.int32))
        if rt["pool"] is not None:
            rt["pool"].close()
        logits[fsdp] = np.asarray(out, dtype=np.float32)
    assert np.abs(logits[True] - logits[False]).max() > 0.1
