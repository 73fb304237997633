"""The pod axis in the port (``mesh/api.py`` at three axes,
``launch/mesh.py``, the step builders and launchers at ``(pod, data,
model)``) against ``repro`` and against the port's own runs.

* **the meshes** -- ``launch.mesh`` names and sizes the reference's
  meshes (``make_mesh((2, 2, 2))`` on the host devices; the production
  layouts through stand-ins, which need 256 and 512 devices), and
  ``batch_axes_of`` agrees on both;
* **the context** -- ``make_ctx`` at three axes: ``dp`` the pod x data
  product, the ``"dp"`` communicator their torus, a two-axis mesh as
  before;
* **training at (2, 2, 1)** -- the reference's ``build_train`` is the
  oracle for the six families (its data-parallel gradients are sound at
  tp = 1): the loss within 1e-5, each gradient within 1e-4, read off its
  first AdamW moment (its step-0 learning rate is 0);
* **training at (2, 2, 2)** -- the port's (1, 2) runs on each group's rows,
  averaged, are the oracle (the reference's tensor-parallel gradients
  over-count, ROADMAP.md §3): the loss within 1e-5, gradients within 3e-4;
  the ledger equal to ``predict_train_step_stats(cfg, (4, 2))`` per tag;
* **the launchers and serving** -- ``launch.train --mesh 2,2,2
  --validate-comm`` exits 0, and both engines at (2, 2, 2) emit (4, 2)'s
  tokens.

The FSDP plan, storage and ``opt_specs`` at (2, 2, 2) and (2, 16, 16) are
held in tests/test_torch_fsdp.py.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dp_cases import ARCHS, B, S, one_thread  # noqa: F401 (the module's fixture)
from _torch_dp_cases import batch_of as _batch
from _torch_dp_cases import cfg_of as _cfg
from _torch_dp_cases import grads_on as _grads
from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro_torch import configs
from repro_torch.interop import shard_params, shard_train_state, train_state_from_reference
from repro_torch.interop import unshard_params
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import TrainSettings, build_continuous_serve, build_serve
from repro_torch.launch.steps import build_train
from repro_torch.mesh import api
from repro_torch.models import init_lm
from repro_torch.models.common import tree_flatten
from repro_torch.netsim import predict_train_step_stats
from repro_torch.parallel import ledger
from repro_torch.serving import ContinuousEngine, Request, ServeEngine

pytestmark = pytest.mark.usefixtures("one_thread")

POD = (2, 2, 2)
AXES3 = ("pod", "data", "model")


# -- the meshes ----------------------------------------------------------------------------

def test_make_mesh_names_and_sizes_the_references():
    ref = ref_mesh.make_mesh(POD, AXES3)
    shape, axes = launch_mesh.make_mesh(POD, AXES3)
    assert axes == tuple(ref.axis_names) and shape == tuple(ref.devices.shape)
    assert launch_mesh.batch_axes_of((shape, axes)) == ref_mesh.batch_axes_of(ref)
    assert launch_mesh.batch_axes_of(ref) == ("pod", "data")
    assert api.mesh_sizes(shape) == dict(zip(ref.axis_names, ref.devices.shape))
    with pytest.raises(ValueError):
        launch_mesh.make_mesh((2, 4), ("model", "data"))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_equal_the_references(monkeypatch, multi_pod):
    """The reference builds its production meshes from 256 or 512 devices:
    a stand-in of its mesh constructor records the shape and names it asks
    for, and its ``batch_axes_of`` reads the stand-in."""
    def stand_in(shape, axes):
        return SimpleNamespace(axis_names=tuple(axes), devices=SimpleNamespace(shape=shape))

    monkeypatch.setattr(ref_mesh, "_compat_make_mesh", stand_in)
    ref = ref_mesh.make_production_mesh(multi_pod=multi_pod)
    shape, axes = launch_mesh.make_production_mesh(multi_pod=multi_pod)
    assert (shape, axes) == (tuple(ref.devices.shape), tuple(ref.axis_names))
    assert shape == ((2, 16, 16) if multi_pod else (16, 16))
    assert launch_mesh.batch_axes_of((shape, axes)) == ref_mesh.batch_axes_of(ref) == \
        api.batch_axes_of(shape)


# -- the context ---------------------------------------------------------------------------

def test_make_ctx_at_three_axes():
    ctx = api.make_ctx(POD, comm_mode="smi:static", device="cpu")
    assert ctx.batch_axes == ("pod", "data") and ctx.dp == 4 and ctx.tp == 2
    assert ctx.data_comm.axis_names == ("pod", "data") and ctx.data_comm.axis_sizes == (2, 2)
    assert ctx.data_comm.size == 4 and ctx.data_comm.topology.n_ranks == 4
    two = api.make_ctx((4, 2), comm_mode="smi:static", device="cpu")
    assert two.batch_axes == ("data",) and two.dp == 4 and two.data_comm.axis_sizes == (4,)
    assert api.make_ctx((1, 2), comm_mode="smi:static", device="cpu").data_comm is None
    assert api.check_fsdp(True, (2, 1, 2), 1) and not api.check_fsdp(True, (1, 1, 2), 1)
    with pytest.raises(ValueError):
        api.make_ctx((2, 2, 2, 2), device="cpu")


# -- training at (2, 2, 1) against the reference -------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_step(arch):
    """The reference's first step at (2, 2, 1) on the smoke config: its
    initial state and gradients (off the first moment) as numpy, its loss."""
    cfg = ref_configs.smoke(ref_configs.get_arch(arch))
    mesh = ref_mesh.make_mesh((2, 2, 1), AXES3)
    st = ref_steps.TrainSettings(comm_mode="smi:static", remat="nothing", loss_chunks=1,
                                 clip_norm=1e9)
    art = ref_steps.build_train(cfg, mesh, ref_configs.ShapeConfig("t", S, B, "train"), st)
    init = jax.tree.map(np.asarray, art["init_state"](0))
    batch = {k: jnp.asarray(v) for k, v in _batch(configs.smoke(configs.get_arch(arch))).items()}
    state = jax.device_put(jax.tree.map(jnp.asarray, init), art["state_sharding"])
    new, metrics = art["step"](state, jax.device_put(batch, art["batch_sharding"]))
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(1 - 0.9), new["opt"]["m"])
    return init, grads, float(metrics["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_at_2x2x1_matches_reference(arch):
    cfg = configs.smoke(configs.get_arch(arch))
    st = TrainSettings(comm_mode="smi:static", remat="nothing", loss_chunks=1)
    art = build_train(cfg, configs.ShapeConfig("t", S, B, "train"), st, mesh=(2, 2, 1),
                      device="cpu")
    assert art["ctx"].dp == 4 and art["plan"] is not None
    init, want, want_loss = _ref_step(arch)
    state = shard_train_state(train_state_from_reference(init, cfg, device="cpu"), cfg,
                              art["ctx"], art["plan"])
    for p in tree_flatten(state["params"]):
        p.requires_grad_(True)
    with ledger.capture() as led:
        loss, _, g = art["grads"](state["params"], _batch(cfg))
    assert led.by_tag["fsdp.gather"]["steps"] > 0
    assert abs(float(loss) - want_loss) <= 1e-5
    got = tree_flatten(unshard_params(g, cfg, art["ctx"], art["plan"]))
    for a, b in zip(got, jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)


# -- training at (2, 2, 2) against the port's own (1, 2) runs -------------------------------

def _one_group(cfg, batch, dp=4):
    """The oracle of a (pod, data, 2) step of ``dp`` groups: the (1, 2) step
    on each group's rows, averaged."""
    m = B // dp
    runs = [_grads(cfg, (1, 2), {k: v[g * m:(g + 1) * m] for k, v in batch.items()})
            for g in range(dp)]
    loss = sum(r[0] for r in runs) / dp
    return loss, [sum(gs) / dp for gs in zip(*(tree_flatten(r[1]) for r in runs))]


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b", "qwen3-moe-30b-a3b"])
def test_2x2x2_matches_the_groups_at_1x2(arch):
    cfg = _cfg(arch)
    batch = _batch(cfg, seed=2)
    l1, g1 = _one_group(cfg, batch)
    l2, g2, art, led = _grads(cfg, POD, batch)
    assert art["plan"] is not None and led.by_tag["fsdp.gather"]["steps"] > 0
    assert abs(float(l2) - float(l1)) <= 1e-5
    for a, b in zip(tree_flatten(g2), g1, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-4)


@pytest.mark.parametrize("arch, compressed", [("yi-6b", False), ("mamba2-2.7b", False),
                                              ("mamba2-2.7b", True), ("qwen3-moe-30b-a3b", False)])
def test_ledger_at_2x2x2_equals_prediction_at_4x2(arch, compressed):
    """The ``"dp"`` torus carries the rings of a four-rank data axis: every
    tag of a step, ``fsdp.gather`` and ``grad`` included, equals the
    prediction at (4, 2)."""
    cfg = _cfg(arch)
    st = TrainSettings(comm_mode="smi:static", loss_chunks=1, compressed_grads=compressed)
    shape = configs.ShapeConfig("t", S, B, "train")
    art = build_train(cfg, shape, st, mesh=POD, device="cpu")
    with ledger.capture() as led:
        art["step"](art["init_state"](0), _batch(cfg))
    got = {t: dict(e) for t, e in led.by_tag.items()}
    assert got == predict_train_step_stats(cfg, (4, 2), shape, st, eager=True)
    assert "fsdp.gather" in got


def test_launcher_trains_and_validates_at_2x2x2(capsys):
    base = ["--device", "cpu", "--smoke", "--seq-len", "32", "--batch", "4", "--mesh", "2,2,2",
            "--comm-mode", "smi:fused"]
    assert launch_train.main(base + ["--steps", "2"]) == 0
    assert launch_train.main(base + ["--validate-comm"]) == 0
    out = capsys.readouterr().out
    assert "[validate-comm] ok" in out and "mesh=2,2,2" in out and "fsdp.gather" in out


# -- serving over the pod axis ---------------------------------------------------------------

def _requests(cfg, n=3):
    rng = np.random.RandomState(4)
    return [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 4).tolist(), max_new=3)
            for i in range(n)]


@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_serving_at_2x2x2_equals_4x2(engine):
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    out = {}
    for mesh in (POD, (4, 2)):
        if engine == "wave":
            rt = build_serve(cfg, configs.ShapeConfig("s", 32, 4, "decode"), mesh=mesh,
                             comm_mode="smi:static", fsdp=True, device="cpu")
            cls = ServeEngine
        else:
            rt = build_continuous_serve(cfg, mesh=mesh, comm_mode="smi:static", batch_slots=2,
                                        capacity=32, fsdp=True, device="cpu")
            cls = ContinuousEngine
        assert rt["plan"] is not None and rt["ctx"].dp == 4
        params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=rt["ctx"])
        eng = cls(cfg, shard_params(params, cfg, rt["ctx"], rt["plan"]), runtime=rt)
        for r in _requests(cfg):
            eng.submit(r)
        with ledger.capture() as led:
            done = eng.run(max_steps=64)
        if engine == "continuous":
            eng.shutdown()
        assert "fsdp.gather" in led.by_tag
        out[mesh] = {r.uid: r.out for r in done}
    assert out[POD] == out[(4, 2)] and len(out[POD]) == 3
