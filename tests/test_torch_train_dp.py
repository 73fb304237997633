"""Training over the data axis in the port (``launch/steps.py build_train``
at ``mesh=(dp, P)``, checkpoints across meshes) against ``repro`` and
against the port's own single-group runs.

* at (2, 1) and (4, 1) the reference's ``build_train`` is the oracle (its
  data-parallel gradients are sound at tp = 1): the loss within 1e-5 and
  each gradient within 1e-4, the reference's gradients read off its first
  AdamW moment (``m = (1 - b1) g`` after one step, clipping off; its step-0
  learning rate is 0, so its parameters would not tell);
* at (2, 4) the oracle is the port's (1, 4) run on each group's rows,
  averaged (the reference's ``shard_map`` gradients over-count at tp > 1,
  ROADMAP.md §3; the MoE load-balancing loss is each group's own): FSDP for
  the six families, ``compressed_grads`` (the int8 ring on the leaves stored
  whole), ``fsdp=False``, ``shared_gather`` and ``comm_mode="bulk"``;
* a state saved at (2, 4) restores at (1, 8) and (1, 1) with the same
  loss, through ``ft.reshard_state``.

The remat policies are held in tests/test_torch_remat.py, the ledger and
the launcher at dp > 1 in tests/test_torch_train_dp_ledger.py.
"""

from __future__ import annotations

import functools

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
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_mesh
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.ft import reshard_state
from repro_torch.interop import (
    shard_train_state,
    train_state_from_reference,
    unshard_params,
    unshard_train_state,
)
from repro_torch.launch.steps import TrainSettings, build_train
from repro_torch.models.common import tree_flatten
from repro_torch.parallel import ledger

pytestmark = pytest.mark.usefixtures("one_thread")


def _one_group(cfg, batch, dp=2, **kw):
    """The oracle of a (dp, 4) step: the (1, 4) step on each group's rows,
    averaged (the whole batch's at once, but for the MoE load-balancing
    loss, which is each group's own)."""
    m = B // dp
    runs = [_grads(cfg, (1, 4), {k: v[g * m:(g + 1) * m] for k, v in batch.items()}, **kw)
            for g in range(dp)]
    loss = sum(r[0] for r in runs) / dp
    return loss, [sum(gs) / dp for gs in zip(*(tree_flatten(r[1]) for r in runs))]


# -- against the reference at tp = 1 ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_step(arch, dp, compressed):
    """The reference's first step at (dp, 1): its initial state and its
    gradients (off the first moment), as numpy, and its loss."""
    cfg = ref_configs.smoke(ref_configs.get_arch(arch))
    mesh = make_mesh((dp, 1), ("data", "model"))
    st = ref_steps.TrainSettings(comm_mode="smi:static", remat="nothing", loss_chunks=1,
                                 clip_norm=1e9, compressed_grads=compressed)
    art = ref_steps.build_train(cfg, mesh, ref_configs.ShapeConfig("t", S, B, "train"), st)
    init = jax.tree.map(np.asarray, art["init_state"](0))
    batch = {k: jnp.asarray(v) for k, v in _batch(configs.smoke(configs.get_arch(arch))).items()}
    state = jax.device_put(jax.tree.map(jnp.asarray, init), art["state_sharding"])
    new, metrics = art["step"](state, jax.device_put(batch, art["batch_sharding"]))
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(1 - 0.9), new["opt"]["m"])
    return init, grads, float(metrics["loss"])


def _port_grads(arch, dp, compressed):
    """The port's gradients at (dp, 1) from the reference's initial state,
    beside the reference's; the losses checked within 1e-5."""
    cfg = configs.smoke(configs.get_arch(arch))
    st = TrainSettings(comm_mode="smi:static", remat="nothing", loss_chunks=1,
                       compressed_grads=compressed)
    art = build_train(cfg, configs.ShapeConfig("t", S, B, "train"), st, mesh=(dp, 1),
                      device="cpu")
    init, want, want_loss = _ref_step(arch, dp, compressed)
    state = shard_train_state(train_state_from_reference(init, cfg, device="cpu"), cfg,
                              art["ctx"], art["plan"])
    for p in tree_flatten(state["params"]):
        p.requires_grad_(True)
    with ledger.capture() as led:
        loss, _, g = art["grads"](state["params"], _batch(cfg))
    assert abs(float(loss) - want_loss) <= 1e-5
    got = tree_flatten(unshard_params(g, cfg, art["ctx"], art["plan"]))
    return got, jax.tree.leaves(want), tree_flatten(art["plan"]), led


@pytest.mark.parametrize("arch, dp", [("yi-6b", 2), ("mamba2-2.7b", 2), ("yi-6b", 4)])
def test_build_train_matches_reference_at_tp1(arch, dp):
    got, want, _, _ = _port_grads(arch, dp, False)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)


def test_compressed_grads_match_reference_at_tp1():
    """mamba2's leaves stored whole ring on the int8 wire in both packages:
    within the codec's step of each other; the FSDP leaves as raw."""
    got, want, dims, led = _port_grads("mamba2-2.7b", 2, True)
    assert led.by_tag["grad"]["steps"] > 0
    for a, b, d in zip(got, want, dims, strict=True):
        tol = 1e-4 if d >= 0 else 4 * np.abs(b).max() / 127 + 1e-6
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol)


# -- (2, 4) against the port's (1, 4) on each group's rows ----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dp2_tp4_matches_one_group(arch):
    cfg = _cfg(arch)
    batch = _batch(cfg)
    l1, g1 = _one_group(cfg, batch)
    l2, g2, art, led = _grads(cfg, (2, 4), batch)
    assert art["plan"] is not None and led.by_tag["fsdp.gather"]["steps"] > 0
    assert abs(float(l2) - float(l1)) <= 1e-5
    for a, b in zip(tree_flatten(g2), g1, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch, opts", [
    ("mamba2-2.7b", dict(compressed_grads=True)),   # the int8 "grad" ring
    ("yi-6b", dict(fsdp=False)),                    # replicated weights, a bulk mean
    ("mamba2-2.7b", dict(shared_gather=True)),
    ("yi-6b", dict(comm_mode="bulk")),              # bulk gathers and means, untallied
], ids=["compressed", "nofsdp", "shared_gather", "bulk"])
def test_dp2_tp4_options_match_one_group(arch, opts):
    cfg = _cfg(arch)
    batch = _batch(cfg, seed=1)
    keep = {k: v for k, v in opts.items() if k in ("shared_gather", "comm_mode")}
    l1, g1 = _one_group(cfg, batch, **keep)
    l2, g2, art, led = _grads(cfg, (2, 4), batch, **opts)
    assert abs(float(l2) - float(l1)) <= 1e-5
    if opts.get("fsdp") is False or opts.get("comm_mode") == "bulk":
        assert "grad" not in led.by_tag and "fsdp.gather" not in led.by_tag
    if opts.get("compressed_grads"):
        assert led.by_tag["grad"]["steps"] > 0
    dims = tree_flatten(art["plan"]) if art["plan"] is not None else None
    for i, (a, b) in enumerate(zip(tree_flatten(g2), g1, strict=True)):
        ring = dims is not None and dims[i] < 0 and opts.get("compressed_grads")
        tol = 4 * float(b.abs().max()) / 127 + 1e-6 if ring else 1e-4
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


# -- checkpoints across meshes ---------------------------------------------------------------

def test_state_saved_at_2x4_restores_at_1x8_and_1x1(tmp_path):
    cfg = _cfg("yi-6b").scaled(n_heads=8)
    shape = configs.ShapeConfig("t", S, B, "train")
    st = TrainSettings(comm_mode="smi:static", loss_chunks=1, warmup_steps=1, total_steps=10)
    art = build_train(cfg, shape, st, mesh=(2, 4), device="cpu")
    state, _ = art["step"](art["init_state"](0), _batch(cfg))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(unshard_train_state(state, cfg, art["ctx"], art["plan"]), 1)
    batch = _batch(cfg, seed=9)
    losses = [float(art["grads"](state["params"], batch)[0])]
    for mesh in ((1, 8), None):
        other = build_train(cfg, shape, st, mesh=mesh, device="cpu")
        like = unshard_train_state(other["init_state"](1), cfg, other["ctx"], other["plan"])
        host, manifest = ckpt.restore(like)
        assert manifest["step"] == 1
        got = reshard_state(host, like, cfg, other["ctx"], other["plan"])
        losses.append(float(other["grads"](got["params"], batch)[0]))
        assert int(got["opt"]["step"]) == 1
    assert max(losses) - min(losses) <= 1e-5, losses
