"""The port's training over the model axis on the CPU (smoke configs,
float32): its tensor-parallel gradients against its own tp = 1 gradients,
the rank-stack layout of params and gradients, and the training ledger.

* The gradients at (1, 4) and (1, 8), unsharded, against tp = 1's
  (``shared_gather`` and ``ring_attn`` included, every family), within
  1e-4 relative Frobenius error, the loss within 1e-5.  They are not held
  against the reference's ``shard_map`` gradients, which over-count
  (``tests/test_torch_train.py::test_reference_tp_gradients_overcount``);
  tp = 1's are held against the reference's ``jax.grad`` there.
* ``shard_tree`` and ``unshard_tree`` inverse to each other at P = 4 and 8
  on every family's params.
* The training ledger against ``predict_train_step_stats(eager=True)``
  with remat on and off; ``eager=False`` equal to the reference's
  prediction, dict for dict.
"""

import pytest
import torch

from repro import configs as ref_configs
from repro.launch.steps import TrainSettings as RefTrainSettings
from repro.netsim import predict_train_step_stats as ref_predict
from repro_torch import configs
from repro_torch.interop import shard_params, shard_tree, unshard_tree
from repro_torch.launch.steps import TrainSettings
from repro_torch.mesh.api import make_ctx
from repro_torch.models import init_lm, lm_specs
from repro_torch.models.common import tree_leaves_with_path, tree_map
from repro_torch.netsim import predict_train_step_stats
from repro_torch.parallel import ledger

from _torch_train_cases import ARCHS, GRAD_TOL, LOSS_TOL, B, S
from _torch_train_cases import cfgs as _cfgs
from _torch_train_cases import inputs as _inputs
from _torch_train_cases import port_grads as _port_grads
from _torch_train_cases import rel as _rel

TP_CASES = [("yi-6b", 4, "smi:static", "nothing", 2, {}),
            ("yi-6b", 8, "smi:fused", "none", 1, {"opt_shared_gather": True}),
            ("yi-6b", 4, "smi:static", "nothing", 2, {"opt_ring_attn": True}),
            ("mamba2-2.7b", 4, "smi:fused", "none", 1, {}),
            ("mamba2-2.7b", 8, "smi:static", "nothing", 2, {"opt_shared_gather": True}),
            ("qwen3-moe-30b-a3b", 4, "smi:static", "nothing", 2, {}),
            ("qwen3-moe-30b-a3b", 8, "smi:fused", "nothing", 1, {}),
            ("recurrentgemma-9b", 8, "smi:fused", "nothing", 1, {}),
            ("internvl2-1b", 8, "bulk", "nothing", 2, {}),
            ("musicgen-medium", 4, "smi:fused", "nothing", 2, {})]


@pytest.mark.parametrize("arch,P,mode,remat,chunks,opts", TP_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}{''.join('-' + k for k in c[5])}"
                              for c in TP_CASES])
def test_tp_grads_match_tp1(arch, P, mode, remat, chunks, opts):
    """At (1, P) the loss (rank 0's copy) and every leaf's gradient,
    unsharded, equal tp = 1's: a replicated leaf, stored once, gathers every
    rank's share; the loss is backpropagated once, not once a rank."""
    _, cfg = _cfgs(arch, P)
    tok, lab, extra = _inputs(cfg, seed=1)
    ctx = make_ctx((1, P), comm_mode=mode, device="cpu", **opts)
    glob = init_lm(cfg, torch.Generator().manual_seed(3), "cpu", ctx=ctx)
    want_loss, want = _port_grads(tree_map(torch.clone, glob), tok, lab, extra, cfg,
                                  make_ctx(device="cpu"), remat=remat, loss_chunks=chunks)
    got_loss, got = _port_grads(shard_params(glob, cfg, ctx), tok, lab, extra, cfg, ctx,
                                remat=remat, loss_chunks=chunks)
    assert abs(got_loss - want_loss) <= LOSS_TOL * max(1.0, abs(want_loss))
    for (path, g), (_, w) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        assert g.shape == w.shape, path
        assert _rel(g.numpy(), w.numpy()) <= GRAD_TOL, (path, _rel(g.numpy(), w.numpy()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("P", [4, 8])
def test_shard_and_unshard_are_inverse(arch, P):
    _, cfg = _cfgs(arch, P)
    ctx = make_ctx((1, P), comm_mode="smi:static", device="cpu")
    glob = init_lm(cfg, torch.Generator().manual_seed(4), "cpu", ctx=ctx)
    specs = lm_specs(cfg, ctx)
    sharded = shard_tree(glob, specs, ctx)
    back = unshard_tree(sharded, specs, ctx)
    again = shard_tree(back, specs, ctx)
    for (path, a), (_, b) in zip(tree_leaves_with_path(back), tree_leaves_with_path(glob)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(tree_leaves_with_path(again), tree_leaves_with_path(sharded)):
        assert torch.equal(a, b), path
    assert any(a.shape != b.shape for (_, a), (_, b) in
               zip(tree_leaves_with_path(sharded), tree_leaves_with_path(glob)))


# -- the ledger of a training step --------------------------------------------------

LEDGER_CASES = [("yi-6b", 4, "smi:static", "nothing", 2, {}),
                ("yi-6b", 4, "smi:fused", "none", 1, {}),
                ("yi-6b", 8, "smi:static", "nothing", 2, {"shared_gather": True}),
                ("yi-6b", 4, "smi:static", "nothing", 1, {"ring_attn": True}),
                ("mamba2-2.7b", 4, "smi:fused", "nothing", 2, {}),
                ("qwen3-moe-30b-a3b", 4, "smi:static", "nothing", 2, {}),
                ("recurrentgemma-9b", 8, "smi:static", "nothing", 1, {}),
                ("musicgen-medium", 4, "smi:static", "none", 2, {})]


@pytest.mark.parametrize("arch,P,mode,remat,chunks,opts", LEDGER_CASES)
def test_train_ledger_equals_eager_prediction(arch, P, mode, remat, chunks, opts):
    """One training step (forward and backward) under a ledger capture:
    every tag's steps and bytes equal ``predict_train_step_stats(...,
    eager=True)``; a remat recompute tallies nothing (nor does the
    backward)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_train

    _, cfg = _cfgs(arch, P)
    st = TrainSettings(comm_mode=mode, remat=remat, loss_chunks=chunks, **opts)
    shape = ShapeConfig("t", S, B, "train")
    art = build_train(cfg, shape, st, mesh=(1, P), device="cpu")
    tok, lab, extra = _inputs(cfg, seed=5)
    batch = {"tokens": tok, "labels": lab}
    if extra is not None:
        batch["pixel_embeds"] = extra
    with ledger.capture() as led:
        art["grads"](art["init_params"](0), batch)
    want = predict_train_step_stats(cfg, (1, P), shape, st, eager=True)
    assert {t: dict(e) for t, e in led.by_tag.items()} == want
    assert want and all(e["steps"] > 0 for e in want.values())


def test_train_ledger_packet_at_a_data_axis(monkeypatch):
    """The packet wire at (2, 4), one layer and 8 tokens (the smallest cut
    that shows an over-count): an FSDP block stacked over the model ranks
    routes one device's share a router job, so every tag, ``fsdp.gather``
    among them, equals ``predict_train_step_stats(eager=True)``; every
    gathered leaf is bit-equal to ``smi:static``'s."""
    import repro_torch.parallel as par
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_train

    _, cfg = _cfgs("yi-6b", 4)
    cfg = cfg.scaled(n_layers=1)
    shape = ShapeConfig("t", 8, B, "train")
    tok, lab, _ = _inputs(cfg, seed=5)
    batch = {"tokens": tok[:, :8], "labels": lab[:, :8]}
    gathers, inner = {}, par.fsdp_allgather

    def recorded(mode):
        def fsdp_allgather(*a, **kw):
            out = inner(*a, **kw)
            gathers.setdefault(mode, []).append(out.detach().clone())
            return out
        return fsdp_allgather

    for mode in ("smi:packet", "smi:static"):
        monkeypatch.setattr(par, "fsdp_allgather", recorded(mode))
        st = TrainSettings(comm_mode=mode, remat="nothing", loss_chunks=1)
        art = build_train(cfg, shape, st, mesh=(2, 4), device="cpu")
        with ledger.capture() as led:
            art["grads"](art["init_params"](0), batch)
        want = predict_train_step_stats(cfg, (2, 4), shape, st, eager=True)
        assert {t: dict(e) for t, e in led.by_tag.items()} == want, mode
    assert want["fsdp.gather"]["steps"] > 0
    assert len(gathers["smi:packet"]) == len(gathers["smi:static"]) > 0
    for a, b in zip(gathers["smi:packet"], gathers["smi:static"]):
        assert torch.equal(a, b)


PREDICT_CASES = [(a, P, mode, opts) for a in ARCHS for P in (1, 4, 8)
                 for mode, opts in (("smi:static", {}), ("smi:packet", {"shared_gather": True}),
                                    ("smi:compressed", {"ring_attn": True}))]


@pytest.mark.parametrize("arch,P,mode,opts", PREDICT_CASES)
def test_predict_train_step_stats_equals_reference(arch, P, mode, opts):
    """``eager=False`` is the reference's function (its traced table), dict
    for dict, at a data axis of one rank; ``eager=True`` multiplies each
    per-block tag by its layers."""
    ref_cfg, cfg = _cfgs(arch)
    rs = ref_configs.ShapeConfig("t", 64, 2, "train")
    shape = configs.ShapeConfig("t", 64, 2, "train")
    st = TrainSettings(comm_mode=mode, loss_chunks=2, **opts)
    ref_st = RefTrainSettings(comm_mode=mode, loss_chunks=2, **opts)
    got = predict_train_step_stats(cfg, (1, P), shape, st)
    assert got == ref_predict(ref_cfg, (1, P), rs, ref_st)
    eager = predict_train_step_stats(cfg, (1, P), shape, st, eager=True)
    assert set(eager) == set(got)
    if P > 1 and cfg.n_layers > len(cfg.pattern):
        assert any(eager[t]["bytes"] > got[t]["bytes"] for t in got)


def test_predict_train_step_stats_refuses_a_data_axis():
    """A data axis (once refused) adds the FSDP gathers and the gradient
    ring: the traced table equals the reference's at (2, 4), and the eager
    one counts a gather a layer."""
    ref_cfg, cfg = _cfgs("yi-6b")
    shape = configs.ShapeConfig("t", 64, 4, "train")
    got = predict_train_step_stats(cfg, (2, 4), shape, TrainSettings())
    assert got == ref_predict(ref_cfg, (2, 4), ref_configs.ShapeConfig("t", 64, 4, "train"),
                              RefTrainSettings())
    assert got["fsdp.gather"]["steps"] > 0
    eager = predict_train_step_stats(cfg, (2, 4), shape, TrainSettings(), eager=True)
    assert eager["fsdp.gather"]["steps"] > got["fsdp.gather"]["steps"]
