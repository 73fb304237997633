"""The port's training driver on the CPU against the reference's: the
optimiser, the synthetic pipeline, ``train_loop``, checkpoints, fault
tolerance and the launcher.

* ``adamw_update``, ``clip_by_global_norm``, ``cosine_warmup`` and
  ``ErrorFeedback``'s arithmetic against the reference's, within 1e-6.
* ``SyntheticTokenPipeline``'s batches equal to the reference's, bit for
  bit (codebooks included).
* 6 steps of ``train_loop`` at tp = 1 from the reference's initial state
  against the reference's ``train_loop`` on a (1, 1) mesh: losses within
  1e-4; the same 6 steps at (1, 4) against the port's tp = 1 history (the
  other families in tests/test_torch_train_families.py).
* Checkpoints in the reference's layout (``step_<N>/manifest.json`` and
  ``arrays.npz``, leaves in ``jax.tree.flatten``'s order, saved global at
  any tp): the round trip through ``reshard_state``, each package reading
  the other's, ``keep``, and a restart through ``run_with_restarts``.
* The watchdog on a scripted clock, ``best_mesh_shape`` and
  ``elastic_restart_plan`` against the reference's.
* ``launch.train`` on the CPU (``--smoke``, ``--mesh 1,4``, ``2,4``,
  ``--validate-comm``), ``ErrorFeedback.sync`` over a data ring, and the
  remat policies that save the products (once refused) equal to
  ``"none"``.
"""

import functools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline
from repro.ft import elastic as ref_elastic
from repro.ft import watchdog as ref_watchdog
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.launch.mesh import make_mesh
from repro.optim import ErrorFeedback as RefEF
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import cosine_warmup as ref_cosine
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.ft import elastic, watchdog
from repro_torch.ft import best_mesh_shape, elastic_restart_plan, reshard_state, run_with_restarts
from repro_torch.interop import shard_train_state, train_state_from_reference
from repro_torch.interop import train_state_to_numpy, unshard_train_state
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import TrainSettings, build_train
from repro_torch.mesh.api import make_ctx
from repro_torch.models import lm_loss
from repro_torch.models.common import tree_flatten, tree_map
from repro_torch.optim import ErrorFeedback, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim import cosine_warmup

TOL = 1e-6
B, S, STEPS = 2, 32, 6


def _tree(seed):
    """A small params-like tree of float32 numpy leaves (dicts and a
    tuple)."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
            "stack": ({"k": rng.randn(2, 5).astype(np.float32)},
                      {"k": rng.randn(5).astype(np.float32)})}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _close(got, want, tol=TOL):
    g = [np.asarray(t) for t in tree_flatten(tree_map(lambda t: t.numpy(), got))]
    w = [np.asarray(a) for a in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


# -- the optimiser ----------------------------------------------------------------------

def test_adamw_matches_reference():
    """Three AdamW steps on the same params and gradients, at the rates of
    the schedule: params, moments and step within 1e-6 (the port updates
    in place)."""
    params = _tree(0)
    ref_p, ref_opt = jax.tree.map(jnp.asarray, params), ref_adamw_init(params)
    p, opt = _torch(params), adamw_init(_torch(params))
    for k in range(3):
        grads = _tree(10 + k)
        lr = 3e-3 * (k + 1)
        ref_p, ref_opt = ref_adamw_update(ref_p, jax.tree.map(jnp.asarray, grads), ref_opt,
                                          lr=jnp.float32(lr))
        out = adamw_update(p, _torch(grads), opt, lr=torch.tensor(lr, dtype=torch.float32))
        assert out[0] is p and out[1] is opt
    _close(p, ref_p)
    _close(opt["m"], ref_opt["m"])
    _close(opt["v"], ref_opt["v"])
    assert int(opt["step"]) == int(ref_opt["step"]) == 3 and opt["step"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in tree_flatten(opt["m"]))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(3)
    want, want_norm = ref_clip(jax.tree.map(jnp.asarray, grads), max_norm)
    got, norm = clip_by_global_norm(_torch(grads), max_norm)
    assert abs(float(norm) - float(want_norm)) <= TOL * float(want_norm)
    _close(got, want)


def test_cosine_warmup_matches_reference():
    for step in range(0, 24):
        kw = dict(base_lr=3e-4, warmup_steps=5, total_steps=17)
        want = float(ref_cosine(jnp.int32(step), **kw))
        got = float(cosine_warmup(torch.tensor(step, dtype=torch.int32), **kw))
        assert abs(got - want) <= TOL * 3e-4, step


def test_error_feedback_matches_reference():
    """Two rounds of correct, lossy sync (rounded to quarters) and roll:
    the synced grads and the residual state equal the reference's."""
    grads = [_tree(20), _tree(21)]
    ref_state, state = RefEF.init(grads[0]), ErrorFeedback.init(_torch(grads[0]))
    for g in grads:
        ref_synced, ref_state = RefEF.sync(
            ref_state, jax.tree.map(jnp.asarray, g),
            lambda t: jax.tree.map(lambda x: jnp.round(x * 4) / 4, t))
        synced, state = ErrorFeedback.sync(state, _torch(g),
                                           lambda t: tree_map(lambda x: (x * 4).round() / 4, t))
        _close(synced, ref_synced)
        _close(state, ref_state)
    # over a data ring: each tensor rings over a fresh "grad" channel
    from repro_torch.core import Communicator

    comm = Communicator.create("data", (2,), name="dp", device="cpu")
    stack = tree_map(lambda t: torch.stack([t, 2 * t]), _torch(grads[0]))
    ef0 = ErrorFeedback.init(stack)
    raw, res = ErrorFeedback.sync(ef0, stack, comm=comm, wire="raw")
    tree_map(lambda s, t: torch.testing.assert_close(s, (t[:1] + t[1:]).expand_as(t),
                                                     rtol=0, atol=0), raw, stack)
    tree_map(lambda s, t, r: torch.testing.assert_close(r, t - s, rtol=0, atol=0), raw, stack,
             res)
    q, res = ErrorFeedback.sync(ef0, stack, comm=comm)
    tree_map(lambda s, t, r: torch.testing.assert_close(r, t - s, rtol=0, atol=0), q, stack, res)
    tree_map(lambda s, t: torch.testing.assert_close(s, (t[:1] + t[1:]).expand_as(t),
                                                     rtol=0.05, atol=0.05), q, stack)
    with pytest.raises(ValueError, match="sync_fn or comm"):
        ErrorFeedback.sync(state, _torch(grads[0]))


# -- the pipeline -------------------------------------------------------------------------

@pytest.mark.parametrize("n_cb", [1, 4])
def test_pipeline_batches_equal_reference(n_cb):
    ref = RefPipeline(300, 16, 3, seed=7, n_codebooks=n_cb)
    port = SyntheticTokenPipeline(300, 16, 3, seed=7, n_codebooks=n_cb)
    try:
        for _ in range(4):
            a, b = port.next(), ref.next()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    finally:
        ref.close()
        port.close()


# -- the training loop ------------------------------------------------------------------

def _settings(cls, **kw):
    return cls(comm_mode="smi:static", remat="nothing", loss_chunks=2, base_lr=3e-2,
               warmup_steps=1, total_steps=10, **kw)


@functools.lru_cache(maxsize=None)
def _ref_history(arch):
    """The reference's 6 steps on a (1, 1) mesh, from its own initial state
    (returned as numpy)."""
    ref_cfg = ref_configs.smoke(ref_configs.get_arch(arch))
    mesh = make_mesh((1, 1), ("data", "model"))
    shape = ref_configs.ShapeConfig("t", S, B, "train")
    st = _settings(ref_steps.TrainSettings)
    init = jax.tree.map(np.asarray, ref_steps.build_train(ref_cfg, mesh, shape, st)
                        ["init_state"](0))
    _, hist = ref_train.train_loop(ref_cfg, mesh, shape, st, steps=STEPS, log_every=1,
                                   state=jax.tree.map(jnp.asarray, init))
    return init, hist


@pytest.mark.parametrize("arch", ["yi-6b", "internvl2-1b"])
def test_train_loop_matches_reference(arch, capsys):
    cfg = configs.smoke(configs.get_arch(arch))
    init, want = _ref_history(arch)
    shape = configs.ShapeConfig("t", S, B, "train")
    state = train_state_from_reference(init, cfg, device="cpu")
    for p in tree_flatten(state["params"]):
        p.requires_grad_(True)
    _, got = launch_train.train_loop(cfg, shape, _settings(TrainSettings), steps=STEPS,
                                     log_every=1, state=state, device="cpu")
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(STEPS))
    for g, w in zip(got, want):
        for k in ("loss", "ce", "lr"):
            assert abs(g[k] - w[k]) <= 1e-4 * max(1.0, abs(w[k])), (g["step"], k, g[k], w[k])
    assert "[train] step=5" in capsys.readouterr().out


@pytest.mark.parametrize("P", [1, 4])
def test_train_state_crosses_both_ways(P):
    """The reference's initial state as the port's (laid over (1, P)) and
    back to the reference's numpy tree: the same leaves, in
    ``jax.tree.flatten``'s order, bit for bit."""
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    init, _ = _ref_history("yi-6b")
    ctx = make_ctx(None if P == 1 else (1, P), device="cpu")
    state = shard_train_state(train_state_from_reference(init, cfg, device="cpu"), cfg, ctx)
    back = train_state_to_numpy(state, cfg, ctx)
    got, want = tree_flatten(back), jax.tree.leaves(init)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_train_loop_at_tp4_matches_tp1():
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    shape = configs.ShapeConfig("t", S, B, "train")
    hist = {}
    for mesh in (None, (1, 4)):
        _, hist[mesh] = launch_train.train_loop(cfg, shape, _settings(TrainSettings),
                                                mesh=mesh, steps=STEPS, log_every=1,
                                                device="cpu")
    for a, b in zip(hist[(1, 4)], hist[None]):
        for k in ("loss", "gnorm"):
            assert abs(a[k] - b[k]) <= 1e-4 * max(1.0, abs(b[k])), (a["step"], k)


# -- checkpoints and fault tolerance --------------------------------------------------------

def _trained(mesh, steps=2):
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    shape = configs.ShapeConfig("t", S, B, "train")
    state, _ = launch_train.train_loop(cfg, shape, _settings(TrainSettings), mesh=mesh,
                                       steps=steps, device="cpu")
    return cfg, state, make_ctx(mesh, device="cpu")


def test_checkpoint_round_trip_and_layout(tmp_path):
    """A tp = 4 state saved global: the reference's files and manifest keys,
    leaves in ``jax.tree.flatten``'s order of the reference's state (its
    shapes, leaf by leaf), restored onto (1, 4) equal bit for bit; a tp = 1
    restore holds the same arrays.  The reference's Checkpointer reads it
    into its own state's structure, and the port reads the reference's."""
    cfg, state, ctx = _trained((1, 4))
    glob = unshard_train_state(state, cfg, ctx)
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(glob, 2)
    d = tmp_path / "port" / "step_00000002"
    assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]
    man = json.loads((d / "manifest.json").read_text())
    assert sorted(man) == ["dtypes", "extra", "n_leaves", "shapes", "step", "treedef"]
    ref_cfg = ref_configs.smoke(ref_configs.get_arch("yi-6b"))
    ref_state = ref_steps.build_train(ref_cfg, make_mesh((1, 1), ("data", "model")),
                                      ref_configs.ShapeConfig("t", S, B, "train"),
                                      _settings(ref_steps.TrainSettings))["state_shape"]
    assert man["shapes"] == [list(x.shape) for x in jax.tree.leaves(ref_state)]
    assert man["dtypes"] == [str(np.dtype(x.dtype)) for x in jax.tree.leaves(ref_state)]
    host, m2 = ck.restore(glob)
    assert m2["step"] == 2
    back = reshard_state(host, state, cfg, ctx)
    for a, b in zip(tree_flatten(back), tree_flatten(state)):
        assert a.shape == b.shape and torch.equal(a.detach(), b.detach())
    assert all(p.requires_grad for p in tree_flatten(back["params"]))
    theirs, _ = RefCheckpointer(str(tmp_path / "port")).restore(ref_state)
    for a, b in zip(jax.tree.leaves(theirs), tree_flatten(glob)):
        assert np.array_equal(np.asarray(a), b.detach().numpy())
    RefCheckpointer(str(tmp_path / "ref")).save(theirs, 7)
    mine, m3 = Checkpointer(str(tmp_path / "ref")).restore(glob)
    assert m3["step"] == 7
    for a, b in zip(tree_flatten(mine), tree_flatten(glob)):
        assert np.array_equal(a, b.detach().numpy())


def test_checkpoint_async_and_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _torch(_tree(5))
    for step in (1, 2, 3):
        ck.save(tree, step, async_=True, extra={"n": step})
    ck.wait()
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    host, man = ck.restore(tree)
    assert man["extra"] == {"n": 3}
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(tree_flatten(host),
                                                              tree_flatten(tree)))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"w": torch.zeros(4, 3)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)


def test_restart_resumes_from_the_checkpoint(tmp_path):
    """A node failure injected at step 3 of 5 (checkpoints every 2 steps):
    ``run_with_restarts`` restores step 2's global state onto (1, 4) and
    the loop resumes from step 2, ending with a checkpoint at step 5."""
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    shape = configs.ShapeConfig("t", S, B, "train")
    st = _settings(TrainSettings)
    art = build_train(cfg, shape, st, mesh=(1, 4), device="cpu")
    like = unshard_train_state(art["init_state"](0), cfg, art["ctx"])
    starts = []

    def make_loop(state, step):
        starts.append(step)
        if step:
            state = reshard_state(state, like, cfg, art["ctx"])
        else:
            state = None
        out, hist = launch_train.train_loop(
            cfg, shape, st, mesh=(1, 4), steps=5, ckpt_dir=str(tmp_path), ckpt_every=2,
            log_every=1, state=state, start_step=step, fail_at=3 if len(starts) == 1 else None,
            device="cpu")
        return out, hist

    (final, hist), restarts = run_with_restarts(make_loop, Checkpointer(str(tmp_path)), like)
    assert restarts == 1 and starts == [0, 2]
    assert [h["step"] for h in hist] == [2, 3, 4]
    assert Checkpointer(str(tmp_path)).latest_step() == 5
    # step 2's checkpoint holds the state after its update (3 updates); steps 2-4 rerun
    assert int(final["opt"]["step"]) == 3 + 3


def test_restarts_give_up_after_max(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save({"x": torch.zeros(2)}, 0)
    calls = []

    def boom(state, step):
        calls.append(step)
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        run_with_restarts(boom, ck, {"x": torch.zeros(2)}, max_restarts=2)
    assert calls == [0, 0, 0]


def test_watchdog_matches_reference():
    """The same lap intervals (a straggler among them) on a scripted clock:
    the same flags, EMA and events."""
    times = [0.0, 1.0, 2.0, 3.1, 9.0, 10.0, 10.9, 30.0]
    port, ref = watchdog.StepWatchdog(), ref_watchdog.StepWatchdog()
    for wd, mod in ((port, watchdog), (ref, ref_watchdog)):
        clock = iter(times)
        with mock.patch.object(mod.time, "monotonic", lambda: next(clock)):
            wd.start()
            wd.flags = [wd.lap(i) for i in range(len(times) - 1)]
    assert port.flags == ref.flags and any(port.flags)
    assert port.ema == pytest.approx(ref.ema, rel=1e-12)
    assert port.events == ref.events


def test_elastic_plan_matches_reference():
    for n in range(1, 17):
        for prefer in (2, 4, 8):
            assert best_mesh_shape(n, prefer_model=prefer) == \
                ref_elastic.best_mesh_shape(n, prefer_model=prefer)
    got, want = elastic_restart_plan(8, 6), ref_elastic.elastic_restart_plan(8, 6)
    assert got["mesh_shape"] == want["mesh_shape"]
    assert got["topology"].to_json() == want["topology"].to_json()
    np.testing.assert_array_equal(got["route_table"].next_hop, want["route_table"].next_hop)
    assert elastic.reshard_state is reshard_state


# -- the launcher ---------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu(capsys):
    base = ["--device", "cpu", "--smoke", "--steps", "2", "--seq-len", "32", "--batch", "2"]
    assert launch_train.main(base) == 0
    assert "[train] done" in capsys.readouterr().out
    assert launch_train.main(base + ["--mesh", "1,4", "--comm-mode", "smi:fused"]) == 0
    assert launch_train.main(base + ["--mesh", "1,4", "--validate-comm"]) == 0
    out = capsys.readouterr().out
    assert "[validate-comm] ok" in out and "tp.loss.ce" in out
    assert launch_train.main(base + ["--mesh", "2,4"]) == 0
    assert launch_train.main(base + ["--mesh", "2,4", "--comm-mode", "smi:fused",
                                     "--compressed-grads", "--validate-comm"]) == 0
    out = capsys.readouterr().out
    assert "[validate-comm] ok" in out and "fsdp.gather" in out


@pytest.mark.parametrize("remat", ["dots", "dots_nb"])
def test_remat_policies_that_save_products_wait_for_item_13(remat):
    """The policies that save the products (once refused) run: the loss and
    its gradients equal ``"none"``'s bit for bit, through ``lm_loss`` and
    through a training step built with the policy."""
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    art = build_train(cfg, configs.ShapeConfig("t", S, B, "train"),
                      _settings(TrainSettings), device="cpu")
    params = art["init_params"](0)
    tok = torch.arange(B * S, dtype=torch.int32).reshape(B, S) % cfg.vocab_size
    want, _ = lm_loss(params, tok, tok, cfg, art["ctx"], remat="none", loss_chunks=2)
    got, _ = lm_loss(params, tok, tok, cfg, art["ctx"], remat=remat, loss_chunks=2)
    assert torch.equal(got, want)
    gw = torch.autograd.grad(want, tree_flatten(params))
    gg = torch.autograd.grad(got, tree_flatten(params))
    assert all(torch.equal(a, b) for a, b in zip(gg, gw))
    art2 = build_train(cfg, configs.ShapeConfig("t", S, B, "train"),
                       TrainSettings(remat=remat, loss_chunks=2), device="cpu")
    loss, _, g = art2["grads"](params, {"tokens": tok, "labels": tok})
    assert torch.equal(loss, want.detach())
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(g), gw))
