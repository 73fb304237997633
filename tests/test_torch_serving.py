"""The port's serving engines against the reference's, on the CPU.

Both packages get the reference's ``init_lm`` weights (carried by
``params_from_reference``) and the same requests, on the smoke configs of
yi-6b, minitron-4b and mamba2-2.7b (SSM decode caches); greedy tokens,
admission and completion ticks must be equal exactly.  The cache helpers
(``reset_slot``, ``pack_slot``/``unpack_slot``, ``copy_slot``) are held to
the reference's bytes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.mesh.api import ParallelCtx as RefCtx
from repro.models import init_lm as ref_init_lm
from repro.models import lm_caches as ref_lm_caches
from repro.serving import ContinuousEngine as RefContinuous
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefWave
from repro.serving import continuous as ref_cont
from repro_torch import configs
from repro_torch.interop import params_from_reference
from repro_torch.mesh.api import ParallelCtx
from repro_torch.models import lm_caches
from repro_torch.models.common import tree_leaves_with_path, tree_map
from repro_torch.serving import (
    ContinuousEngine,
    Request,
    ServeEngine,
    copy_slot,
    pack_slot,
    reset_slot,
    unpack_slot,
)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("yi-6b", "minitron-4b")
#: the archs the engines and the cache helpers are held on: the dense ones
#: and mamba2, whose caches are conv windows and an SSD state
ENGINE_ARCHS = ARCHS + ("mamba2-2.7b",)


def _cfgs(arch):
    return ref_configs.smoke(ref_configs.get_arch(arch)), configs.smoke(configs.get_arch(arch))


def _params(arch, seed=0):
    ref_cfg, cfg = _cfgs(arch)
    np_params = jax.tree.map(np.asarray, ref_init_lm(jax.random.PRNGKey(seed), ref_cfg, RefCtx()))
    return ref_cfg, cfg, np_params, params_from_reference(np_params, cfg, device="cpu")


def _prompts(cfg, n, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (int(rng.randint(2, 9)),)).tolist() for _ in range(n)]


def _drive(engine, req_cls, prompts, max_new, arrivals):
    reqs = [req_cls(uid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    if arrivals is None:
        for r in reqs:
            engine.submit(r)
        done = engine.run(max_steps=400)
    else:
        done = engine.run(max_steps=400, arrivals=list(zip(arrivals, reqs)))
    return ({r.uid: list(r.out) for r in done}, dict(engine.admit_step),
            dict(engine.finish_step))


ARRIVALS = {"queued": None, "scheduled": [0, 0, 3, 4, 11, 30]}


@pytest.mark.parametrize("arrivals", sorted(ARRIVALS))
@pytest.mark.parametrize("engine", ["wave", "continuous"])
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engines_match_reference(arch, engine, arrivals):
    ref_cfg, cfg, np_params, params = _params(arch)
    prompts = _prompts(cfg, 6)
    sched = ARRIVALS[arrivals]
    kw = dict(batch_slots=2, capacity=32)
    ref_cls, cls = (RefWave, ServeEngine) if engine == "wave" else (RefContinuous,
                                                                     ContinuousEngine)
    want = _drive(ref_cls(ref_cfg, np_params, ctx=RefCtx(), **kw), RefRequest, prompts, 7, sched)
    got = _drive(cls(cfg, params, ctx=ParallelCtx(), **kw), Request, prompts, 7, sched)
    assert len(got[0]) == len(prompts)
    assert got == want


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_wave_and_continuous_emit_the_same_tokens(arch):
    _, cfg, _, params = _params(arch, seed=2)
    prompts = _prompts(cfg, 7, seed=5)
    outs = [_drive(cls(cfg, params, batch_slots=3, capacity=32), Request, prompts, 9, None)[0]
            for cls in (ServeEngine, ContinuousEngine)]
    assert outs[0] == outs[1]


def _filled_caches(arch):
    """Both packages' caches after a few decode steps of random tokens (the
    same steps), so every slot holds distinct rows."""
    from repro.models import lm_decode_step as ref_step
    from repro_torch.models import lm_decode_step

    ref_cfg, cfg, np_params, params = _params(arch)
    B, cap = 3, 16
    rc = ref_lm_caches(ref_cfg, B, cap, RefCtx())
    pc = lm_caches(cfg, B, cap, ParallelCtx(), device="cpu")
    rng = np.random.RandomState(9)
    for step in range(5):
        tok = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
        pos = np.array([step, step + 1, step + 4], np.int32)
        _, rc = ref_step(np_params, rc, jnp.asarray(tok), jnp.asarray(pos), ref_cfg, RefCtx())
        _, pc = lm_decode_step(params, pc, torch.from_numpy(tok), torch.from_numpy(pos), cfg,
                               ParallelCtx())
    return rc, pc


def _leaves(caches):
    return [t.numpy() for _, t in tree_leaves_with_path(caches)]


def _ref_leaves(caches):
    return [np.asarray(t) for t in jax.tree.leaves(caches)]


def _assert_caches_close(pc, rc):
    for got, want in zip(_leaves(pc), _ref_leaves(rc), strict=True):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_reset_slot_matches_reference(arch):
    rc, pc = _filled_caches(arch)
    _assert_caches_close(pc, rc)
    for slot in (1, 0):
        rc = ref_cont.reset_slot(rc, slot)
        pc = reset_slot(pc, slot)
        _assert_caches_close(pc, rc)
    # every leaf's rows of the reset slots: slot_pos -1, all other state 0
    for path, leaf in tree_leaves_with_path(pc):
        for slot in (0, 1):
            rows = leaf.select(1 if "periods" in path else 0, slot)
            assert (rows == (-1 if "slot_pos" in path else 0)).all(), (path, slot)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_pack_unpack_round_trip(arch):
    rc, pc = _filled_caches(arch)
    image = pack_slot(pc, 2)
    ref_image = torch.from_numpy(np.array(ref_cont.pack_slot(rc, 2)))
    assert image.dtype == torch.uint8 and image.shape == ref_image.shape
    # the reference's image, read with the port's layout, holds the port's rows
    probe = tree_map(torch.clone, pc)
    unpack_slot(probe, ref_image, 0)
    unpack_slot(probe, image, 1)
    for path, leaf in tree_leaves_with_path(probe):
        bdim = 1 if "periods" in path else 0
        a, b = leaf.select(bdim, 0), leaf.select(bdim, 1)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, float(b.abs().max())))
    # into another slot of the same caches: the local copy, bit for bit
    oracle = copy_slot(tree_map(torch.clone, pc), 2, 0)
    unpack_slot(pc, image, 0)
    for a, b in zip(_leaves(pc), _leaves(oracle), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        unpack_slot(pc, image[:-4], 1)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_migration_keeps_tokens(arch):
    """A request moved to another slot mid-generation emits the tokens it
    would have emitted in place."""
    _, cfg, _, params = _params(arch, seed=4)
    prompts = _prompts(cfg, 2, seed=6)
    want = _drive(ContinuousEngine(cfg, params, batch_slots=3, capacity=32), Request, prompts,
                  8, None)[0]
    eng = ContinuousEngine(cfg, params, batch_slots=3, capacity=32)
    reqs = [Request(uid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(len(prompts[0]) + 2):
        eng.tick()
    eng.migrate(0, 2, overlap_ticks=2)
    eng.run(max_steps=100)
    assert {r.uid: r.out for r in reqs} == want


def test_tensor_parallel_runtime_raises():
    """A TP runtime refuses a migration onto a slot that is not free; it
    runs mamba2's ssm block at tp > 1 (once refused, item 14), every cache
    leaf carrying the rank dimension."""
    from repro_torch.launch.steps import build_continuous_serve

    _, ssm_cfg = _cfgs("mamba2-2.7b")
    rt = build_continuous_serve(ssm_cfg, mesh=(1, 4), comm_mode="smi:static", device="cpu")
    caches = rt["init_caches"]()
    rt["pool"].close()
    assert all(tuple(t.shape[:3]) == (ssm_cfg.n_layers, 4, 4)
               for t in caches["periods"][0].values())
    _, cfg, _, params = _params("yi-6b")
    rt = build_continuous_serve(cfg, mesh=(1, 4), comm_mode="smi:static", batch_slots=2,
                                device="cpu")
    with ContinuousEngine(cfg, _shard(params, cfg, rt["ctx"]), runtime=rt) as eng:
        for uid in range(2):
            eng.submit(Request(uid=uid, prompt=[3, 4], max_new=4))
        eng.tick()
        with pytest.raises(ValueError, match="not free"):
            eng.migrate(0, 1)


def _shard(params, cfg, ctx):
    from repro_torch.interop import shard_params

    return shard_params(params, cfg, ctx)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_runtime_matches_tp1(arch):
    """The continuous engine on ``build_continuous_serve``'s (1, 4) runtime
    (a ChannelPool over ``smi:static``) emits the tp = 1 engine's tokens on
    the same weights (4 heads split whole over 4 ranks), with a migration
    streamed between two of the runs' ticks; the pool is released at
    shutdown."""
    from repro_torch.launch.steps import build_continuous_serve

    _, cfg, _, params = _params(arch)
    prompts = _prompts(cfg, 3)
    want, _, _ = _drive(ContinuousEngine(cfg, params, batch_slots=4, capacity=32), Request,
                        prompts, 5, None)
    rt = build_continuous_serve(cfg, mesh=(1, 4), comm_mode="smi:static", batch_slots=4,
                                capacity=32, device="cpu")
    eng = ContinuousEngine(cfg, _shard(params, cfg, rt["ctx"]), runtime=rt)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=5))
    done = eng.tick() + eng.tick()
    eng.migrate(0, 3, overlap_ticks=1)
    done += eng.run(max_steps=100)
    assert {r.uid: r.out for r in done} == want
    eng.shutdown()
    assert rt["pool"].closed


def test_serve_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                          "--device", "cpu"], capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "completed 4/4 requests" in res.stdout


def test_serve_cli_mamba2_engines_agree_on_cpu(tmp_path):
    from repro_torch.launch import serve

    outs = []
    for engine in ("wave", "continuous"):
        out = tmp_path / f"{engine}.json"
        assert serve.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu", "--engine",
                           engine, "--json", str(out)]) == 0
        outs.append(json.loads(out.read_text())["out"])
    assert outs[0] == outs[1] and len(outs[0]) == 4


@pytest.mark.parametrize("argv", [["--mesh", "1,8"], ["--validate-comm"]])
def test_serve_cli_refuses_tensor_parallel(argv):
    """What the launcher refuses at tp > 1: ``--validate-comm`` with the
    bare ``smi`` plan returns 2 (the tuner's picks are not the
    predictor's).  mamba2 over a (1, 8) mesh, once refused (item 14),
    serves every request."""
    from repro_torch.launch import serve

    if "--validate-comm" in argv:
        assert serve.main(["--smoke", "--device", "cpu", "--mesh", "1,4", *argv]) == 2
        return
    assert serve.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu", *argv]) == 0
