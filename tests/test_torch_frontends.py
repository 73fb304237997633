"""The port's modality frontends against the reference's, on the CPU: the
codebook token streams of musicgen-medium (4 EnCodec codebooks, each with
its embedding and head), the precomputed patch embeddings of internvl2-1b
(``pixel_embeds`` in the first ``n_patches`` positions), and the inputs
both packages draw (``data.make_inputs``).

The reference runs each rank under ``jax.shard_map`` on the 8 host devices
of tests/conftest.py, its Pallas kernels in interpret mode; the port runs
the same inputs as one rank-stacked tensor.  Weights come from the
reference's ``init_lm`` (drawn with the TP context where the heads must be
padded to a multiple of P; norms and biases perturbed with numpy noise so
that they count) and cross with ``params_from_reference``.  Tolerance,
float32: the largest difference at most 1e-5 of the largest reference
magnitude.

* ``input_specs`` and ``make_inputs`` equal to the reference's for every
  architecture and shape kind, array for array;
* musicgen-medium: ``lm_prefill`` on ``(B, S, 4)`` tokens and
  ``lm_decode_step`` on ``(B, 4)`` tokens at tp = 1 and (1, 4), the
  logits ``(B, V, 4)`` (gathered over ``tp.loss.gather``, 4 times the
  bytes of one stream); both engines' ``(4,)`` tokens equal to the
  reference's wave oracle at tp = 1, (1, 4) and (2, 4); the decode ledger
  equal to ``predict_decode_step_stats`` at (1, 8) and (2, 4);
* internvl2-1b: ``lm_prefill`` with ``pixel_embeds`` at tp = 1, (1, 4) and
  (1, 8) against the reference; the embeddings at the patch positions
  bit-equal between tp = 1 and tp = P (only rank 0's partial carries them);
  ``build_prefill`` splitting the patch rows over a data axis;
* ``launch.serve`` for both families on the CPU, ``--validate-comm``
  included.
"""

import functools
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from repro import configs as ref_configs
from repro.data import input_specs as ref_input_specs
from repro.data import make_inputs as ref_make_inputs
from repro.kernels.matmul import matmul as ref_matmul
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_mesh
from repro.mesh.api import ParallelCtx as RefCtx
from repro.mesh.api import make_ctx as ref_make_ctx
from repro.models import model as ref_model
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefWave
from repro_torch import configs
from repro_torch.data import input_specs, make_inputs
from repro_torch.interop import params_from_reference, shard_params
from repro_torch.kernels.matmul import matmul
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.steps import build_continuous_serve, build_prefill, build_serve
from repro_torch.mesh.api import make_ctx
from repro_torch.models import assemble_logits, gather_hidden, init_lm, lm_caches
from repro_torch.models import lm_decode_step, lm_prefill, lm_specs
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.models.model import embed_tokens_sp
from repro_torch.netsim import predict_decode_step_stats
from repro_torch.parallel import ledger
from repro_torch.serving import ContinuousEngine, Request, ServeEngine

RTOL = 1e-5
AUDIO, VLM = "musicgen-medium", "internvl2-1b"
MESHES = {"1x4": (1, 4), "1x8": (1, 8), "2x4": (2, 4)}
B, S, CAP = 2, 32, 16


@functools.lru_cache(maxsize=None)
def _mesh(dims):
    return make_mesh(dims, ("data", "model"))


def _cfgs(arch):
    return (ref_configs.smoke(ref_configs.get_arch(arch)),
            configs.smoke(configs.get_arch(arch)))


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} * {scale}"


@functools.lru_cache(maxsize=None)
def _np_params(arch, tp=1):
    """The reference's init_lm with the tp context (heads padded to a
    multiple of tp), norms and biases perturbed, as numpy."""
    ref_cfg, _ = _cfgs(arch)
    ctx = RefCtx() if tp == 1 else ref_make_ctx(_mesh((1, tp)), comm_mode="smi:static")
    p = ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, ctx)
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        a = np.asarray(leaf)
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name or name in ("bq", "bk", "bv"):
            a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) and a.dtype != torch.bfloat16 else a
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# -- the inputs ---------------------------------------------------------------------

SHAPE_KINDS = {"train": configs.ShapeConfig("t", 24, 3, "train"),
               "prefill": configs.ShapeConfig("p", 24, 3, "prefill"),
               "decode": configs.ShapeConfig("d", 24, 3, "decode")}


@pytest.mark.parametrize("kind", sorted(SHAPE_KINDS))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_make_inputs_match_reference(arch, kind):
    """Every input of the smoke config (a bfloat16 copy too, for the patch
    embeddings' dtype) for the shape kind: the same names in the same
    order, shapes, dtypes and bits as the reference's ``make_inputs`` from
    the same seed."""
    for dtype in ("float32", "bfloat16"):
        ref_cfg = ref_configs.smoke(ref_configs.get_arch(arch)).scaled(dtype=dtype)
        cfg = configs.smoke(configs.get_arch(arch)).scaled(dtype=dtype)
        rs = SHAPE_KINDS[kind]
        ref_shape = ref_configs.ShapeConfig(rs.name, rs.seq_len, rs.global_batch, rs.kind)
        want = ref_make_inputs(ref_cfg, ref_shape, seed=5)
        got = make_inputs(cfg, rs, seed=5, device="cpu")
        assert list(got) == list(want), (arch, kind)
        for k, w in want.items():
            w = np.asarray(w)
            assert tuple(got[k].shape) == w.shape and got[k].dtype.itemsize == w.dtype.itemsize, k
            np.testing.assert_array_equal(_bits(got[k]), _bits(w), f"{arch} {kind} {k}")


@pytest.mark.parametrize("shape", sorted(configs.SHAPES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_input_specs_match_reference(arch, shape):
    """The full-size configs' input shapes and dtypes at every shape of the
    registry (none drawn)."""
    want = ref_input_specs(ref_configs.get_arch(arch), ref_configs.SHAPES[shape])
    got = input_specs(configs.get_arch(arch), configs.SHAPES[shape])
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k


# -- codebook streams (musicgen-medium) --------------------------------------------


def _cb_tokens(seed=7, n=S, b=B):
    return np.random.RandomState(seed).randint(0, 256, (b, n, 4)).astype(np.int32)


def test_codebook_init_lm_layout_matches_reference():
    """``embed_cb`` (4, V, D) and ``head_cb`` (4, D, V) in place of
    ``embed``/``head``, leaf for leaf in the reference's flatten order; the
    specs split both over the vocabulary."""
    ref_cfg, cfg = _cfgs(AUDIO)
    want = jax.eval_shape(lambda: ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, RefCtx()))
    got = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [(path, tuple(t.shape)) for path, t in tree_leaves_with_path(got)] == \
        [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path), tuple(leaf.shape))
         for path, leaf in jax.tree_util.tree_leaves_with_path(want)]
    assert tuple(got["embed_cb"].shape) == (4, cfg.padded_vocab, cfg.d_model)
    sp = lm_specs(cfg, make_ctx((1, 4), comm_mode="smi:static", device="cpu"))
    assert tuple(sp["embed_cb"]) == (None, "model", None)
    assert tuple(sp["head_cb"]) == (None, None, "model")


def _ref_prefill(arch, P, tokens, extra=None, tp_params=1):
    ref_cfg, _ = _cfgs(arch)
    np_p = _np_params(arch, tp_params)
    if P == 1:
        return np.asarray(jax.jit(lambda p, t, e: ref_model.lm_prefill(
            p, t, ref_cfg, RefCtx(), capacity=tokens.shape[1], extra_embeds=e,
            interp=True))(np_p, tokens, extra))
    rctx = ref_make_ctx(_mesh((1, P)), comm_mode="smi:static",
                        matmul_fn=functools.partial(ref_matmul, interpret=True))
    fn = jax.shard_map(
        lambda p, t, e: ref_model.lm_prefill(p, t, ref_cfg, rctx, capacity=tokens.shape[1],
                                             extra_embeds=e, interp=True),
        mesh=_mesh((1, P)), in_specs=(ref_model.lm_specs(ref_cfg, rctx), PS(), PS()),
        out_specs=PS(None, "model", None), check_vma=False)
    return np.asarray(jax.jit(fn)(np_p, tokens, extra))


@pytest.mark.parametrize("P", [1, 4])
def test_codebook_prefill_matches_reference(P, devices8):
    """``lm_prefill`` on (B, S, 4) tokens, the four streams' partial
    embeddings summed before the reduce-scatter, kernel D injected at
    tp = 4, against the reference's."""
    _, cfg = _cfgs(AUDIO)
    tokens = _cb_tokens()
    want = _ref_prefill(AUDIO, P, tokens)
    ctx = make_ctx() if P == 1 else make_ctx((1, P), comm_mode="smi:static", matmul_fn=matmul,
                                             device="cpu")
    params = shard_params(params_from_reference(_np_params(AUDIO), cfg, "cpu"), cfg, ctx)
    h = lm_prefill(params, torch.from_numpy(tokens), cfg, ctx, capacity=S)
    _close(h if P == 1 else gather_hidden(h), want, f"musicgen tp={P}")


def _ref_decode(arch, dims, mode, steps, tp_params=1):
    ref_cfg, _ = _cfgs(arch)
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
        logits, caches = rt["step"](_np_params(arch, tp_params), caches, tok, np.int32(t))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("mesh", ["1x1", "1x4"])
def test_codebook_decode_matches_reference(mesh, devices8):
    """Four decode steps on (4, 4) codebook tokens: ``build_serve``'s step
    (the shards assembled without a wire) and ``lm_decode_step``'s gathered
    logits, both (B, V, 4), within 1e-5 of the reference's ``shard_map``
    decode; the gather over ``tp.loss.gather`` moves 4 times one stream's
    bytes, (P - 1) shifts of a rank's (V/P, B, 4) float32 shard."""
    dims = (1, 1) if mesh == "1x1" else MESHES[mesh]
    P = dims[1]
    steps = [np.random.RandomState(5 + t).randint(0, 256, (4, 4)).astype(np.int32)
             for t in range(4)]
    want = _ref_decode(AUDIO, dims, "smi:static", steps)
    _, cfg = _cfgs(AUDIO)
    rt = build_serve(cfg, configs.ShapeConfig("t", CAP, 4, "decode"), mesh=dims,
                     comm_mode="smi:static", device="cpu")
    params = shard_params(params_from_reference(_np_params(AUDIO), cfg, "cpu"), cfg, rt["ctx"])
    caches = lm_caches(cfg, 4, CAP, rt["ctx"], "cpu")
    caches2 = lm_caches(cfg, 4, CAP, rt["ctx"], "cpu")
    for t, (tok, w) in enumerate(zip(steps, want, strict=True)):
        assert w.shape == (4, cfg.padded_vocab, 4)
        got, caches = rt["step"](params, caches, torch.from_numpy(tok), t)
        _close(got, w, f"{mesh} step {t}")
        with ledger.capture() as led:
            full, caches2 = lm_decode_step(params, caches2, torch.from_numpy(tok), t, cfg,
                                           rt["ctx"])
        _close(full if P == 1 else full[P - 1], w, f"{mesh} step {t} gathered")
    if P > 1:
        shard = cfg.padded_vocab // P * 4 * 4 * 4
        assert led.by_tag["tp.loss.gather"] == {"steps": P - 1, "bytes": (P - 1) * shard}


def test_assemble_logits_equals_the_gather():
    """``assemble_logits`` of the (P, B, V/P, 4) shards is every rank's
    gathered (B, V, 4), rank r's columns at r V/P."""
    _, cfg = _cfgs(AUDIO)
    ctx = make_ctx((1, 4), comm_mode="smi:static", device="cpu")
    params = shard_params(init_lm(cfg, torch.Generator().manual_seed(2), "cpu", ctx=ctx), cfg,
                          ctx)
    tok = torch.from_numpy(_cb_tokens(3, 1, 3)[:, 0])
    shards, _ = lm_decode_step(params, lm_caches(cfg, 3, CAP, ctx, "cpu"), tok, 0, cfg, ctx,
                               gather_logits=False)
    full, _ = lm_decode_step(params, lm_caches(cfg, 3, CAP, ctx, "cpu"), tok, 0, cfg, ctx)
    assert tuple(shards.shape) == (4, 3, cfg.padded_vocab // 4, 4)
    for r in range(4):
        assert torch.equal(assemble_logits(shards), full[r])


PROMPTS = [np.random.RandomState(20 + i).randint(0, 256, (n, 4)).tolist()
           for i, n in enumerate((3, 2, 4))]


@functools.lru_cache(maxsize=None)
def _wave_oracle():
    """The reference's tp = 1 wave engine on codebook prompts."""
    ref_cfg, _ = _cfgs(AUDIO)
    wave = RefWave(ref_cfg, _np_params(AUDIO), batch_slots=2, capacity=32)
    for i, p in enumerate(PROMPTS):
        wave.submit(RefRequest(uid=i, prompt=p, max_new=4))
    return {r.uid: list(r.out) for r in wave.run(max_steps=200)}


@pytest.mark.parametrize("engine", ["wave", "continuous"])
@pytest.mark.parametrize("mesh", ["1x1", "1x4", "2x4"])
def test_codebook_engines_match_reference_wave_oracle(mesh, engine, devices8):
    """Both engines emit the reference's tp = 1 wave tokens, a list of 4
    codebook tokens a step; the continuous engine migrates a slot between
    two ticks with one tick in flight (its ``(n_cb,)`` token row with it)."""
    _, cfg = _cfgs(AUDIO)
    dims = (1, 1) if mesh == "1x1" else MESHES[mesh]
    glob = params_from_reference(_np_params(AUDIO), cfg, "cpu")
    if engine == "wave":
        rt = build_serve(cfg, configs.ShapeConfig("t", 32, 2, "decode"), mesh=dims,
                         comm_mode="smi:static", device="cpu")
        eng = ServeEngine(cfg, shard_params(glob, cfg, rt["ctx"]), runtime=rt)
    else:
        rt = build_continuous_serve(cfg, mesh=dims, comm_mode="smi:static", batch_slots=4,
                                    capacity=32, device="cpu")
        eng = ContinuousEngine(cfg, shard_params(glob, cfg, rt["ctx"]), runtime=rt)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=i, prompt=p, max_new=4))
    done = []
    if engine == "continuous":
        done = eng.tick() + eng.tick()
        eng.migrate(0, 3, overlap_ticks=1)
    done += eng.run(max_steps=200)
    if engine == "continuous":
        eng.shutdown()
    got = {r.uid: r.out for r in done}
    assert got == _wave_oracle()
    assert all(len(tok) == 4 and all(isinstance(c, int) for c in tok)
               for out in got.values() for tok in out)


@pytest.mark.parametrize("arch", [AUDIO, VLM])
@pytest.mark.parametrize("mesh", ["1x8", "2x4"])
def test_decode_ledger_equals_prediction(arch, mesh):
    """One continuous decode step plus one migration, the heads padded to a
    multiple of P: the ledger equals ``predict_decode_step_stats(...,
    eager=True)`` per tag (one ``tp.embed`` psum of the codebooks' summed
    (B, D) embedding)."""
    _, cfg = _cfgs(arch)
    dims = MESHES[mesh]
    st = SimpleNamespace(comm_mode="smi:static")
    rt = build_continuous_serve(cfg, mesh=dims, comm_mode=st.comm_mode, batch_slots=2,
                                capacity=32, device="cpu")
    params = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=rt["ctx"]),
                          cfg, rt["ctx"])
    caches = rt["init_caches"]()
    tok = torch.zeros((2, 4) if arch == AUDIO else (2,), dtype=torch.int32)
    with ledger.capture() as led:
        rt["step"](params, caches, tok, torch.zeros(2, dtype=torch.int32))
        rt["migrate_finish"](caches, rt["migrate_start"](caches, 0), 1)
    rt["pool"].close()
    assert led.by_tag == predict_decode_step_stats(cfg, dims, 2, st, capacity=32, migrations=1,
                                                   eager=True)
    assert led.by_tag["serve.tp.embed"] == {"steps": 1, "bytes": 2 * cfg.d_model * 4}


# -- patch embeddings (internvl2-1b) ------------------------------------------------------


def _pixels(seed=3, b=B):
    _, cfg = _cfgs(VLM)
    return (np.random.RandomState(seed).randn(b, cfg.n_patches, cfg.d_model) * 0.02
            ).astype(np.float32)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_patch_prefill_matches_reference(P, devices8):
    """``lm_prefill`` with ``pixel_embeds`` in the first 8 positions against
    the reference's (its ``shard_map`` prefill at tp = P, the heads padded
    to a multiple of P in both), kernel D injected at tp > 1."""
    ref_cfg, cfg = _cfgs(VLM)
    tokens = np.random.RandomState(7).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = _ref_prefill(VLM, P, tokens, _pixels(), tp_params=P)
    ctx = make_ctx() if P == 1 else make_ctx((1, P), comm_mode="smi:static", matmul_fn=matmul,
                                             device="cpu")
    params = shard_params(params_from_reference(_np_params(VLM, P), cfg, "cpu"), cfg, ctx)
    h = lm_prefill(params, torch.from_numpy(tokens), cfg, ctx, capacity=S,
                   extra_embeds=torch.from_numpy(_pixels()))
    _close(h if P == 1 else gather_hidden(h), want, f"internvl2 tp={P}")


@pytest.mark.parametrize("mode", ["smi:static", "smi:fused", "bulk"])
@pytest.mark.parametrize("P", [4, 8])
def test_patch_embeddings_exact_across_ranks(P, mode):
    """The embedding at tp = P, reduce-scattered to sequence shards, equals
    tp = 1's in float32: bit for bit at the patch positions (rank 0's
    partial alone carries them; the others add zeros), within 1e-6 at the
    token positions (the vocabulary partials sum in another order)."""
    _, cfg = _cfgs(VLM)
    glob = init_lm(cfg, torch.Generator().manual_seed(4), "cpu")
    ctx = make_ctx((1, P), comm_mode=mode, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(8).randint(0, cfg.vocab_size, (B, S)))
    pix = torch.from_numpy(_pixels(9))
    want = embed_tokens_sp(glob, tokens, cfg, make_ctx(), pix)
    got = gather_hidden(embed_tokens_sp(shard_params(glob, cfg, ctx), tokens, cfg, ctx, pix))
    npch = cfg.n_patches
    assert torch.equal(got[:, :npch], pix) and torch.equal(want[:, :npch], pix)
    np.testing.assert_allclose(got[:, npch:].numpy(), want[:, npch:].numpy(), rtol=0, atol=1e-6)


def test_build_prefill_splits_patch_rows_over_data_groups():
    """``build_prefill`` at (2, 4) splits the tokens' and the patch
    embeddings' rows over the two data groups: equal to the tp = 1 prefill
    of all four rows."""
    _, cfg = _cfgs(VLM)
    glob = init_lm(cfg, torch.Generator().manual_seed(5), "cpu")
    shape = configs.ShapeConfig("t", S, 4, "prefill")
    tokens = torch.from_numpy(np.random.RandomState(10).randint(0, cfg.vocab_size, (4, S)))
    pix = torch.from_numpy(_pixels(11, b=4))
    want = build_prefill(cfg, shape, device="cpu")(glob, tokens, pix)
    step = build_prefill(cfg, shape, mesh=(2, 4), comm_mode="smi:static", device="cpu")
    got = step(shard_params(glob, cfg, step.ctx), tokens, pix)
    _close(got, want, "(2, 4) vs tp = 1")
    other = step(shard_params(glob, cfg, step.ctx), tokens, pix.flip(0))
    assert float((other - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_prefill_takes_the_token_shape_of_its_config():
    """A codebook model's prefill takes (B, S, n_cb) tokens and refuses
    (B, S); a single-stream model the reverse."""
    for arch, bad in ((AUDIO, (1, 8)), (VLM, (1, 8, 4))):
        _, cfg = _cfgs(arch)
        step = build_prefill(cfg, configs.ShapeConfig("t", 8, 1, "prefill"), device="cpu")
        with pytest.raises(ValueError, match="tokens of"):
            step(None, torch.zeros(bad, dtype=torch.int32))


# -- the launcher -------------------------------------------------------------------------


def test_serve_cli_frontends_on_cpu(tmp_path):
    """``launch.serve --arch musicgen-medium --smoke --mesh 1,4`` runs both
    engines to the same ``(4,)`` tokens a step, the prompts drawn as the
    reference draws them; ``--validate-comm`` exits 0 for musicgen at (1, 8)
    and (2, 4) and internvl2-1b at (1, 8), every tag equal."""
    outs = []
    for engine in ("wave", "continuous"):
        out = tmp_path / f"{engine}.json"
        assert launch_serve.main(["--arch", AUDIO, "--smoke", "--device", "cpu", "--mesh", "1,4",
                                  "--comm-mode", "smi:static", "--engine", engine,
                                  "--requests", "3", "--max-new", "3", "--json", str(out)]) == 0
        outs.append(json.loads(out.read_text())["out"])
    assert outs[0] == outs[1] and len(outs[0]) == 3
    assert all(len(tok) == 4 for out in outs[0].values() for tok in out)
    for arch, mesh in ((AUDIO, "1,8"), (AUDIO, "2,4"), (VLM, "1,8")):
        out = tmp_path / "validate.json"
        assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--mesh", mesh,
                                  "--comm-mode", "smi:static", "--validate-comm", "--json",
                                  str(out)]) == 0
        res = json.loads(out.read_text())
        assert res["predicted"] == res["measured"] and "serve.tp.embed" in res["measured"]
