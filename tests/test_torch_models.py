"""The port's dense and Mamba2 model paths against the reference's, on the
CPU.

Weights come from the reference's ``init_lm`` (its norm weights and biases,
ones and zeros at init, and the SSM's ``A_log``, ``dt_bias``, ``D_skip`` and
grouped norm ``gn``, perturbed with numpy noise so that they count) and
cross to the port through ``params_from_reference``; inputs come from
``numpy.random.RandomState``.  Configurations: the ``smoke()`` sizes of
yi-6b, glm4-9b (qkv bias), minitron-4b (GELU), yi-6b with ``qk_norm`` and a
16-token local window, and mamba2-2.7b (prefills of 200 and 300 tokens, so
the SSD scan pads and carries its state across chunks).  Tolerance,
float32: the largest difference is at most 1e-5 of the largest reference
magnitude (the two sum the same terms in another order).
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import common as ref_kcommon
from repro.mesh.api import ParallelCtx as RefCtx
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.interop import params_from_reference
from repro_torch.kernels.common import cdiv, pad_to
from repro_torch.mesh.api import ParallelCtx, make_ctx
from repro_torch.models import attention, common, init_lm, lm_caches, lm_decode_step, lm_prefill
from repro_torch.models import mlp as port_mlp
from repro_torch.models import ssm
from repro_torch.models.common import tree_leaves_with_path

RTOL = 1e-5
#: test configuration -> (arch, overrides of its smoke config)
CFGS = {
    "yi-6b": ("yi-6b", {}),
    "glm4-9b": ("glm4-9b", {}),
    "minitron-4b": ("minitron-4b", {}),
    "yi-6b-qknorm-window": ("yi-6b", dict(qk_norm=True, local_window=16)),
    # the tied-embedding archs: the logits read the embedding's transpose
    "command-r-plus-104b": ("command-r-plus-104b", {}),
    "internvl2-1b": ("internvl2-1b", {}),
}
#: the Mamba2 configuration (``"ssm"`` blocks, no attention)
SSM = "mamba2-2.7b"
#: the SSM's per-head and norm parameters, perturbed as the norms are
SSM_NOISY = ("A_log", "dt_bias", "D_skip", "gn")


def _cfgs(name):
    """(reference config, port config) of one test configuration."""
    arch, kw = CFGS.get(name, (name, {}))
    return (ref_configs.smoke(ref_configs.get_arch(arch)).scaled(**kw),
            configs.smoke(configs.get_arch(arch)).scaled(**kw))


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max abs err {err} > {RTOL} * {scale}"


def _ref_params(cfg, seed=0):
    """The reference's init_lm as numpy, norms and biases perturbed."""
    p = ref_model.init_lm(jax.random.PRNGKey(seed), cfg, RefCtx())
    rng = np.random.RandomState(seed + 1)

    def perturb(path, leaf):
        a = np.asarray(leaf)
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name or name in ("bq", "bk", "bv") + SSM_NOISY:
            a = a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, p)


def _randn(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


# -- configs and kernel utilities ------------------------------------------------


@pytest.mark.parametrize("name", sorted(ref_configs.ARCHS))
def test_configs_match_reference(name):
    ref, port = ref_configs.get_arch(name), configs.get_arch(name)
    assert asdict(port) == asdict(ref)
    for a, b in ((port, ref), (configs.smoke(port), ref_configs.smoke(ref))):
        assert asdict(a) == asdict(b)
        assert (a.hd, a.padded_vocab, a.layer_pattern, a.param_count()) == \
            (b.hd, b.padded_vocab, b.layer_pattern, b.param_count())
    assert {k: asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: asdict(v) for k, v in ref_configs.SHAPES.items()}


@pytest.mark.parametrize("shape,axis,multiple", [((5, 7), 0, 4), ((3, 130, 2), 1, 128),
                                                 ((2, 128, 3), 1, 128), ((9,), -1, 8)])
def test_pad_to_and_cdiv_match_reference(shape, axis, multiple):
    x = _randn(shape, 1)
    want, n = ref_kcommon.pad_to(jnp.asarray(x), multiple, axis)
    got, m = pad_to(torch.from_numpy(x), multiple, axis)
    assert m == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cdiv(shape[axis], multiple) == ref_kcommon.cdiv(shape[axis], multiple)


def test_trunc_normal_is_bounded_and_seeded():
    g = torch.Generator().manual_seed(3)
    x = common.trunc_normal(g, (200_000,), 0.5)
    assert float(x.abs().max()) <= 1.0
    # the standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(x.std()) - 0.5 * 0.8796) < 0.005 and abs(float(x.mean())) < 0.005
    again = common.trunc_normal(torch.Generator().manual_seed(3), (200_000,), 0.5)
    assert torch.equal(x, again)


# -- norms, RoPE, MLP ----------------------------------------------------------


def test_rms_norm_rope_match_reference():
    x = _randn((2, 12, 4, 16), 1)
    w = _randn((16,), 2)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(w)), "rms_norm")
    pos = np.arange(5, 17)
    for theta in (10_000.0, 5_000_000.0):
        _close(common.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               ref_common.rope(jnp.asarray(x), jnp.asarray(pos), theta), "rope")
    xb = _randn((3, 1, 4, 16), 3)
    pb = np.array([0, 7, 300])
    _close(common.rope_batched(torch.from_numpy(xb), torch.from_numpy(pb), 5e6),
           ref_common.rope_batched(jnp.asarray(xb), jnp.asarray(pb), 5e6), "rope_batched")
    same = np.full(3, 9)
    assert torch.equal(common.rope_batched(torch.from_numpy(xb), torch.from_numpy(same)),
                       common.rope(torch.from_numpy(xb), torch.tensor([9])))


@pytest.mark.parametrize("name", ["yi-6b", "minitron-4b"])
def test_mlp_matches_reference(name):
    ref_cfg, cfg = _cfgs(name)
    p = jax.tree.map(np.asarray, ref_mlp.init_mlp(jax.random.PRNGKey(1), ref_cfg, RefCtx()))
    x = _randn((2, 9, cfg.d_model), 4)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ctx, rctx = ParallelCtx(), RefCtx()
    _close(port_mlp.apply_mlp(tp, torch.from_numpy(x), cfg, ctx),
           ref_mlp.apply_mlp(p, jnp.asarray(x), ref_cfg, rctx), "apply_mlp")
    x1 = x[:, :1]
    _close(port_mlp.apply_mlp_replicated(tp, torch.from_numpy(x1), cfg, ctx),
           ref_mlp.apply_mlp_replicated(p, jnp.asarray(x1), ref_cfg, rctx), "replicated")


# -- attention -----------------------------------------------------------------


def _attn_params(name):
    ref_cfg, cfg = _cfgs(name)
    p = jax.tree.map(np.asarray, ref_attn.init_attention(jax.random.PRNGKey(2), ref_cfg,
                                                         RefCtx()))
    rng = np.random.RandomState(5)
    p = {k: (v + 0.1 * rng.randn(*v.shape).astype(np.float32)
             if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v) for k, v in p.items()}
    return ref_cfg, cfg, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_apply_attention_matches_reference(name):
    ref_cfg, cfg, p, tp = _attn_params(name)
    x = _randn((2, 40, cfg.d_model), 6)
    want = ref_attn.apply_attention(p, jnp.asarray(x), ref_cfg, RefCtx())
    _close(attention.apply_attention(tp, torch.from_numpy(x), cfg, ParallelCtx()), want,
           "apply_attention")


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_attention_matches_reference(name, per_row):
    """Twelve steps into an 8-slot ring cache (so it wraps), the position a
    scalar or one per row; outputs and caches equal at every step."""
    ref_cfg, cfg, p, tp = _attn_params(name)
    B, cap = 3, 8
    rcache = ref_attn.init_kv_cache(ref_cfg, B, cap, RefCtx(), jnp.float32)
    cache = attention.init_kv_cache(cfg, B, cap, ParallelCtx(), torch.float32)
    offsets = np.array([0, 3, 5]) if per_row else np.zeros(B, np.int64)
    for step in range(12):
        x = _randn((B, 1, cfg.d_model), 100 + step)
        pos = (offsets + step).astype(np.int32) if per_row else step
        want, rcache = ref_attn.decode_attention(p, jnp.asarray(x), rcache, jnp.asarray(pos),
                                                 ref_cfg, RefCtx())
        got, cache = attention.decode_attention(tp, torch.from_numpy(x), cache,
                                                torch.as_tensor(pos), cfg, ParallelCtx())
        _close(got, want, f"step {step}")
        for k in ("k", "v", "slot_pos"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), rtol=0,
                                       atol=RTOL * float(np.abs(np.asarray(rcache["k"])).max()))


# -- the whole model -----------------------------------------------------------


def test_init_lm_layout_matches_reference():
    """Same nesting, leaf names, shapes and dtypes as the reference's tree,
    for every configuration of the slice."""
    for name in CFGS:
        ref_cfg, cfg = _cfgs(name)
        want = jax.eval_shape(lambda c=ref_cfg: ref_model.init_lm(jax.random.PRNGKey(0), c,
                                                                   RefCtx()))
        got = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        flat = [(path, tuple(t.shape)) for path, t in tree_leaves_with_path(got)]
        ref_flat = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
                     tuple(leaf.shape)) for path, leaf in jax.tree_util.tree_leaves_with_path(want)]
        assert flat == ref_flat, name
        assert all(t.dtype == torch.float32 for _, t in tree_leaves_with_path(got))
    bf = init_lm(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in tree_leaves_with_path(bf))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_lm_prefill_matches_reference(name):
    """The reference runs kernel E's Pallas body in interpret mode; the port
    its CPU dispatch (the refs), which agrees at Sq == Skv."""
    ref_cfg, cfg = _cfgs(name)
    np_params = _ref_params(ref_cfg)
    tokens = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want = jax.jit(lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, RefCtx(), capacity=40,
                                                     interp=True))(np_params, tokens)
    params = params_from_reference(np_params, cfg, device="cpu")
    got = lm_prefill(params, torch.from_numpy(tokens), cfg, ParallelCtx(), capacity=40)
    _close(got, want, "lm_prefill")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_lm_decode_step_matches_reference(name):
    """Twenty steps over a 12-slot cache (windowed layers hold 12 too), the
    positions one per row and wrapping; logits equal at every step."""
    ref_cfg, cfg = _cfgs(name)
    np_params = _ref_params(ref_cfg, seed=1)
    params = params_from_reference(np_params, cfg, device="cpu")
    B, cap = 2, 12
    rcaches = ref_model.lm_caches(ref_cfg, B, cap, RefCtx())
    caches = lm_caches(cfg, B, cap, ParallelCtx(), device="cpu")
    step_fn = jax.jit(lambda p, c, t, pos: ref_model.lm_decode_step(p, c, t, pos, ref_cfg,
                                                                    RefCtx()))
    rng = np.random.RandomState(8)
    for step in range(20):
        tok = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
        pos = np.array([step, step + 2], np.int32)
        want, rcaches = step_fn(np_params, rcaches, tok, pos)
        got, caches = lm_decode_step(params, caches, torch.from_numpy(tok), torch.from_numpy(pos),
                                     cfg, ParallelCtx())
        assert got.shape == (B, cfg.padded_vocab) and got.dtype == torch.float32
        _close(got, want, f"step {step}")


# -- the Mamba2 (ssm) block -------------------------------------------------------


def test_softplus_and_causal_conv_match_reference():
    x = np.concatenate([np.linspace(-40, 40, 161), _randn((64,), 20)]).astype(np.float32)
    _close(ssm.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)), "softplus")
    # above 20 both are log(1 + exp(x)), not PyTorch's softplus threshold
    assert float(ssm.softplus(torch.tensor([30.0]))) == float(jax.nn.softplus(30.0))
    xb = _randn((2, 11, 24), 21)
    w = _randn((4, 24), 22)
    _close(ssm._causal_conv(torch.from_numpy(xb), torch.from_numpy(w)),
           ref_ssm._causal_conv(jnp.asarray(xb), jnp.asarray(w)), "causal_conv")


def _ssm_block_params(seed=3):
    ref_cfg, cfg = _cfgs(SSM)
    p = jax.tree.map(np.asarray, ref_ssm.init_ssm(jax.random.PRNGKey(seed), ref_cfg, RefCtx()))
    rng = np.random.RandomState(seed)
    p = {k: (v + 0.1 * rng.randn(*v.shape).astype(np.float32) if k in SSM_NOISY else v)
         for k, v in p.items()}
    return ref_cfg, cfg, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def test_init_ssm_layout_matches_reference():
    ref_cfg, cfg, p, _ = _ssm_block_params()
    got = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, ParallelCtx())
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in p.items()}
    assert (got["A_log"] == 0).all() and (got["D_skip"] == 1).all() and (got["gn"] == 1).all()


@pytest.mark.parametrize("S", [40, 200])
def test_apply_ssm_matches_reference(S):
    ref_cfg, cfg, p, tp = _ssm_block_params()
    x = _randn((2, S, cfg.d_model), 23)
    want = ref_ssm.apply_ssm(p, jnp.asarray(x), ref_cfg, RefCtx())
    _close(ssm.apply_ssm(tp, torch.from_numpy(x), cfg, ParallelCtx()), want, "apply_ssm")


def test_decode_ssm_matches_reference():
    """Twelve steps (the conv window fills and shifts); outputs and the
    conv windows and state of the cache equal at every step."""
    ref_cfg, cfg, p, tp = _ssm_block_params(seed=4)
    B = 3
    rcache = ref_ssm.init_ssm_cache(ref_cfg, B, RefCtx(), jnp.float32)
    cache = ssm.init_ssm_cache(cfg, B, ParallelCtx(), torch.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in rcache.items()}
    for step in range(12):
        x = _randn((B, 1, cfg.d_model), 200 + step)
        want, rcache = ref_ssm.decode_ssm(p, jnp.asarray(x), rcache, ref_cfg, RefCtx())
        got, cache = ssm.decode_ssm(tp, torch.from_numpy(x), cache, cfg, ParallelCtx())
        _close(got, want, f"step {step}")
        for k in ("conv_x", "conv_bc", "state"):
            _close(cache[k], rcache[k], f"step {step} {k}")


def test_ssm_init_lm_layout_matches_reference():
    ref_cfg, cfg = _cfgs(SSM)
    want = jax.eval_shape(lambda: ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, RefCtx()))
    got = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = [(path, tuple(t.shape)) for path, t in tree_leaves_with_path(got)]
    ref_flat = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
                 tuple(leaf.shape)) for path, leaf in jax.tree_util.tree_leaves_with_path(want)]
    assert flat == ref_flat
    assert set(got["stack"]["periods"][0]) == {"norm1", "ssm"}


@pytest.mark.parametrize("S", [200, 300])
def test_ssm_lm_prefill_matches_reference(S):
    """S = 200 and 300 pad the scan to 256 and 384 (chunks of 128) and
    carry the state across two and three chunks.  The reference runs the
    Pallas scan in interpret mode; the port its CPU dispatch."""
    ref_cfg, cfg = _cfgs(SSM)
    np_params = _ref_params(ref_cfg)
    tokens = np.random.RandomState(24).randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want = jax.jit(lambda p, t: ref_model.lm_prefill(p, t, ref_cfg, RefCtx(), capacity=S,
                                                     interp=True))(np_params, tokens)
    params = params_from_reference(np_params, cfg, device="cpu")
    got = lm_prefill(params, torch.from_numpy(tokens), cfg, ParallelCtx(), capacity=S)
    _close(got, want, "lm_prefill")


def test_ssm_lm_decode_step_matches_reference():
    """Twenty decode steps through the (conv window, state) caches; logits
    equal at every step."""
    ref_cfg, cfg = _cfgs(SSM)
    np_params = _ref_params(ref_cfg, seed=1)
    params = params_from_reference(np_params, cfg, device="cpu")
    B = 2
    rcaches = ref_model.lm_caches(ref_cfg, B, 12, RefCtx())
    caches = lm_caches(cfg, B, 12, ParallelCtx(), device="cpu")
    step_fn = jax.jit(lambda p, c, t, pos: ref_model.lm_decode_step(p, c, t, pos, ref_cfg,
                                                                    RefCtx()))
    rng = np.random.RandomState(25)
    for step in range(20):
        tok = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
        pos = np.array([step, step + 2], np.int32)
        want, rcaches = step_fn(np_params, rcaches, tok, pos)
        got, caches = lm_decode_step(params, caches, torch.from_numpy(tok), torch.from_numpy(pos),
                                     cfg, ParallelCtx())
        _close(got, want, f"step {step}")
    for (path, leaf), want_leaf in zip(tree_leaves_with_path(caches), jax.tree.leaves(rcaches),
                                       strict=True):
        _close(leaf, want_leaf, f"cache {path}")


# -- the families and options once refused ---------------------------------------


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "musicgen-medium"])
def test_rec_and_codebook_families_init_like_the_reference(name):
    """The RG-LRU hybrid and the codebook model, once refused (items 11 and
    12), draw params of the reference's shapes, leaf for leaf in its flatten
    order (the rec blocks' gate vectors, the codebooks' embeddings and
    heads)."""
    ref_cfg = ref_configs.smoke(ref_configs.get_arch(name))
    cfg = configs.smoke(configs.get_arch(name))
    want = jax.eval_shape(lambda: ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, RefCtx()))
    got = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [(tuple(t.shape), t.dtype) for _, t in tree_leaves_with_path(got)] == \
        [(tuple(a.shape), torch.float32) for a in jax.tree.leaves(want)]
    assert ("embed_cb" in got) == (cfg.n_codebooks > 1)


def test_unknown_block_kind_raises():
    """A block kind outside the reference's four raises ``ValueError``, as
    the reference's does."""
    from repro_torch.models.transformer import init_block

    cfg = configs.smoke(configs.get_arch("yi-6b"))
    with pytest.raises(ValueError, match="unknown block kind"):
        init_block(torch.Generator().manual_seed(0), "conv", cfg, ParallelCtx())


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"])
def test_moe_families_init_like_the_reference(name):
    """The MoE families, once refused (item 10), draw params of the
    reference's shapes, leaf for leaf in its flatten order (llama4-scout's
    shared expert included)."""
    ref_cfg = ref_configs.smoke(ref_configs.get_arch(name))
    cfg = configs.smoke(configs.get_arch(name))
    want = jax.eval_shape(lambda: ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, RefCtx()))
    got = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [(tuple(t.shape), t.dtype) for _, t in tree_leaves_with_path(got)] == \
        [(tuple(a.shape), torch.float32) for a in jax.tree.leaves(want)]
    assert ("shared" in got["stack"]["periods"][0]["moe"]) == cfg.shared_expert


def test_ssm_specs_at_tp4():
    """mamba2's layout at tp = 4, once refused (item 14): the inner width
    and its heads split over the model axis, B/C replicated."""
    from repro_torch.interop import shard_params
    from repro_torch.mesh.api import PartitionSpec as PS
    from repro_torch.models import lm_specs

    cfg = configs.smoke(configs.get_arch(SSM))
    ctx = make_ctx((1, 4), comm_mode="smi:static", device="cpu")
    blk = lm_specs(cfg, ctx)["stack"]["periods"][0]["ssm"]
    assert blk["w_x"] == PS(None, None, "model") and blk["w_bc"] == PS(None, None, None)
    assert blk["dt_bias"] == PS(None, "model") and blk["conv_bc"] == PS(None, None, None)
    sp = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, ctx)
    d_in = cfg.ssm_expand * cfg.d_model
    assert tuple(sp["stack"]["periods"][0]["ssm"]["w_x"].shape) == \
        (cfg.n_layers, 4, cfg.d_model, d_in // 4)


def _fsdp_at_2x4():
    """FSDP over the data axis (once refused): the prefill on FSDP-stored
    weights equals the one on replicated weights, bit for bit."""
    from repro_torch.interop import shard_params
    from repro_torch.launch.steps import build_prefill

    cfg = configs.smoke(configs.get_arch("yi-6b"))
    shape = configs.ShapeConfig("t", 32, 2, "prefill")
    tok = torch.arange(64, dtype=torch.int32).reshape(2, 32) % cfg.vocab_size
    out = []
    for fsdp in (True, False):
        pre = build_prefill(cfg, shape, mesh=(2, 4), comm_mode="smi:static", fsdp=fsdp,
                            device="cpu")
        params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=pre.ctx)
        out.append(pre(shard_params(params, cfg, pre.ctx, pre.plan), tok))
        assert (pre.plan is not None) == fsdp
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("kw", [
    _fsdp_at_2x4,                                               # FSDP over the data axis (13)
])
def test_tensor_parallel_options_raise(kw):
    """What tensor parallelism once refused runs (FSDP over the data axis,
    item 13); a mesh without a model axis, and any comm mode without a
    mesh, is tensor-parallel degree 1."""
    kw()
    assert make_ctx((1, 1)).tp == 1 and make_ctx().rank() == 0
    assert make_ctx(comm_mode="smi").tp == 1 and make_ctx(comm_mode="bulk").tp == 1


@pytest.mark.parametrize("kw, dp, tp, ring", [
    (lambda: make_ctx((2, 4), device="cpu"), 2, 4, False),               # a data axis
    (lambda: make_ctx((2, 4), comm_mode="smi:static", device="cpu"), 2, 4, False),
    (lambda: make_ctx((2, 4), comm_mode="smi", plan="auto", device="cpu"), 2, 4, False),
    (lambda: make_ctx(opt_ring_attn=True), 1, 1, True),                  # ring attention
])
def test_data_axis_and_ring_attention_contexts(kw, dp, tp, ring):
    """The contexts the tensor-parallel options once refused: a data axis of
    two groups beside the model ring, and ring attention."""
    ctx = kw()
    assert (ctx.dp, ctx.tp, ctx.opt_ring_attn) == (dp, tp, ring)
    assert ctx.batch_axes == (("data",) if dp > 1 else ())


def test_extra_embeds_take_the_patch_positions():
    """Frontend embeddings, once refused (item 12), take the first positions
    of the embedding; the rest are the tokens' rows, as the reference's."""
    ref_cfg, cfg = _cfgs("internvl2-1b")
    np_params = _ref_params(ref_cfg)
    params = params_from_reference(np_params, cfg, device="cpu")
    from repro_torch.models.model import embed_tokens_sp

    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    extra = _randn((1, 2, cfg.d_model), 3, 0.02)
    got = embed_tokens_sp(params, torch.from_numpy(tokens), cfg, ParallelCtx(),
                          extra_embeds=torch.from_numpy(extra))
    want = ref_model.embed_tokens_sp(np_params, tokens, ref_cfg, RefCtx(), extra_embeds=extra)
    assert torch.equal(got[:, :2], torch.from_numpy(extra))
    _close(got, want, "embed_tokens_sp")
