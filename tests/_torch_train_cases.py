"""Shared cases and helpers of the port's training tests
(tests/test_torch_train*.py): the smoke configs of both packages, their
inputs, and the port's loss and gradients.  numpy and the port only; the
reference's configs come in through ``ref_configs``."""

import numpy as np
import torch

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.interop import unshard_tree
from repro_torch.models import lm_loss, lm_specs
from repro_torch.models.common import tree_leaves_with_path, tree_unflatten

ARCHS = ("yi-6b", "mamba2-2.7b", "qwen3-moe-30b-a3b", "recurrentgemma-9b", "internvl2-1b",
         "musicgen-medium")
B, S = 2, 32
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def cfgs(arch, P=1):
    """The smoke config of both packages, cut so that heads (and experts)
    split whole over P ranks at P = 8; the hybrid at 5 layers (one period
    and two remainder layers)."""
    ref_cfg = ref_configs.smoke(ref_configs.get_arch(arch))
    cfg = configs.smoke(configs.get_arch(arch))
    kw = {}
    if P == 8 and cfg.family != "ssm":
        kw["n_heads"] = 8
    if P == 8 and cfg.family == "moe":
        kw["n_experts"] = 8
    if cfg.family == "hybrid":
        kw.update(n_layers=5, n_heads=8)
    return ref_cfg.scaled(**kw), cfg.scaled(**kw)


def inputs(cfg, seed=0):
    """Tokens and labels (some -100) and a vision model's patch embeddings,
    as numpy."""
    rng = np.random.RandomState(seed)
    shp = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    tok = rng.randint(0, cfg.vocab_size, shp).astype(np.int32)
    lab = rng.randint(0, cfg.vocab_size, shp).astype(np.int32)
    lab[0, :3] = -100
    extra = None
    if cfg.frontend == "vit_stub":
        extra = (rng.randn(B, cfg.n_patches, cfg.d_model) * 0.02).astype(np.float32)
    return tok, lab, extra


def port_grads(params, tok, lab, extra, cfg, ctx, **kw):
    """(loss, gradient tree) of the port's lm_loss; rank-stacked grads
    unsharded."""
    leaves = [t.requires_grad_(True) for _, t in tree_leaves_with_path(params)]
    loss, _ = lm_loss(params, torch.from_numpy(tok), torch.from_numpy(lab), cfg, ctx,
                      extra_embeds=None if extra is None else torch.from_numpy(extra), **kw)
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    if ctx.tp > 1:
        grads = unshard_tree(grads, lm_specs(cfg, ctx), ctx)
    return float(loss.detach()), grads


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
