"""Shared helpers of the port's data-axis training tests
(tests/test_torch_train_dp*.py, tests/test_torch_remat.py): smoke configs
with whole heads at P = 4, a seeded batch, and the port's gradients of one
batch on a mesh, unsharded."""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.interop import unshard_params
from repro_torch.launch.steps import TrainSettings, build_train
from repro_torch.parallel import ledger

ARCHS = ("yi-6b", "mamba2-2.7b", "qwen3-moe-30b-a3b", "recurrentgemma-9b", "internvl2-1b",
         "musicgen-medium")
S, B = 32, 4


def cfg_of(arch):
    """The smoke config, with whole heads at P = 4."""
    cfg = configs.smoke(configs.get_arch(arch))
    return cfg.scaled(n_heads=4) if cfg.n_heads % 4 and cfg.family != "ssm" else cfg


def batch_of(cfg, seed=0):
    rng = np.random.RandomState(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    tok = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": tok, "labels": tok.copy()}
    if cfg.frontend == "vit_stub":
        batch["pixel_embeds"] = (rng.randn(B, cfg.n_patches, cfg.d_model) * 0.02).astype(
            np.float32)
    return batch


def grads_on(cfg, mesh, batch, **kw):
    """``(loss, global gradients, art, ledger)`` of one batch at ``mesh``
    (``TrainSettings`` fields in ``kw``), the params ``init_params(0)``."""
    st = TrainSettings(comm_mode=kw.pop("comm_mode", "smi:static"), remat="nothing",
                       loss_chunks=1, **kw)
    art = build_train(cfg, configs.ShapeConfig("t", S, B, "train"), st, mesh=mesh,
                      device="cpu")
    params = art["init_params"](0)
    with ledger.capture() as led:
        loss, _, g = art["grads"](params, batch)
    return loss, unshard_params(g, cfg, art["ctx"], art["plan"]), art, led


@pytest.fixture(scope="module", autouse=False)
def one_thread():
    """Torch's CPU ops on one thread for a module's tests (restored after):
    these small models' steps gain nothing from more, and on a worker that
    shares its cores with five others the thread teams' waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
