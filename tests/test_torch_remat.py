"""The remat policies that save the matrix products (``"dots"``,
``"dots_nb"``; ``models/transformer.py recomputed``) at tp = 1, over the
model axis and over a (2, 4) mesh with FSDP.

* they give ``"none"``'s loss and gradients bit for bit;
* ``"dots"`` recomputes no product: its backward dispatches as many
  products as ``"none"``'s (which recomputes nothing), ``"nothing"`` more;
  with kernel D's dispatcher op on the tensor-parallel GEMMs (its CPU
  kernel, the plain product) the policy saves its outputs too;
* the defaults are the reference's (``"dots"`` in ``lm_loss`` and
  ``apply_stack``, ``"nothing"`` and FSDP on in ``TrainSettings``).
"""

from __future__ import annotations

import inspect

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_dp_cases import B, S, one_thread  # noqa: F401 (the module's fixture)
from _torch_dp_cases import batch_of as _batch
from _torch_dp_cases import cfg_of as _cfg
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels.matmul.ops import MatmulFn, _matmul_launch, matmul_op
from repro_torch.launch.steps import TrainSettings, build_train
from repro_torch.models import lm_loss, transformer
from repro_torch.models.common import tree_flatten

pytestmark = pytest.mark.usefixtures("one_thread")


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        a = torch.ops.aten
        if func in (a.mm.default, a.bmm.default, a.addmm.default, a.baddbmm.default, matmul_op):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mesh, kernel_op", [(None, False), ((1, 4), True), ((2, 4), False)],
                         ids=["tp1", "tp4_kernel_op", "dp2_tp4"])
def test_dots_policies_save_the_products(mesh, kernel_op):
    cfg = _cfg("yi-6b")
    mm = (lambda x, w: MatmulFn.apply(_matmul_launch, x, w, x.dtype)) if kernel_op else None
    art = build_train(cfg, configs.ShapeConfig("t", S, B, "train"),
                      TrainSettings(comm_mode="smi:static"), mesh=mesh, matmul_fn=mm,
                      device="cpu")
    params = art["init_params"](0)
    tok = torch.from_numpy(_batch(cfg)["tokens"][: B // art["ctx"].dp])
    out = {}
    for remat in ("none", "dots", "dots_nb", "nothing"):
        loss, _ = lm_loss(params, tok, tok, cfg, art["ctx"], remat=remat, fsdp_plan=art["plan"])
        count = _Products()
        with count:
            g = torch.autograd.grad(loss, tree_flatten(params))
        out[remat] = (loss, g, count.n)
    for remat in ("dots", "dots_nb"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))
    assert out["dots"][2] == out["none"][2] < out["nothing"][2]
    assert out["none"][2] <= out["dots_nb"][2] <= out["nothing"][2]


def test_dots_nb_recomputes_scores_whose_batch_equals_tp():
    """At tp = 4 with one sequence and one query head a rank, attention's
    score products flatten to a batch of 4 = tp, the shape of a
    rank-stacked projection.  ``"dots_nb"`` still recomputes them (it tells
    the projections by how they are called, not by their shape), so its
    backward dispatches two products a layer more than ``"dots"``'s, which
    saves every one: the recomputed ``QKᵀ`` and ``PV``, and no projection;
    the gradients stay ``"none"``'s."""
    cfg = _cfg("yi-6b")
    art = build_train(cfg, configs.ShapeConfig("t", S, 1, "train"),
                      TrainSettings(comm_mode="smi:static"), mesh=(1, 4), device="cpu")
    assert cfg.n_heads // art["ctx"].tp == 1
    params = art["init_params"](0)
    tok = torch.from_numpy(_batch(cfg)["tokens"][:1])
    out = {}
    for remat in ("none", "dots", "dots_nb"):
        loss, _ = lm_loss(params, tok, tok, cfg, art["ctx"], remat=remat)
        count = _Products()
        with count:
            g = torch.autograd.grad(loss, tree_flatten(params))
        out[remat] = (g, count.n)
    assert all(torch.equal(a, b) for a, b in zip(out["dots_nb"][0], out["none"][0]))
    assert out["dots"][1] == out["none"][1]
    assert out["dots_nb"][1] - out["dots"][1] == 2 * cfg.n_layers


def test_default_remat_is_the_references():
    for port, ref in ((lm_loss, ref_model.lm_loss), (transformer.apply_stack, ref_tf.apply_stack)):
        assert inspect.signature(port).parameters["remat"].default == \
            inspect.signature(ref).parameters["remat"].default == "dots"
    assert TrainSettings().remat == ref_steps.TrainSettings().remat
    assert TrainSettings().fsdp == ref_steps.TrainSettings().fsdp
