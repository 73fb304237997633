"""The port's training loss and gradients against the reference's, on the
CPU (smoke configs, float32).

* ``lm_loss`` and every leaf's gradient against ``jax.value_and_grad`` of
  the reference's ``lm_loss`` at tp = 1, for the six families (yi-6b,
  mamba2-2.7b, qwen3-moe-30b-a3b, recurrentgemma-9b, internvl2-1b with its
  patch embeddings, musicgen-medium with its codebooks), ``remat`` ``none``
  and ``nothing``, ``loss_chunks`` 1 and 2, some labels ``-100``: the loss
  within 1e-5, each leaf within 1e-4 relative Frobenius error.  The
  reference's Pallas kernels run their plain paths on the CPU.
* The reference's tensor-parallel gradients are wrong (every sharded leaf
  tp times too large): :func:`test_reference_tp_gradients_overcount` pins
  that fault, and ``tests/test_torch_train_tp.py`` holds the port's
  tensor-parallel gradients against its tp = 1 gradients instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

from repro.launch.mesh import make_mesh
from repro.mesh.api import ParallelCtx as RefCtx
from repro.mesh.api import make_ctx as ref_make_ctx
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.interop import params_from_reference
from repro_torch.mesh.api import make_ctx
from repro_torch.models.common import tree_leaves_with_path

from _torch_train_cases import ARCHS, GRAD_TOL, LOSS_TOL
from _torch_train_cases import cfgs as _cfgs
from _torch_train_cases import inputs as _inputs
from _torch_train_cases import port_grads as _port_grads
from _torch_train_cases import rel as _rel


@functools.lru_cache(maxsize=None)
def _mesh(dims):
    return make_mesh(dims, ("data", "model"))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    ref_cfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, RefCtx()))


CASES = [(a, "none", 1) for a in ARCHS] + [(a, "nothing", 2) for a in ARCHS] + \
    [("yi-6b", "none", 2), ("yi-6b", "nothing", 1)]


@pytest.mark.parametrize("arch,remat,chunks", CASES)
def test_loss_and_grads_match_reference(arch, remat, chunks):
    ref_cfg, cfg = _cfgs(arch)
    tok, lab, extra = _inputs(cfg)
    p = _ref_params(arch)

    def lf(pp):
        loss, _ = ref_model.lm_loss(pp, jnp.asarray(tok), jnp.asarray(lab), ref_cfg, RefCtx(),
                                    extra_embeds=None if extra is None else jnp.asarray(extra),
                                    remat=remat, loss_chunks=chunks)
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(lf))(jax.tree.map(jnp.asarray, p))
    got_loss, got = _port_grads(params_from_reference(p, cfg, device="cpu"), tok, lab, extra,
                                cfg, make_ctx(device="cpu"), remat=remat, loss_chunks=chunks)
    assert abs(got_loss - float(want_loss)) <= LOSS_TOL * max(1.0, abs(float(want_loss)))
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree_leaves_with_path(got)
    assert len(got_leaves) == len(want_leaves)
    for (path, g), w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape, path
        assert np.abs(np.asarray(w)).max() > 0, path
        assert _rel(g.numpy(), w) <= GRAD_TOL, (path, _rel(g.numpy(), w))


def test_reference_tp_gradients_overcount():
    """The reference's fault, pinned: ``jax.value_and_grad(lm_loss)`` inside
    ``shard_map(check_vma=False)`` over a (1, 4) mesh, as its
    ``build_train`` runs it, gives the loss of tp = 1 but every
    model-sharded leaf's gradient 4x (tp x) tp = 1's (each rank seeds the
    replicated loss with 1 and the psum transposes add the seeds), and a
    replicated leaf's one rank's partial sum (``final_norm`` neither 1x nor
    4x).  The port holds the true gradient (the other tests).  This test
    fails the day the reference is fixed."""
    ref_cfg, _ = _cfgs("yi-6b")
    tp = 4
    ctx = ref_make_ctx(_mesh((1, tp)), comm_mode="smi:static")
    p = ref_model.init_lm(jax.random.PRNGKey(0), ref_cfg, ctx)
    specs = ref_model.lm_specs(ref_cfg, ctx)
    tok, lab, _ = _inputs(configs.smoke(configs.get_arch("yi-6b")), seed=2)
    tok, lab = jnp.asarray(tok), jnp.asarray(lab)

    def loss1(pp):
        return ref_model.lm_loss(pp, tok, lab, ref_cfg, RefCtx(), remat="none")[0]

    def sharded(pp, t, lb):
        return jax.value_and_grad(lambda q: ref_model.lm_loss(q, t, lb, ref_cfg, ctx,
                                                              remat="none")[0])(pp)

    l1, g1 = jax.jit(jax.value_and_grad(loss1))(p)
    lt, gt = jax.jit(jax.shard_map(sharded, mesh=_mesh((1, tp)), in_specs=(specs, PS(), PS()),
                                   out_specs=(PS(), specs), check_vma=False))(p, tok, lab)
    assert abs(float(lt) - float(l1)) < 1e-5
    ratios = {}
    for (path, a), b, sp in zip(jax.tree_util.tree_flatten_with_path(gt)[0],
                                jax.tree.leaves(g1), jax.tree.leaves(
                                    specs, is_leaf=lambda x: isinstance(x, PS))):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        name = jax.tree_util.keystr(path)
        ratios[name] = float((a * b).sum() / (b * b).sum())
        if any(d == "model" for d in tuple(sp)):
            assert np.linalg.norm(a - tp * b) <= 1e-4 * np.linalg.norm(tp * b), name
    fn = ratios["['final_norm']"]
    assert abs(fn - 1) > 0.01 and abs(fn - tp) > 0.01, fn
