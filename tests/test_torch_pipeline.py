"""GPipe over a chain channel in the port (``repro_torch.core.pipeline``)
against ``repro.core.pipeline`` (``tests/test_pipeline.py``'s cases).

* ``pipeline_apply`` delivers the reference's outputs at the last stage
  (zeros elsewhere), and ``pipeline_loss`` the reference's loss and every
  stage's gradients, the reference run under ``shard_map`` on the host
  devices with the same inputs;
* both equal the stages run one after another (the reference's own
  oracle);
* the chain channel tallies M + P - 1 hops under ``pp.stage`` (the
  reference's ledger count), and falls back to the static wire for the
  packet router and the int8 wire (``stage_transport``);
* a product stage on kernel D's wrapper (its plain version on the CPU)
  matches the sequential stages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.core import Communicator as RefComm
from repro.core import make_test_mesh
from repro.core.pipeline import pipeline_apply as ref_apply
from repro.core.pipeline import pipeline_loss as ref_loss
from repro.parallel import ledger as ref_ledger
from repro_torch.core import Communicator
from repro_torch.core.pipeline import pipeline_apply, pipeline_loss
from repro_torch.kernels.matmul import matmul
from repro_torch.parallel import ledger, stage_transport
from repro_torch.transport.static import StaticTransport

PP = 4


def _ref_stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b[:, None])


def _data(seed, D, M, mb):
    rng = np.random.RandomState(seed)
    return (rng.randn(PP, D, D).astype(np.float32) * 0.4,
            rng.randn(PP, D).astype(np.float32) * 0.1,
            rng.randn(M, mb, D).astype(np.float32),
            rng.randn(M, mb, D).astype(np.float32))


def _comm():
    return Communicator.create("pp", (PP,), device="cpu")


@pytest.mark.parametrize("seed, D, M, mb", [(0, 6, 5, 3), (1, 4, 4, 2), (2, 8, 1, 1)])
def test_pipeline_apply_equals_reference(seed, D, M, mb):
    Ws, Bs, X, _ = _data(seed, D, M, mb)
    mesh = make_test_mesh((PP,), ("pp",))
    rc = RefComm.create("pp", (PP,))
    with ref_ledger.capture() as rled:
        want = np.asarray(jax.jit(jax.shard_map(
            lambda w, b, x: ref_apply(_ref_stage, (w[0], b[0]), x, rc)[None], mesh=mesh,
            in_specs=(JP("pp"), JP("pp"), JP()), out_specs=JP("pp")))(
                jnp.asarray(Ws), jnp.asarray(Bs), jnp.asarray(X)))
    with ledger.capture() as led:
        got = pipeline_apply(_stage, (torch.from_numpy(Ws), torch.from_numpy(Bs)),
                             torch.from_numpy(X), _comm())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[:PP - 1].any()
    seq = X.copy()
    for s in range(PP):
        seq = np.tanh(seq @ Ws[s] + Bs[s])
    np.testing.assert_allclose(got[PP - 1].numpy(), seq, rtol=1e-5, atol=1e-5)
    assert led.by_tag["pp.stage"] == rled.by_tag["pp.stage"] == \
        {"steps": M + PP - 1, "bytes": (M + PP - 1) * mb * D * 4}


@pytest.mark.parametrize("seed, D, M, mb", [(1, 4, 4, 2), (3, 6, 3, 2)])
def test_pipeline_loss_and_gradients_equal_reference(seed, D, M, mb):
    Ws, Bs, X, Y = _data(seed, D, M, mb)
    mesh = make_test_mesh((PP,), ("pp",))
    rc = RefComm.create("pp", (PP,))

    def value_and_grads(w, b, x, y):
        def f(wb):
            return ref_loss(_ref_stage, lambda p, t: jnp.mean((p - t) ** 2), (wb[0][0], wb[1][0]),
                            x, y, rc)

        l, g = jax.value_and_grad(f)((w, b))
        return l[None], g[0], g[1]

    lv, gw, gb = jax.jit(jax.shard_map(
        value_and_grads, mesh=mesh, in_specs=(JP("pp"), JP("pp"), JP(), JP()),
        out_specs=(JP("pp"), JP("pp"), JP("pp"))))(*map(jnp.asarray, (Ws, Bs, X, Y)))
    w = torch.from_numpy(Ws).requires_grad_(True)
    b = torch.from_numpy(Bs).requires_grad_(True)
    loss = pipeline_loss(_stage, lambda p, t: ((p - t) ** 2).mean(), (w, b),
                         torch.from_numpy(X), torch.from_numpy(Y), _comm())
    got_w, got_b = torch.autograd.grad(loss, (w, b))
    np.testing.assert_allclose(float(loss.detach()), np.asarray(lv)[0], rtol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-6)
    assert all(float(got_w[s].abs().max()) > 0 for s in range(PP))
    # the stages one after another
    w2 = torch.from_numpy(Ws).requires_grad_(True)
    b2 = torch.from_numpy(Bs).requires_grad_(True)
    h = torch.from_numpy(X)
    for s in range(PP):
        h = torch.tanh(h @ w2[s] + b2[s])
    seq = ((h - torch.from_numpy(Y)) ** 2).mean(dim=(1, 2)).mean()
    sw, sb = torch.autograd.grad(seq, (w2, b2))
    torch.testing.assert_close(loss, seq, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got_w, sw, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_b, sb, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["static", "fused", "packet", "compressed", "compressed:fused"])
def test_stage_transport_keeps_an_exact_wire(key):
    comm = Communicator.create("pp", (PP,), transport=key, device="cpu")
    spec, t = stage_transport(comm)
    assert spec.stats_tag == "pp.stage"
    if key.startswith("compressed") or key == "packet":
        assert type(t) is StaticTransport
    else:
        assert t.name == key


def test_product_stages_on_kernel_d_equal_sequential():
    """The chip's GPipe stage at small size: a product on kernel D's
    wrapper then a GELU, in bfloat16; the pipeline and the stages run one
    after another give the same bits (one rank-stacked product a tick
    against one product a stage)."""
    rng = np.random.RandomState(4)
    D, M, mb = 32, 6, 8
    W = torch.from_numpy(rng.randn(PP, D, D).astype(np.float32) * D ** -0.5).bfloat16()
    X = torch.from_numpy(rng.randn(M, mb, D).astype(np.float32)).bfloat16()

    def stage(w, x):
        return torch.nn.functional.gelu(matmul(x, w))

    got = pipeline_apply(stage, W, X, _comm())[PP - 1]
    for m in range(M):
        h = X[m]
        for s in range(PP):
            h = torch.nn.functional.gelu(matmul(h.unsqueeze(0), W[s:s + 1]))[0]
        assert torch.equal(got[m], h), m
