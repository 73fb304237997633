"""The port's launch layer at parity with the reference's (CPU, the smoke
yi-6b in float32):

* ``TRANSPORT_BACKENDS`` and ``COMM_MODES`` equal the reference's, order
  included, and every launcher's ``--comm-mode`` takes each mode;
* training over ``smi:compressed`` at (1, 4) and (2, 4): every tag of the
  ledger equals ``predict_train_step_stats(eager=True)``; the loss is
  within 1e-3 relative of the reference's ``build_train`` step on the same
  weights and batch (the int8 codes are the reference's; XLA fuses a
  dequantise into the next add where the port rounds twice); each leaf's
  gradient holds a cosine of at least 0.99 to the port's own
  ``smi:static`` gradient (the int8 wire is straight-through under
  autograd); ``launch.train --validate-comm`` exits 0 at ``1,8`` and
  ``2,4``;
* the reference's int8 wire has no gradient (its rounding's): its
  ``smi:compressed`` gradient norm is under half its ``smi:static`` one at
  (1, 4) -- pinned, so that a fix there is seen;
* training over ``bulk`` at (2, 4): the loss within 1e-5 of
  ``smi:static``'s; ``--validate-comm`` refuses ``bulk`` (the reference's
  prediction models the smi modes only);
* ``launch.stencil --comm-mode smi:compressed`` within the reference's
  bound (max error under 1e-1) of the single-rank sweep, and ``bulk``
  refused (the halos have no channel in it).
"""

import functools

import numpy as np
import pytest
import torch

from _torch_dp_cases import B, S, one_thread  # noqa: F401 (the module's fixture)
from _torch_dp_cases import batch_of, cfg_of
from repro_torch import configs
from repro_torch.interop import shard_train_state, train_state_from_reference, unshard_params
from repro_torch.launch import dryrun as launch_dryrun
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import stencil as launch_stencil
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import TrainSettings, build_train
from repro_torch.models.common import tree_flatten
from repro_torch.netsim import predict_train_step_stats
from repro_torch.parallel import ledger

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_RTOL = 1e-3       # smi:compressed against the reference's step
GRAD_COS = 0.99        # smi:compressed against the port's smi:static, a leaf
BULK_LOSS_TOL = 1e-5   # bulk against smi:static


def test_mode_tables_equal_reference():
    from repro.configs import registry as ref

    assert configs.TRANSPORT_BACKENDS == ref.TRANSPORT_BACKENDS
    assert configs.COMM_MODES == ref.COMM_MODES


@pytest.mark.parametrize("launcher", [launch_train, launch_stencil, launch_dryrun, launch_serve],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_launchers_take_every_comm_mode(launcher, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(["--help"])
    assert e.value.code == 0
    assert "{" + ",".join(configs.COMM_MODES) + "}" in capsys.readouterr().out


# -- training over smi:compressed and bulk -------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_step(mesh, mode):
    """The reference's first step at ``mesh`` over ``mode``: its initial
    state (numpy), its loss and its gradient's norm (off the first AdamW
    moment, clipping off)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_mesh

    cfg = ref_configs.smoke(ref_configs.get_arch("yi-6b"))
    st = ref_steps.TrainSettings(comm_mode=mode, remat="nothing", loss_chunks=1, clip_norm=1e9)
    art = ref_steps.build_train(cfg, make_mesh(mesh, ("data", "model")),
                                ref_configs.ShapeConfig("t", S, B, "train"), st)
    init = jax.tree.map(np.asarray, art["init_state"](0))
    batch = {k: jnp.asarray(v) for k, v in batch_of(cfg_of("yi-6b")).items()}
    state = jax.device_put(jax.tree.map(jnp.asarray, init), art["state_sharding"])
    new, metrics = art["step"](state, jax.device_put(batch, art["batch_sharding"]))
    m = [np.asarray(x, np.float64) / (1 - 0.9) for x in jax.tree.leaves(new["opt"]["m"])]
    return init, float(metrics["loss"]), float(np.sqrt(sum((x ** 2).sum() for x in m)))


@functools.lru_cache(maxsize=None)
def _port_step(mesh, mode):
    """The port's loss, global gradients and ledger of one batch at ``mesh``
    over ``mode``, from the reference's initial state."""
    cfg = cfg_of("yi-6b")
    st = TrainSettings(comm_mode=mode, remat="nothing", loss_chunks=1)
    shape = configs.ShapeConfig("t", S, B, "train")
    art = build_train(cfg, shape, st, mesh=mesh, device="cpu")
    init = _ref_step(mesh, "smi:compressed")[0]
    state = shard_train_state(train_state_from_reference(init, cfg, device="cpu"), cfg,
                              art["ctx"], art["plan"])
    params = state["params"]
    for p in tree_flatten(params):
        p.requires_grad_(True)
    with ledger.capture() as led:
        loss, _, g = art["grads"](params, batch_of(cfg))
    got = {t: dict(e) for t, e in led.by_tag.items()}
    want = predict_train_step_stats(cfg, mesh, shape, st, eager=True)
    return float(loss), tree_flatten(unshard_params(g, cfg, art["ctx"], art["plan"])), got, want


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("mesh", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
def test_train_over_compressed(mesh):
    _, ref_loss, _ = _ref_step(mesh, "smi:compressed")
    loss, grads, got, want = _port_step(mesh, "smi:compressed")
    assert got == want and "tp.mlp.up" in got
    assert ("fsdp.gather" in got) == (mesh[0] > 1)
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), (loss, ref_loss)
    _, static = _port_step(mesh, "smi:static")[:2]
    cos = [_cos(a, b) for a, b in zip(grads, static, strict=True)]
    assert min(cos) >= GRAD_COS, cos


def test_reference_fault_compressed_wire_cuts_the_gradient():
    """The reference's int8 round has no gradient, so every activation that
    crossed the wire carries none back: at (1, 4) its ``smi:compressed``
    gradient norm is under half its ``smi:static`` one.  The port's wire is
    straight-through (test above)."""
    _, _, cut = _ref_step((1, 4), "smi:compressed")
    _, _, whole = _ref_step((1, 4), "smi:static")
    assert cut < 0.5 * whole, (cut, whole)


@pytest.mark.parametrize("mesh", ["1,8", "2,4"])
def test_train_launcher_validates_compressed(mesh):
    assert launch_train.main(["--smoke", "--device", "cpu", "--mesh", mesh, "--seq-len", "32",
                              "--batch", "4", "--comm-mode", "smi:compressed",
                              "--validate-comm"]) == 0


def test_train_over_bulk_equals_static():
    cfg = cfg_of("yi-6b")
    shape = configs.ShapeConfig("t", S, B, "train")
    loss = {}
    for mode in ("bulk", "smi:static"):
        st = TrainSettings(comm_mode=mode, remat="nothing", loss_chunks=1)
        _, hist = launch_train.train_loop(cfg, shape, st, mesh=(2, 4), steps=1, device="cpu")
        loss[mode] = hist[0]["loss"]
    assert abs(loss["bulk"] - loss["smi:static"]) <= BULK_LOSS_TOL, loss
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--smoke", "--device", "cpu", "--comm-mode", "bulk",
                           "--validate-comm"])
    assert e.value.code == 2


# -- the stencil over smi:compressed -------------------------------------------------

def test_stencil_over_compressed(tmp_path):
    out = tmp_path / "stencil.json"
    assert launch_stencil.main(["--device", "cpu", "--domain", "64x64", "--steps", "3",
                                "--comm-mode", "smi:compressed", "--json", str(out)]) == 0
    import json

    res = json.loads(out.read_text())
    assert res["ok"] and res["halo_backend"] == "compressed"
    assert 0.0 < res["max_err"] < launch_stencil.LOSSY_MAX_ERR
    with pytest.raises(SystemExit) as e:
        launch_stencil.main(["--device", "cpu", "--comm-mode", "bulk"])
    assert e.value.code == 2


def test_int8_wire_is_straight_through():
    """A move on the int8 wire hands the cotangent back along the
    transposed pairs: its gradient equals the raw wire's bit for bit, on a
    permute, a p2p and a reduce-scatter's contribution."""
    from repro_torch.core import Communicator
    from repro_torch.transport import get_transport

    comm = Communicator.create("x", (8,), device="cpu")
    x = torch.randn(8, 5, 3, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 5, 3, generator=torch.Generator().manual_seed(1))
    moves = {"permute": lambda t, v: t.permute(v, comm, ((0, 3), (3, 5), (6, 6))),
             "p2p": lambda t, v: t.p2p(v, src=1, dst=6, comm=comm),
             "contribution": lambda t, v: t.send_contribution(v, comm, 2)}
    for name, move in moves.items():
        grads = []
        for key in ("compressed", "static"):
            v = x.clone().requires_grad_(True)
            t = get_transport(key, device="cpu")
            fn = move if name != "contribution" or key == "compressed" else \
                (lambda t, v: t.shift(v, comm, 2))
            (g,) = torch.autograd.grad((fn(t, v) * w).sum(), v)
            grads.append(g)
        assert torch.equal(grads[0], grads[1]), name
        assert grads[0].abs().sum() > 0, name
