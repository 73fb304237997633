"""The channel ledger of a training step over a data axis, and the
launcher at ``--mesh 2,4``.

* ``predict_train_step_stats`` at dp > 1 (``fsdp.gather`` and ``grad``):
  its traced table equals the reference's, and a step's ledger equals its
  ``eager=True`` table (one gather a layer), the int8 ``"grad"`` ring
  included;
* ``launch.train --device cpu --smoke`` at its default mesh, ``2,4``, and
  ``--compressed-grads --validate-comm`` there.
"""

from __future__ import annotations

import pytest

from _torch_dp_cases import ARCHS, B, S, one_thread  # noqa: F401 (the module's fixture)
from _torch_dp_cases import batch_of as _batch
from _torch_dp_cases import cfg_of as _cfg
from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.netsim.schedule import predict_train_step_stats as ref_predict
from repro_torch import configs
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import TrainSettings, build_train
from repro_torch.netsim import predict_train_step_stats
from repro_torch.parallel import ledger

pytestmark = pytest.mark.usefixtures("one_thread")

#: (arch, mesh, compressed_grads): every family at (2, 4); the int8 ring where
#: there are leaves stored whole to ring (mamba2's SSM scalars, the hybrid's);
#: (2, 1) and (4, 2) once each
LEDGER_CASES = ([(a, (2, 4), False) for a in ARCHS] +
                [("mamba2-2.7b", (2, 4), True), ("recurrentgemma-9b", (2, 1), True),
                 ("yi-6b", (2, 1), False), ("yi-6b", (4, 2), False)])


@pytest.mark.parametrize("arch, mesh, compressed", LEDGER_CASES)
def test_ledger_equals_prediction_at_dp(arch, mesh, compressed):
    cfg = _cfg(arch)
    st = TrainSettings(comm_mode="smi:static", loss_chunks=1, compressed_grads=compressed)
    shape = configs.ShapeConfig("t", S, B, "train")
    ref_cfg = ref_configs.smoke(ref_configs.get_arch(arch))
    if cfg.n_heads != ref_cfg.n_heads:
        ref_cfg = ref_cfg.scaled(n_heads=cfg.n_heads)
    want = ref_predict(ref_cfg, mesh, ref_configs.ShapeConfig("t", S, B, "train"),
                       ref_steps.TrainSettings(comm_mode="smi:static", loss_chunks=1,
                                               compressed_grads=compressed))
    assert predict_train_step_stats(cfg, mesh, shape, st) == want
    art = build_train(cfg, shape, st, mesh=mesh, device="cpu")
    with ledger.capture() as led:
        art["step"](art["init_state"](0), _batch(cfg))
    assert {t: dict(e) for t, e in led.by_tag.items()} == \
        predict_train_step_stats(cfg, mesh, shape, st, eager=True)


def test_launcher_trains_at_2x4_on_the_cpu(capsys):
    base = ["--device", "cpu", "--smoke", "--steps", "2", "--seq-len", "32", "--batch", "2"]
    assert launch_train.main(base) == 0          # the default mesh, 2,4
    assert launch_train.main(base + ["--arch", "mamba2-2.7b", "--comm-mode", "smi:fused",
                                     "--compressed-grads", "--validate-comm"]) == 0
    out = capsys.readouterr().out
    assert "[validate-comm] ok" in out and "grad " in out and "fsdp.gather" in out
