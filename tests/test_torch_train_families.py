"""The training loop of the four families ``tests/test_torch_train_loop.py``
holds at yi-6b and internvl2-1b only (mamba2-2.7b, qwen3-moe-30b-a3b,
recurrentgemma-9b and musicgen-medium), on the CPU.

* 6 steps of ``train_loop`` at tp = 1 from the reference's initial state
  against the reference's ``train_loop`` on a (1, 1) mesh: loss, ce and
  the learning rate within 1e-4;
* the same 6 steps at (1, 4) against the port's tp = 1 history, at
  yi-6b's tolerance, for the families other than mamba2;
* mamba2 at (1, 4) against tp = 1 from a common tp = 1 state a step
  (float32 rounding compounds over its history, ROADMAP.md §3).
"""

import pytest

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)
from repro_torch import configs
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.interop import shard_train_state, train_state_from_reference
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import TrainSettings, build_train
from repro_torch.models.common import tree_flatten, tree_map
from test_torch_train_loop import STEPS, B, S, _ref_history, _settings

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = ("mamba2-2.7b", "qwen3-moe-30b-a3b", "recurrentgemma-9b", "musicgen-medium")


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loop_matches_reference_families(arch, capsys):
    cfg = configs.smoke(configs.get_arch(arch))
    init, want = _ref_history(arch)
    shape = configs.ShapeConfig("t", S, B, "train")
    state = train_state_from_reference(init, cfg, device="cpu")
    for p in tree_flatten(state["params"]):
        p.requires_grad_(True)
    _, got = launch_train.train_loop(cfg, shape, _settings(TrainSettings), steps=STEPS,
                                     log_every=1, state=state, device="cpu")
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(STEPS))
    for g, w in zip(got, want):
        for k in ("loss", "ce", "lr"):
            assert abs(g[k] - w[k]) <= 1e-4 * max(1.0, abs(w[k])), (g["step"], k, g[k], w[k])
    assert "[train] step=5" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["internvl2-1b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
                                  "musicgen-medium"])
def test_train_loop_at_tp4_matches_tp1_families(arch):
    """The other families at (1, 4) against tp = 1, six steps each, at
    yi-6b's tolerance."""
    cfg = configs.smoke(configs.get_arch(arch))
    if cfg.n_heads % 4:
        cfg = cfg.scaled(n_heads=4)
    shape = configs.ShapeConfig("t", S, B, "train")
    hist = {}
    for mesh in (None, (1, 4)):
        _, hist[mesh] = launch_train.train_loop(cfg, shape, _settings(TrainSettings),
                                                mesh=mesh, steps=STEPS, log_every=1,
                                                device="cpu")
    for a, b in zip(hist[(1, 4)], hist[None]):
        for k in ("loss", "gnorm"):
            assert abs(a[k] - b[k]) <= 1e-4 * max(1.0, abs(b[k])), (a["step"], k)


def test_train_loop_at_tp4_matches_tp1_mamba2_from_a_common_state():
    """mamba2 at (1, 4) against tp = 1, each step taken from the same tp =
    1 state (its bfloat16-free float32 history still amplifies rounding
    over six steps beyond 1e-4, ROADMAP.md §3): loss and ``gnorm`` within
    1e-5 relative, step by step."""
    cfg = configs.smoke(configs.get_arch("mamba2-2.7b"))
    shape = configs.ShapeConfig("t", S, B, "train")
    one = build_train(cfg, shape, _settings(TrainSettings), device="cpu")
    four = build_train(cfg, shape, _settings(TrainSettings), mesh=(1, 4), device="cpu")
    state = one["init_state"](0)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, S, B, seed=0)
    try:
        for _ in range(STEPS):
            batch = dict(pipe.next())
            host = tree_map(lambda t: t.detach().clone(), state)
            st4 = shard_train_state(host, cfg, four["ctx"])
            for p in tree_flatten(st4["params"]):
                p.requires_grad_(True)
            _, m4 = four["step"](st4, batch)
            state, m1 = one["step"](state, batch)
            for k in ("loss", "gnorm"):
                assert abs(float(m4[k]) - float(m1[k])) <= 1e-5 * max(1.0, abs(float(m1[k]))), k
    finally:
        pipe.close()
