"""The dry run, the roofline and the hill-climb in the port
(``launch/dryrun.py``, ``launch/roofline.py``) against ``repro``.

* ``model_flops_per_device`` and ``useful_bytes_per_device`` equal the
  reference's for every arch x shape at 256 and 512 devices, exactly;
* ``run_cell`` and ``analyze_cell`` give the reference's keys;
* at smoke yi-6b on (2, 4) (the production mesh patched in both packages),
  a device's argument bytes equal the reference's
  ``memory_analysis().argument_size_in_bytes``, byte for byte; the FLOP
  ratio against its ``cost_analysis`` is reported;
* each record's collectives per tag equal ``predict_train_step_stats``
  and ``predict_decode_step_stats``;
* (the period and one-group assembly against the whole step is held in
  tests/test_torch_dryrun_assembly.py and tests/test_torch_dryrun_hybrid.py);
* the dry run allocates nothing, ``VARIANTS`` equals
  ``scripts/hillclimb.py``'s, no v5e figure is in the port, and the CLIs
  write only where they are told.

Importing the reference's dry run sets ``XLA_FLAGS`` to 512 host devices
(``repro/launch/dryrun.py:1-2``): jax is initialised before that import
and the variable restored after it.
"""

from __future__ import annotations

import ast
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from _torch_dp_cases import one_thread  # noqa: E402,F401 (the module's fixture)
from repro import configs as ref_configs  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.steps import TrainSettings  # noqa: E402
from repro_torch.netsim import predict_decode_step_stats, predict_train_step_stats  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]


# -- the roofline's arithmetic ---------------------------------------------------------------

@pytest.mark.parametrize("n_chips", [256, 512])
@pytest.mark.parametrize("shape", sorted(configs.SHAPES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_model_flops_and_useful_bytes_equal_reference(arch, shape, n_chips):
    cfg, rcfg = configs.get_arch(arch), ref_configs.get_arch(arch)
    sh, rsh = configs.SHAPES[shape], ref_configs.SHAPES[shape]
    assert roofline.model_flops_per_device(cfg, sh, n_chips) == \
        ref_roofline.model_flops_per_device(rcfg, rsh, n_chips)
    assert roofline.useful_bytes_per_device(cfg, sh, n_chips) == \
        ref_roofline.useful_bytes_per_device(rcfg, rsh, n_chips)


def test_cells_equal_reference():
    assert configs.cells() == ref_configs.cells()
    assert len(configs.cells()) * 2 == 80
    assert sum(1 for *_, skip in configs.cells() if skip) * 2 == 16


# -- a cell against the reference's, smoke yi-6b on (2, 4) -----------------------------------

def _smoke_bf16(pkg):
    """Smoke yi-6b in bfloat16: the reference hands its prefill and decode
    bfloat16 params whatever the config's dtype, the port the model's."""
    return pkg.smoke(pkg.get_arch("yi-6b")).scaled(dtype="bfloat16")


@pytest.fixture
def patched(monkeypatch):
    """Both packages' dry runs on smoke yi-6b at (2, 4) (8 host devices for
    the reference), the reference's GB unrounded."""
    rcfg, cfg = _smoke_bf16(ref_configs), _smoke_bf16(configs)
    monkeypatch.setattr(ref_dryrun, "get_arch", lambda a: rcfg)
    monkeypatch.setattr(ref_roofline, "get_arch", lambda a: rcfg)
    mesh = make_mesh((2, 4), ("data", "model"))
    monkeypatch.setattr(ref_dryrun, "make_production_mesh", lambda multi_pod=False: mesh)
    monkeypatch.setattr(ref_roofline, "make_production_mesh", lambda multi_pod=False: mesh)
    monkeypatch.setattr(ref_dryrun, "round", lambda x, n=None: x, raising=False)
    monkeypatch.setattr(dryrun, "get_arch", lambda a: cfg)
    monkeypatch.setattr(roofline, "get_arch", lambda a: cfg)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: ((2, 4), ("data", "model")))
    return cfg


def _head_bytes(cfg, mesh):
    """One device's bytes of the LM head (bfloat16, split by vocabulary
    columns over the model axis)."""
    return cfg.d_model * cfg.padded_vocab * 2 // mesh[-1]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_argument_bytes_equal_xla_memory_analysis(patched, shape, record_property):
    """A device's arguments, byte for byte.  The reference's prefill step
    never reads the LM head, and ``jax.jit`` drops unused arguments
    (``keep_unused=False``), so its count leaves the head out: the port's
    prefill is called with every param, and the test takes the head's bytes
    off the port's count there."""
    want = ref_dryrun.run_cell("yi-6b", shape, multi_pod=False, verbose=False)
    got = dryrun.run_cell("yi-6b", shape, multi_pod=False, verbose=False)
    assert want["ok"] and got["ok"], (want.get("error"), got.get("error"))
    arg = got["memory_bytes"]["argument"]
    if shape == "prefill_32k":
        arg -= _head_bytes(patched, (2, 4))
    assert got["memory"]["argument_gb"] * 2**30 == got["memory_bytes"]["argument"]
    assert arg == want["memory"]["argument_gb"] * 2**30
    ratio = got["cost"]["flops"] / want["cost"]["flops"]
    record_property("flops_over_xla_cost_analysis", ratio)
    print(f"{shape}: the port's FLOPs a device / XLA's cost_analysis: {ratio:.4f}")


def test_records_and_rows_have_the_references_keys(patched):
    want = ref_dryrun.run_cell("yi-6b", "decode_32k", multi_pod=False, verbose=False)
    got = dryrun.run_cell("yi-6b", "decode_32k", multi_pod=False, verbose=False)
    assert set(want) - {"lower_s", "compile_s"} <= set(got)
    assert all(got[k] == want[k] for k in ("arch", "shape", "kind", "mesh", "comm_mode",
                                           "variant", "ok"))
    assert set(got["memory"]) == set(want["memory"]) and set(got["cost"]) == set(want["cost"])
    assert "total" in got["collectives"]
    ref_row = ref_roofline.analyze_cell(want)
    row = roofline.analyze_cell(got)
    assert set(ref_row) <= set(row)
    assert set(row["terms_s"]) == set(ref_row["terms_s"])
    assert row["dominant"] in row["terms_s"] and row["n_chips"] == 8
    skipped = dryrun.run_cell("yi-6b", "long_500k", multi_pod=True, verbose=False)
    assert skipped["ok"] and "skipped" in skipped and skipped["mesh"] == "2x4"


def test_a_failing_cell_is_a_record(monkeypatch):
    monkeypatch.setattr(dryrun, "get_arch", lambda a: configs.smoke(configs.get_arch(a)))
    monkeypatch.setattr(dryrun, "count_step", lambda *a, **k: 1 / 0)
    rec = dryrun.run_cell("yi-6b", "decode_32k", multi_pod=False, verbose=False)
    assert not rec["ok"] and rec["error"].startswith("ZeroDivisionError")
    assert "traceback" in rec


# -- collectives against netsim --------------------------------------------------------------

def _dp_tp(mesh):
    return int(np.prod(mesh[:-1])) if len(mesh) > 1 else 1, mesh[-1]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 2, 2)], ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-9b"])
def test_collectives_equal_predictions(arch, mesh):
    cfg = configs.smoke(configs.get_arch(arch))
    dp, tp = _dp_tp(mesh)
    st = TrainSettings(comm_mode="smi:static", loss_chunks=1)
    shape = configs.ShapeConfig("t", 32, 8, "train")
    rec = dryrun.dry_run(cfg, shape, mesh, comm_mode="smi:static", settings=st)
    assert rec["collectives"]["by_tag"] == predict_train_step_stats(cfg, (dp, tp), shape, st,
                                                                    eager=True)
    assert rec["collectives"]["total"] == sum(e["bytes"] for e in
                                              rec["collectives"]["by_tag"].values())
    shape = configs.ShapeConfig("d", 64, 8, "decode")
    rec = dryrun.dry_run(cfg, shape, mesh, comm_mode="smi:static")
    assert rec["collectives"]["by_tag"] == predict_decode_step_stats(
        cfg, (dp, tp), 8 // dp, st, capacity=64, eager=True, fsdp=False, prefix="")


# -- nothing allocated -----------------------------------------------------------------------

def test_the_dry_run_allocates_no_storage(monkeypatch):
    """Every tensor of a dry run lies on the meta device: a factory call
    for any other device fails the test."""
    made = []
    orig = torch.empty

    def empty(*a, **k):
        made.append(torch.device(k.get("device") or "cpu"))
        return orig(*a, **k)

    cfg = configs.smoke(configs.get_arch("yi-6b")).scaled(n_layers=5)
    monkeypatch.setattr(torch, "empty", empty)
    rec = dryrun.dry_run(cfg, configs.ShapeConfig("t", 32, 8, "train"), (2, 2),
                         comm_mode="smi:static")
    assert made and all(d.type == "meta" for d in made)
    assert rec["stack"]["state_bytes"] == 3 * sum(
        t.nbytes for t in dryrun.tree_flatten(dryrun.param_shapes(cfg))) + 4


# -- kernels E and F on meta: their own ops --------------------------------------------------

@pytest.mark.parametrize("causal, window", [(True, None), (True, 1), (True, 3), (True, 7),
                                            (False, None)])
def test_visible_pairs_equal_a_brute_force_count(causal, window):
    from repro_torch.kernels.flash_attention.ops import visible_pairs

    for sq in (0, 1, 5, 8, 13):
        for skv in (0, 1, 4, 8, 13):
            i, j = np.arange(sq)[:, None], np.arange(skv)[None, :]
            seen = np.ones((sq, skv), bool) if not causal else \
                (j <= i) & ((j > i - window) if window else True)
            assert visible_pairs(sq, skv, causal, window) == int(seen.sum()), (sq, skv)


@pytest.mark.parametrize("kernel", ["E", "F"])
def test_kernels_e_and_f_run_as_their_own_ops_on_meta(kernel):
    """On ``meta`` the forward is one op of the kernel's (its flop formula,
    its operands and result, nothing of the plain version's S x S scores or
    chunk products), and the backward is the plain version's, recomputed."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    from repro_torch.kernels.ssd import ssd_scan

    meta = torch.device("meta")
    if kernel == "E":
        B, S, H, Hkv, D = 2, 256, 4, 2, 64
        inputs = [torch.empty(B, S, h, D, device=meta, dtype=torch.bfloat16, requires_grad=True)
                  for h in (H, Hkv, Hkv)]
        fn, op = (lambda *t: flash_attention(*t, causal=True, window=100)), \
            torch.ops.repro_torch.flash_attention_e
        want = 4 * D * B * H * visible_pairs(S, S, True, 100)
        plain_peak = B * H * S * S * 4                      # one float32 score matrix
    else:
        BH, S, Dh, G, Dst, L = 8, 512, 64, 2, 16, 128
        shapes = [(BH, S, Dh), (BH, S), (G, S, Dst), (G, S, Dst), (BH, 1)]
        inputs = [torch.empty(sh, device=meta, requires_grad=True) for sh in shapes]
        fn, op = (lambda *t: ssd_scan(*t, chunk=L)), torch.ops.repro_torch.ssd_scan_f
        want = 2 * (L * (L + 1) // 2 * (Dst + Dh) + 2 * L * Dst * Dh) * BH * (S // L)
        plain_peak = BH * S * L * 4                         # the chunks' score blocks
    fc, counts = FlopCounterMode(display=False), dryrun._Counts()
    with fc, counts:
        out = fn(*inputs)
    assert out.is_meta and out.shape == inputs[0].shape
    assert fc.get_flop_counts()["Global"] == {op: want}
    assert counts.peak < plain_peak
    with FlopCounterMode(display=False) as back:
        out.sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape for t in inputs)
    assert op not in back.get_flop_counts()["Global"] and back.get_total_flops() > 0


# -- the hill-climb, the constants, the CLIs -------------------------------------------------

def test_variants_equal_hillclimb_scripts():
    """Read by ``ast``: importing the script would set ``XLA_FLAGS``."""
    tree = ast.parse((ROOT / "scripts" / "hillclimb.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "VARIANTS" for t in n.targets))
    want = {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value) for kw in v.keywords}
            for k, v in zip(node.value.keys, node.value.values)}
    assert roofline.VARIANTS == want


def test_no_v5e_figure_in_the_port():
    """The roofline's peaks are the card's: no TPU v5e figure (197e12 FLOP/s,
    819e9 B/s, ``LinkModel.default_v5e``) appears in the port."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        for bad in ("197e12", "819e9", "default_v5e"):
            assert bad not in text, (path, bad)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BYTES_PER_S) == (989e12, 3.35e12)
    assert roofline.NET_MODEL == roofline.LinkModel()


def test_clis_write_only_where_told(tmp_path, monkeypatch, capsys):
    """``launch.dryrun``, ``launch.roofline`` and its ``--variant`` on smoke
    yi-6b (the production meshes patched: (16, 16) and (2, 2, 2)), run in
    ``tmp_path``: every file they write is one they were named."""
    cfg = configs.smoke(configs.get_arch("yi-6b"))
    monkeypatch.setattr(dryrun, "get_arch", lambda a: cfg)
    monkeypatch.setattr(roofline, "get_arch", lambda a: cfg)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: ((2, 2, 2), ("pod", "data", "model"))
                        if multi_pod else ((16, 16), ("data", "model")))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "dry.jsonl"
    for shape in ("decode_32k", "long_500k"):
        assert dryrun.main(["--arch", "yi-6b", "--shape", shape, "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["shape"], r["mesh"]) for r in recs] == [
        ("decode_32k", "16x16"), ("decode_32k", "2x2x2"), ("long_500k", "16x16"),
        ("long_500k", "2x2x2")]
    assert all(r["ok"] for r in recs) and all("skipped" in r for r in recs[2:])
    rows = tmp_path / "roof.jsonl"
    assert roofline.main(["--results", str(out), "--out", str(rows)]) == 0
    row = json.loads(rows.read_text())
    assert row["mesh"] == "16x16" and row["n_chips"] == 256
    assert roofline.main(["--arch", "yi-6b", "--shape", "decode_32k", "--variant", "sg",
                          "--out", str(tmp_path / "hill.jsonl")]) == 0
    assert json.loads((tmp_path / "hill.jsonl").read_text())["variant"] == "sg"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dry.jsonl", "hill.jsonl",
                                                           "roof.jsonl"]
    assert dryrun.main(["--out", str(out)]) == 1          # nothing selected
    assert "nothing selected" in capsys.readouterr().err
