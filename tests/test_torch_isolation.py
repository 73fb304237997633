"""The port stands alone: it imports neither JAX nor anything of ``repro``,
and its entry points run on ``cuda`` unless the caller names the CPU.  The
scan covers the package, ``chip_smoke.py`` and the port's examples
(``examples/torch_*.py``)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _forbidden_imports(path: Path):
    """(line, module) of every import of JAX or of ``repro`` at any depth,
    lazy imports inside functions included; relative imports stay in the
    package."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(
                node.func, "attr", None)) in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        else:
            continue
        bad += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert path.exists(), path
    assert _forbidden_imports(path) == []


def test_scan_catches_a_lazy_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    from repro.core import x\n    import jax.numpy\n"
                 "    import importlib; importlib.import_module('repro.netsim')\n"
                 "    from repro_torch import y\n")
    assert [n for _, n in _forbidden_imports(f)] == ["repro.core", "jax.numpy", "repro.netsim"]


def test_importing_the_port_loads_no_jax_or_repro():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: __import__(m)\n"
        "import repro_torch.launch.stencil\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) > 20, mods\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_entry_points_default_to_cuda():
    from repro_torch.apps import DistributedStencil
    from repro_torch.configs import SHAPES, get_arch, smoke
    from repro_torch.core import Communicator
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import stencil as launch_stencil
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh import ParallelCtx
    from repro_torch.models import init_lm, lm_caches
    from repro_torch.transport import get_transport
    from repro_torch.transport.fused import FusedTransport
    from repro_torch.transport.static import StaticTransport

    cfg = smoke(get_arch("yi-6b"))
    makers = [lambda: DistributedStencil.create((2, 4)).device, lambda: FusedTransport().device,
              lambda: StaticTransport().device, lambda: get_transport("fused").device,
              lambda: get_transport("packet").device,
              lambda: Communicator.create("x", (8,)).device,
              lambda: build_prefill(cfg, SHAPES["prefill_32k"]).device,
              lambda: build_prefill(cfg, SHAPES["prefill_32k"], mesh=(1, 8),
                                    comm_mode="smi:static").ctx.model_comm.device,
              lambda: init_lm(cfg)["embed"].device,
              lambda: lm_caches(cfg, 2, 8, ParallelCtx())["periods"][0]["k"].device]
    if torch.cuda.is_available():
        assert all(m().type == "cuda" for m in makers)
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_stencil.main(["--domain", "16x16", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--smoke"])


#: the training slice's modules (each also in the scans above)
TRAINING_MODULES = ("optim/adamw.py", "optim/grad.py", "optim/schedule.py", "data/pipeline.py",
                    "checkpoint/checkpointer.py", "ft/watchdog.py", "ft/elastic.py",
                    "launch/train.py", "launch/steps.py", "models/model.py", "interop.py",
                    # the tooling slice: the port's own copies of repro.obs and
                    # repro.analysis (even their modules that import no JAX)
                    "obs/__init__.py", "obs/trace.py", "obs/metrics.py", "obs/export.py",
                    "analysis/__init__.py", "analysis/ops.py", "analysis/verify.py",
                    "analysis/rules.py", "analysis/corpus.py", "analysis/capture.py",
                    "analysis/programs.py", "analysis/lint.py")


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_stand_alone(module):
    """The training modules are the port's own copies: none imports JAX or
    ``repro`` (not even the jax-free ``repro.data.pipeline`` or
    ``repro.checkpoint``), and each is imported by the package walk."""
    path = PORT / module
    assert path in _port_files()
    assert _forbidden_imports(path) == []


def test_training_entry_points_default_to_cuda():
    from repro_torch.configs import ShapeConfig, get_arch, smoke
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import TrainSettings, build_train

    cfg = smoke(get_arch("yi-6b"))
    shape = ShapeConfig("t", 32, 2, "train")
    if torch.cuda.is_available():
        assert build_train(cfg, shape, TrainSettings())["device"].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train(cfg, shape, TrainSettings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])


#: the data axis's modules (slice 12), new or grown
DATA_AXIS_MODULES = ("core/pipeline.py", "mesh/api.py", "parallel/layers.py",
                     "models/transformer.py", "netsim/schedule.py", "kernels/matmul/ops.py",
                     "serving/engine.py", "launch/serve.py")


@pytest.mark.parametrize("module", DATA_AXIS_MODULES)
def test_data_axis_modules_stand_alone(module):
    """The data axis's modules import neither JAX nor ``repro`` (the
    pipeline is the port's own copy of ``repro.core.pipeline``), and each
    is imported by the package walk."""
    path = PORT / module
    assert path in _port_files()
    assert _forbidden_imports(path) == []


def test_data_axis_entry_points_default_to_cuda():
    """A data axis's ring and the builders on FSDP weights run on ``cuda``
    unless ``device="cpu"`` is asked for."""
    from repro_torch.configs import ShapeConfig, get_arch, smoke
    from repro_torch.core import Communicator
    from repro_torch.launch.steps import build_serve
    from repro_torch.mesh.api import make_ctx

    cfg = smoke(get_arch("yi-6b"))
    makers = [lambda: make_ctx((2, 4), comm_mode="smi:static").data_comm.device,
              lambda: make_ctx((2, 1), comm_mode="smi:fused").data_comm.device,
              lambda: Communicator.create("pp", (8,)).device,
              lambda: build_serve(cfg, ShapeConfig("s", 32, 2, "decode"), mesh=(2, 4),
                                  comm_mode="smi:static", fsdp=True)["ctx"].data_comm.device]
    if torch.cuda.is_available():
        assert all(m().type == "cuda" for m in makers)
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make_ctx((2, 4), comm_mode="smi:static", device="cpu").data_comm.device.type == "cpu"


#: ranks as processes (slice 15): the group, the communicator's block and the
#: launchers that run it
PROCESS_MODULES = ("core/spmd.py", "core/comm.py", "launch/stencil.py", "launch/channels.py")


@pytest.mark.parametrize("module", PROCESS_MODULES)
def test_process_mode_modules_stand_alone(module):
    """The process mode's modules import neither JAX nor ``repro`` (the
    rank processes import them by name), and each is imported by the
    package walk."""
    path = PORT / module
    assert path in _port_files()
    assert _forbidden_imports(path) == []


def test_rank_processes_load_no_jax_or_repro():
    """A rank process starts from a fresh interpreter: whatever this test
    process has loaded, it holds neither JAX nor ``repro`` (and runs torch
    on one thread on the CPU)."""
    import _torch_spmd_cases as K

    from repro_torch.core import run_spmd

    assert "jax" in sys.modules  # this process has: the rank processes must not
    got = run_spmd(K.loaded_modules, {"axis_names": ("x",), "axis_sizes": (8,)}, n_procs=2,
                   device="cpu")
    assert got == {"bad": [[], []], "threads": [1, 1], "lo": [0, 4]}


def test_process_mode_defaults_to_cuda():
    """``SpmdGroup`` and ``run_spmd`` place the rank processes on ``cuda``
    unless the CPU is asked for, and raise without a card rather than move
    to the CPU."""
    import _torch_spmd_cases as K

    from repro_torch.core import SpmdGroup, run_spmd
    from repro_torch.launch import stencil as launch_stencil

    if torch.cuda.is_available():
        with SpmdGroup(1, 1) as g:
            assert g.devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpmdGroup(2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_spmd(K.loaded_modules, {"axis_names": ("x",), "axis_sizes": (8,)}, n_procs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_stencil.main(["--domain", "16x16", "--steps", "1", "--ranks", "process"])


#: the port's examples, each beside the reference's of the same name
EXAMPLES = ("torch_quickstart", "torch_stencil", "torch_gesummv", "torch_serve_lm",
            "torch_train_lm")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_stand_alone_and_default_to_cuda(name):
    """Each example is scanned above, and its ``main`` runs on ``cuda``
    unless ``--device cpu`` is given: without a card it raises rather than
    move to the CPU."""
    import importlib

    path = ROOT / "examples" / f"{name}.py"
    assert path in _port_files() and _forbidden_imports(path) == []
    if torch.cuda.is_available():
        return
    sys.path.insert(0, str(path.parent))
    try:
        main = importlib.import_module(name).main
    finally:
        sys.path.remove(str(path.parent))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main() if name == "torch_stencil" else main([])
