#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
non-zero):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/csrc``;
2. kernel A (``accumulate``) against its plain PyTorch version, bit for bit,
   in float32, bfloat16 and int32 at a ragged size and at 64 MiB;
3. kernel B (``stencil_sweep``) against its plain version, bit for bit, on
   a (8, 4096, 2048) float32 stack and a ragged bfloat16 stack;
4. the stencil path: ``python -m repro_torch.launch.stencil --grid 2x4
   --domain 8192x8192 --steps 32 --comm-mode smi:static``, overlapped and
   not, each equal bit for bit to the single-rank sweep run with the plain
   version on the card; kernel B must launch during the overlapped run;
   then ``torch.profiler`` splits a warm step's device time by kernel;
5. the reduction path: ``allreduce``, ``reduce_scatter`` and ``reduce`` of
   8 x 16 Mi float32 on ``smi:fused`` against ``smi:static``, on ring(1x8)
   and torus(2x4), bit for bit; kernel A must launch;
6. one ``{"kernels": [...]}`` line: per kernel its launches on its path,
   time per launch (CUDA events, after warm-up, at the path's shapes), the
   bound (bytes moved over 3.35 TB/s), the plain version's time and one
   PyTorch library call's time (timed here only, never used by the port).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository around it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, operations per second
F32_OPS_PER_S = 67e12

P = 8
REDUCE_ELEMS = 16 * 1024 * 1024  # per rank
STENCIL_ARGS = ["--grid", "2x4", "--domain", "8192x8192", "--steps", "32",
                "--comm-mode", "smi:static"]


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.transport.fused import fused_accumulate

    stencil_sweep.launches = fused_accumulate.launches = 0


def phase_build():
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s -> {lib}")
    for line in (lib.parent / "build.log").read_text().splitlines() if \
            (lib.parent / "build.log").exists() else []:
        if "registers" in line or "error" in line.lower():
            log(f"ptxas: {line.strip()}")


def phase_accumulate(dev) -> float:
    import torch

    from repro_torch.transport.fused import accumulate_plain, fused_accumulate

    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        itemsize = torch.empty((), dtype=dtype).element_size()
        for n in (1_000_003, (64 << 20) // itemsize):
            if dtype == torch.int32:
                a = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                                  dtype=torch.int32)
                b = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                                  dtype=torch.int32)
            else:
                a = (torch.randn(n, generator=g, device=dev) * 100).to(dtype)
                b = (torch.randn(n, generator=g, device=dev) * 100).to(dtype)
            got, want = fused_accumulate(a, b), accumulate_plain(a, b)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(f"accumulate {dtype} n={n}: kernel != plain "
                                     f"(max abs err {max_abs_err(got, want)})")
            worst = max(worst, max_abs_err(got, want))
            log(f"accumulate {str(dtype):>14} n={n:>9}: bit-equal to plain")
    return worst


def phase_stencil_kernel(dev) -> float:
    import torch

    from repro_torch.kernels.stencil import stencil_sweep, stencil_sweep_plain

    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for shape, dtype in (((8, 4096, 2048), torch.float32), ((3, 1001, 777), torch.bfloat16),
                         ((4097, 1029), torch.float32)):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        got, want = stencil_sweep(x), stencil_sweep_plain(x)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"stencil_sweep {dtype}{shape}: kernel != plain "
                                 f"(max abs err {max_abs_err(got, want)})")
        worst = max(worst, max_abs_err(got, want))
        log(f"stencil_sweep {str(dtype):>14} {shape}: bit-equal to plain")
    return worst


def phase_stencil_path() -> tuple[int, dict]:
    import torch

    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.launch import stencil as launch_stencil

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for sched, extra in (("overlapped", []), ("reference", ["--no-overlap"])):
            out = os.path.join(tmp, f"{sched}.json")
            rc = launch_stencil.main([*STENCIL_ARGS, *extra, "--json", out])
            torch.cuda.synchronize()
            res = json.loads(Path(out).read_text())
            if rc != 0 or not res["ok"] or res["max_err"] != 0.0:
                raise AssertionError(f"stencil {sched}: rc={rc} result={res}")
            results[sched] = res
        launches = stencil_sweep.launches
    if launches == 0:
        raise AssertionError("the overlapped stencil path never launched the stencil kernel")
    log(f"stencil path: kernel B launched {launches} times in the overlapped run")
    return launches, results


def phase_stencil_profile(dev, n_steps: int = 8):
    """Where a stencil step's time goes: ``torch.profiler`` over ``n_steps``
    warm steps of each schedule at the path's shape; device time by kernel
    per step, and the device's idle share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps import DistributedStencil

    app = DistributedStencil.create((2, 4), comm_mode="smi:static", device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = app.scatter(torch.randn((8192, 8192), generator=g, device=dev))
    for overlapped in (True, False):
        t = app.halo_schedule.resolve_transport()
        app.run(x, 2, overlapped=overlapped, transport=t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            app.run(x, n_steps, overlapped=overlapped, transport=t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        # device events only: a CPU op's self device time repeats its kernels'
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in rows)
        sched = "overlapped" if overlapped else "reference"
        log(f"profile {sched}: wall {wall_ms:.4f} ms/step, device busy {busy:.4f} ms/step "
            f"(idle {max(0.0, 1 - busy / wall_ms):.1%}), {n_steps} steps")
        for name, ms in rows[:8]:
            log(f"profile {sched}:   {ms:.4f} ms/step  {name[:90]}")


def phase_reductions(dev) -> int:
    import torch

    from repro_torch.core import Communicator
    from repro_torch.core.collectives import allreduce, reduce, stream_reduce_scatter
    from repro_torch.transport import get_transport
    from repro_torch.transport.fused import fused_accumulate

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    x_before = x.clone()
    ops = {"allreduce": lambda v, c, t: allreduce(v, c, transport=t),
           "reduce_scatter": lambda v, c, t: stream_reduce_scatter(v, c, transport=t),
           "reduce": lambda v, c, t: reduce(v, c, root=3, transport=t)}
    reset_counts()
    for names, sizes in ((("x",), (8,)), (("x", "y"), (2, 4))):
        comm = Communicator.create(names, sizes, device=dev)
        for name, op in ops.items():
            ts, tf = get_transport("static", device=dev), get_transport("fused", device=dev)
            want, got = op(x, comm, ts), op(x, comm, tf)
            torch.cuda.synchronize()
            if not same_bits(got, want) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} on {sizes}: smi:fused != smi:static")
            if (tf.stats.steps, tf.stats.bytes_moved) != (ts.stats.steps, ts.stats.bytes_moved):
                raise AssertionError(f"{name} on {sizes}: stats differ")
            log(f"{name:>14} on {str(sizes):>7}: smi:fused bit-equal to smi:static "
                f"({tf.stats.steps} steps, {tf.stats.bytes_moved} B per rank)")
    if not same_bits(x, x_before):
        raise AssertionError("a reduction modified its input")
    launches = fused_accumulate.launches
    if launches == 0:
        raise AssertionError("the fused reductions never launched the accumulate kernel")
    log(f"reduction path: kernel A launched {launches} times")
    return launches


def phase_kernel_table(dev, launches_a, launches_b, err_a, err_b) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.stencil import stencil_sweep, stencil_sweep_plain
    from repro_torch.transport.fused import accumulate_plain, fused_accumulate

    torch.backends.cudnn.allow_tf32 = False  # the library stencil stays in float32
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []

    # A at the all-reduce's fold shape: one (P, 16Mi/P) block per step
    a = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    b = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    t_bound, by = bound(3 * a.numel() * a.element_size(), a.numel())
    rows.append(dict(
        name="accumulate", route="cuda", source="src/repro_torch/csrc/accumulate.cu",
        replaces="src/repro/transport/fused.py:35", launches=launches_a,
        max_abs_err=err_a, ms=time_ms(lambda: fused_accumulate(a, b)),
        plain_ms=time_ms(lambda: accumulate_plain(a, b)), bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: torch.add(a, b)), shape=list(a.shape), dtype="float32"))
    # A at the rooted reduce's fold shape, on its own line
    a2 = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    b2 = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    log(f"accumulate at {list(a2.shape)} f32: "
        f"{time_ms(lambda: fused_accumulate(a2, b2)):.4f} ms "
        f"(plain {time_ms(lambda: accumulate_plain(a2, b2)):.4f} ms, "
        f"bound {bound(3 * a2.numel() * 4, a2.numel())[0]:.4f} ms)")
    del a2, b2

    # B at the stencil path's shape: the (8, 4096, 2048) tile stack
    x = torch.randn((P, 4096, 2048), generator=g, device=dev)
    w = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25], [0.0, 0.25, 0.0]],
                     device=dev).view(1, 1, 3, 3)
    x4 = x.view(P, 1, 4096, 2048)
    t_bound, by = bound(2 * x.numel() * x.element_size(), 5 * x.numel())
    rows.append(dict(
        name="stencil_sweep", route="cuda", source="src/repro_torch/csrc/stencil.cu",
        replaces="src/repro/kernels/stencil/kernel.py:43", launches=launches_b,
        max_abs_err=err_b, ms=time_ms(lambda: stencil_sweep(x)),
        plain_ms=time_ms(lambda: stencil_sweep_plain(x)), bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: F.conv2d(x4, w, padding=1)), shape=list(x.shape),
        dtype="float32"))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    torch.cuda.synchronize()
    err_a = phase_accumulate(dev)
    torch.cuda.synchronize()
    err_b = phase_stencil_kernel(dev)
    torch.cuda.synchronize()
    launches_b, stencil = phase_stencil_path()
    for sched, res in stencil.items():
        log(f"stencil {sched}: {res['wall_per_step_s'] * 1e3:.4f} ms/step over "
            f"{res['steps']} steps, halo {res['halo_steps']} steps / "
            f"{res['halo_bytes_per_rank']} B per rank, equal to the single-rank sweep")
    phase_stencil_profile(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches_a = phase_reductions(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows = phase_kernel_table(dev, launches_a, launches_b, err_a, err_b)
    torch.cuda.synchronize()

    log("stencil_wall_per_step_ms: " + json.dumps(
        {k: v["wall_per_step_s"] * 1e3 for k, v in stencil.items()}))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
