#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
non-zero):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/csrc`` and, beside them, this script's own
   two (:data:`SMOKE_CU`: kernel C's tick floor and kernel A's scalar
   predecessor), and print what ``ptxas -v`` says of every kernel;
2. kernel A (``accumulate``) against its plain PyTorch version, bit for bit,
   in float32, bfloat16 and int32 at a ragged size and at 64 MiB, and its
   gather-fused form (``shift_accumulate``) on the same sizes as 8 rank
   rows, a ring shift and a partial permutation, x aligned and one element
   off;
3. kernel B (``stencil_sweep``) against its plain version, bit for bit, on
   a (8, 4096, 2048) float32 stack and a ragged bfloat16 stack;
4. the stencil path: ``python -m repro_torch.launch.stencil --grid 2x4
   --domain 8192x8192 --steps 32 --comm-mode smi:static``, overlapped and
   not, each equal bit for bit to the single-rank sweep run with the plain
   version on the card; kernel B must launch during the overlapped run;
   then ``torch.profiler`` splits a warm step's device time by kernel;
5. the reduction path: ``allreduce``, ``reduce_scatter`` and ``reduce`` of
   8 x 16 Mi float32 on ``smi:fused`` against ``smi:static``, on ring(1x8)
   and torus(2x4), bit for bit with equal stats; A's gather-fused form must
   launch once per ring step and its plain add on the rooted folds; each
   reduction timed on both wires in turns (static, fused, fused, static),
   by CUDA events and by its device time;
6. per kernel its launches on its path, time per launch (CUDA events,
   after warm-up, at the path's shapes; for A and C their device time under
   ``torch.profiler``, since their wrappers' host work can outlast their
   kernels), the bound (bytes moved over 3.35 TB/s), the plain version's
   time and one PyTorch library call's time (timed here only, never used
   by the port); A beside its scalar predecessor
   (``ms_before``) at (8, 2 Mi) and (8, 16 Mi), its gather-fused form
   beside the unfused ``ppermute`` + ``torch.add``;
7. kernel C (``router_run``), both its paths (``warp``, a rank on a warp's
   lanes, and ``thread``, one thread a rank), against both plain routers (``impl="vector"``
   and ``"scalar"``), bit for bit on (out_pay, out_cnt, overflow, t_done)
   with equal ticks: the reference's four equivalence configurations on
   torus(2x4) and the snake bus, the out_cap overrun, the step-budget flood,
   an undersized transit that must count overflow, and the halo shape (4096
   float32 at 32 per packet: 128 packets, a 133-tick budget), where both
   paths are timed in turns beside the tick floor (the same number of empty
   ticks of the warp path's barrier in a block of its shape);
8. one RouterConfig re-routed from the torus table to the snake-bus table:
   everything delivered, nothing lost, the kernel library neither rebuilt
   nor reloaded;
9. the paper's Tab. 4 injection workload (R in 1, 4, 8, 16, switch bubble,
   two saturated ports): both paths equal to the plain routers; delivered
   packets, drain ticks, ticks per packet, microseconds per run of each path
   in turns;
10. the stencil path over ``smi:packet`` (overlapped and not), equal bit for
    bit to the single-rank sweep, with 12,928 halo steps and 1,572,864 bytes
    per rank; kernels C (every launch on its warp path) and B must launch;
    then ``torch.profiler`` over 4 overlapped steps: device time by kernel
    and the host ops' self time;
11. ``allreduce``, ``reduce_scatter`` and ``reduce`` of 8 x 16 Mi float32
    over ``packet`` (2048 float32 per packet) on ring(1x8), torus(2x4) and
    the snake bus, equal bit for bit to ``static`` with no loss, every
    launch of kernel C on its warp path; then an ``allreduce`` on a 64-rank
    torus(8x8), past the warp path's 32 ranks: kernel C's thread path;
12. kernel E (``flash_attention_kernel``) against its plain version within
    1e-4 (float32, the FMA kernel) and 1.6e-2 (bfloat16, the wgmma kernel)
    on unit normals, each case asserting which path ran: yi-6b's prefill
    shape (32 heads x 4096 x 128, bfloat16, causal, where E, the FMA
    kernel on the same bfloat16 inputs, its plain version and
    ``scaled_dot_product_attention`` are timed), GQA 32/4 at 1000 real
    keys, Sq 256 != Skv 1024, a 2048-token window at head dim 256 and
    non-causal, each in both dtypes, and in bfloat16 head dim 16 (padded
    to 64) and Sq = 4032 (a multiple of 64, not of 128);
13. yi-6b at full width and depth through ``build_prefill`` on 4096 tokens:
    kernel E launched once per layer (32), every launch on the wgmma path,
    hidden states finite and within a row cosine of 0.999 of the same
    prefill with the plain refs; ms per prefill, tokens/s and kernel E's
    share of the profiled device time;
14. ``python -m repro_torch.launch.serve --arch yi-6b --requests 8
    --max-new 16 --slots 4 --capacity 256`` with ``--engine wave`` and
    ``continuous``: every request's tokens equal across the two engines;
    tokens/s and ms per decode step of each;
15. kernel F (``ssd_scan_kernel``) against its plain version within 1e-4
    (float32) and 1.6e-2 (bfloat16) of the largest magnitude, each case
    asserting the path it names (``ssd_path``: bfloat16 at head dim 64,
    state 128, chunk 128 -> ``wgmma``, the rest -> ``fma``), the ``wgmma``
    cases also within a mean row relative error of 1e-3 (the scores'
    precision; also at the prefill shape on a mamba2 layer's dt range,
    [0.01, 3.7) with A = -1): mamba2-2.7b's prefill shape (80 heads x 4096 x 64, state
    128, B and C one row shared by the heads) in bfloat16, where F on its
    wgmma path, the FMA kernel on the same inputs (``ms_before``) and the
    plain version are timed, and in float32 (the FMA kernel and the plain
    version timed); the reference's broadcast layout in float32, chunks of
    64, one chunk, five chunks (S = 640), a ragged S that the entry point
    pads, and a small case against the sequential ``ssd_ref`` (within
    2e-4);
16. mamba2-2.7b at full width and depth through ``build_prefill`` on 4096
    tokens: kernel F launched once per layer (64), every launch on the
    wgmma path, hidden states finite; every layer's update from its own
    input within a row cosine of 0.999 of the plain scan's, and the float32
    prefill (64 launches, all on the FMA kernel) within 0.999 of its plain
    run end to end (the bfloat16 end-to-end cosine is reported beside the
    noise of two plain runs); ms per prefill, tokens/s, kernel F's share of
    the profiled device time and the device's idle share, and a decode
    tick's wall/device split;
17. phase 14's serving run with ``--arch mamba2-2.7b``: wave and continuous
    tokens equal;
18. kernel D (``matmul``, the overlap engine's per-chunk GEMM) against its
    plain version ``matmul_ref`` within 2e-5 (float32) and 2e-2 (bfloat16)
    of the largest magnitude, each case asserting which path ran: the yi-6b
    TP prefill's four ring-step shapes at P = 8 in bfloat16 (Q, MLP-up with
    the ragged N = 1376, MLP-down with the ragged K = 1376, the
    out-projection), a strided batch and a shared weight on the wgmma
    path; the MLP-up shape in float32, ragged 2-D products and an odd K on
    the mma.sync path.  At each ring-step shape D on both paths and
    ``torch.matmul`` (cuBLAS) are timed beside D's bound, and the wgmma
    path's two grids (persistent, one CTA a tile); at MLP-up also the plain
    version;
19. yi-6b at full width and depth, tensor-parallel over P = 8 ranks stacked
    on the card, ``smi:static``, one sequence of 4096 tokens, bfloat16,
    kernel D injected with ``make_ctx(..., matmul_fn=matmul)``: D launched
    1,280 times (5 projections x 8 ring steps x 32 layers) and E 32 times,
    every launch of both on the wgmma path;
    the hidden states within a row cosine of 0.999 of the same TP prefill
    with ``matmul_fn=None`` (``build_prefill``) and of the tp = 1 prefill of
    the same weights; the ledger's per-tag bytes equal to their closed
    form; ms and tokens/s of the three prefills, and the profiled device
    time split by kernel;
20. the same prefill at 4 layers over ``smi:fused``: bit-equal to
    ``smi:static`` (kernel A's gather-fused form folds the reduce-scatters
    as ``ppermute`` + ``torch.add`` would), A launched once per
    reduce-scatter ring step;
21. channel latency (paper Tab. 3, ``repro_torch.launch.channels``): on an
    8-rank bus at 1, 4 and 7 hops over ``smi:static``, ``smi:fused`` and
    ``smi:packet``, ``open_channel(...).transfer`` of 8 float32 at
    ``n_chunks=1`` and a push/pop loop of 64 elements whose first element
    must arrive on the hops-th pop and whose destination must pop 64; µs
    per transfer and per pop; kernel C launched by the packet wire;
22. channel bandwidth (paper Fig. 9): the same bus at 16 KiB, 256 KiB, 4 MiB
    and 64 MiB per rank, 1, 4 and 7 hops, ``n_chunks=16``, over static,
    fused, packet (to 4 MiB) and ``compressed:static`` beside the
    unpipelined ``staged_p2p``, every delivery checked; GB/s;
23. GESUMMV (paper §5.4.1): ``y = 1.5 A x + 2.5 B x`` over two stacked
    ranks meeting through a channel, within 2e-4 of the single rank at N =
    1024 and 2048; both timed at N = 16384 in float32, GB/s beside the
    memory rate (both ranks share one card's memory: no 2x);
24. collective channels at 8 x 16 Mi float32 on ring(1x8) and torus(2x4)
    over ``smi:static`` and ``smi:fused``: the five kinds' ``transfer``
    bit-equal to the direct collectives, kernel A launched by the reduce
    channels' folds and the all-reduce channels' ring steps, the reduce and
    all-reduce channels timed beside the direct calls by device time; an
    all-reduce over ``compressed:static`` whose int8 wire and result equal
    the CPU's bits; a ``ChannelPool`` spec serving 1,000 all-reduces on one
    claim.

A ``{"kernels": [...]}`` line carries the rows of phases 6, 7, 12, 15 and
18 (A's and C's rows add ``launches_channels``, their launches in phases
21-24), each with the path its kernel ran (``simt``, ``vector``, ``warp``,
``thread``, ``fma`` or ``wgmma``); the rows of A, C, E, F's wgmma path and
D add ``ms_before``, the time in this run of the kernel their calls ran
before (for A, its scalar predecessor; for C's warp row, the thread path;
for F, the FMA kernel on the same bfloat16 inputs); C's rows add
``tick_floor_ms`` and ``us_per_tick``.  F has a row a path: ``wgmma``
launched by phase 16's bfloat16 prefill, ``fma`` by its float32 prefill.
Each phase prints its seconds.

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
#: H100 SXM dense bfloat16 tensor-core rate, operations per second
BF16_OPS_PER_S = 989e12

P = 8
REDUCE_ELEMS = 16 * 1024 * 1024  # per rank
STENCIL_ARGS = ["--grid", "2x4", "--domain", "8192x8192", "--steps", "32",
                "--comm-mode", "smi:static"]
PACKET_STENCIL_ARGS = STENCIL_ARGS[:-1] + ["smi:packet"]
#: halo traffic of one packet stencil run (32 steps of the 2x4 grid's four
#: slabs of a 4096x2048 tile): 404 router ticks a step, as
#: repro.netsim.predict_halo_stats gives for the packet wire
PACKET_HALO = (32 * 404, 32 * 49152)
DIMS = (2, 4)
#: a partial permutation of the P ranks: ranks 2 and 5 receive nothing
PARTIAL_PERM = [(0, 3), (1, 0), (3, 1), (4, 7), (6, 4), (7, 6)]
#: the reference's router equivalence configurations (tests/test_router.py)
EQ_CFGS = {
    "r1": dict(n_ports=1, R=1, switch_bubble=False, tick_batch=1),
    "r4_bubble": dict(n_ports=1, R=4, switch_bubble=True, tick_batch=2),
    "ports2_r8": dict(n_ports=2, R=8, switch_bubble=False, tick_batch=4),
    "ports2_bubble_r16": dict(n_ports=2, R=16, switch_bubble=True, tick_batch=3),
}


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


#: kernels this script times beside the port's, never used by the port:
#: the tick floor of kernel C's warp path (its block of 1024 threads, its
#: ticking warps and its one named barrier a tick, with no work), and kernel
#: A's scalar predecessor (one float32 a thread, 16 blocks of 256 a SM), the
#: kernel the vector one replaced
SMOKE_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>

// the warp path's tick with no work: a block of 1024 threads of which the
// first `ticking` take one named barrier (with its count) a tick
__global__ void tick_floor_kernel(int n, int ticking, int* ran) {
  if (static_cast<int>(threadIdx.x) >= ticking) return;
  int t = 0, count = 1;
  while (t < n && count) {
    ++t;
    const unsigned go = (threadIdx.x & 31) == 0 && t < n;
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
                 "bar.red.popc.u32 %0, 1, %1, p;\n\t}"
                 : "=r"(count) : "r"(ticking), "r"(go) : "memory");
  }
  if (threadIdx.x == 0) ran[0] = t;
}

__global__ void accumulate_scalar_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                       float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = a[i] + b[i];
}

extern "C" int smoke_tick_floor(int n, int ticking, void* ran, void* stream) {
  tick_floor_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(n, ticking,
                                                                       static_cast<int*>(ran));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smoke_accumulate_scalar(const void* a, const void* b, void* out, int64_t n,
                                     void* stream) {
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  accumulate_scalar_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
"""
_SMOKE_LIB = {}


def _start_smoke_build():
    """Start ``nvcc`` on :data:`SMOKE_CU` into ``build/chip_smoke/<hash>/``;
    returns (process or None when built, library path)."""
    import hashlib

    from repro_torch.kernels import build

    out = ROOT / "build" / "chip_smoke" / hashlib.sha256(SMOKE_CU.encode()).hexdigest()[:16]
    lib = out / "libsmoke.so"
    if lib.exists():
        return None, lib
    out.mkdir(parents=True, exist_ok=True)
    (out / "smoke.cu").write_text(SMOKE_CU)
    proc = subprocess.Popen([build._nvcc(), *build.ARCH, "-O3", "-std=c++17", "-shared",
                             "-Xcompiler", "-fPIC", "-Xptxas=-v", str(out / "smoke.cu"), "-o",
                             str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def smoke_lib():
    """The loaded library of :data:`SMOKE_CU` (built in phase 1)."""
    return _SMOKE_LIB["lib"]


def smoke_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


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


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: its kernels' own time
    under ``torch.profiler`` over ``reps`` calls, after warm-up.  Where the
    host takes longer to issue a call than the card to run it (a short
    kernel behind a Python wrapper), CUDA events around back-to-back calls
    time the host; this times the kernels."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    busy, _, _ = _profile_device_ms(lambda: [fn() for _ in range(reps)])
    return busy / reps


def graph_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` captured once in a CUDA graph and
    replayed: CUDA events around ``reps`` replays, no host work between the
    kernels (a second measure of device time beside :func:`device_ms`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps=reps)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the card's peak rate for their type (float32 unless
    named)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.router import router_run
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    stencil_sweep.launches = fused_accumulate.launches = router_run.launches = 0
    fused_shift_accumulate.launches = router_run.warp_launches = 0
    flash_attention_kernel.launches = ssd_scan_kernel.launches = matmul.launches = 0
    flash_attention_kernel.wgmma_launches = matmul.wgmma_launches = 0
    ssd_scan_kernel.wgmma_launches = 0


def phase_build():
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    proc, smoke = _start_smoke_build()
    lib = build.build()
    build.library()
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on chip_smoke's own kernels:\n{out}")
    import ctypes

    slib = ctypes.CDLL(str(smoke))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    slib.smoke_tick_floor.argtypes = [i32, i32, p, p]
    slib.smoke_accumulate_scalar.argtypes = [p, p, p, ctypes.c_int64, p]
    _SMOKE_LIB["lib"] = slib
    log(f"kernels built in {time.perf_counter() - t0:.1f}s -> {lib}")
    # every kernel's registers, stack and spills; each entry's name first
    for line in (lib.parent / "build.log").read_text().splitlines() if \
            (lib.parent / "build.log").exists() else []:
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
            log(f"ptxas: {entry[:110]}")
        elif "registers" in line or "stack frame" in line or "error" in line.lower():
            log(f"ptxas:   {line.strip()}")


def phase_accumulate(dev) -> float:
    import torch

    from repro_torch.transport.fused import (
        accumulate_plain,
        fused_accumulate,
        fused_shift_accumulate,
        shift_accumulate_plain,
        source_index,
    )

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
            # the gather-fused form on the same sizes as P rank rows (an odd
            # row length at the ragged size, so that rows sit at different
            # offsets modulo 16 bytes), a ring shift and a partial permutation
            # whose ranks 2 and 5 receive nothing (a -0.0 addend there), with
            # x from the start of its buffer and one element into it
            m = -(-n // P)
            flat = torch.cat((a, b))[:P * m + 1]
            for offset in (0, 1):
                x = flat[offset:offset + P * m].view(P, m)
                addend = torch.cat((b, a))[:P * m].view(P, m).clone()
                if dtype != torch.int32:
                    addend[2] = -0.0
                for pname, pairs in (("ring+1", [(i, (i + 1) % P) for i in range(P)]),
                                     ("partial", PARTIAL_PERM)):
                    src = source_index(tuple(pairs), P, dev)
                    before = fused_shift_accumulate.launches
                    got = fused_shift_accumulate(x, addend, src)
                    want = shift_accumulate_plain(x, addend, src)
                    torch.cuda.synchronize()
                    if fused_shift_accumulate.launches != before + 1 or not same_bits(got, want):
                        raise AssertionError(f"shift_accumulate {dtype} ({P}, {m}) offset "
                                             f"{offset} {pname}: kernel != plain")
                    worst = max(worst, max_abs_err(got, want))
            log(f"shift_accumulate {str(dtype):>8} ({P}, {m:>7}): bit-equal to plain "
                f"(ring shift and partial permutation, aligned and at an odd offset)")
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


def phase_stencil_profile(dev, n_steps: int = 8, comm_mode: str = "smi:static",
                          schedules=(True, False)) -> dict:
    """Where a stencil step's time goes: ``torch.profiler`` over ``n_steps``
    warm steps of each schedule at the path's shape over ``comm_mode``;
    device time by kernel per step, the device's idle share of the wall
    time, and the host ops that hold the most host time (self time; over the
    packet wire, the packetising around each router launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps import DistributedStencil

    app = DistributedStencil.create((2, 4), comm_mode=comm_mode, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = app.scatter(torch.randn((8192, 8192), generator=g, device=dev))
    out = {}
    for overlapped in schedules:
        t = app.halo_schedule.resolve_transport()
        app.run(x, 2, overlapped=overlapped, transport=t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            app.run(x, n_steps, overlapped=overlapped, transport=t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        events = prof.key_averages()
        # device events only: a CPU op's self device time repeats its kernels'
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                       for e in events
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      key=lambda kv: -kv[1])
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / n_steps, e.count / n_steps)
                       for e in events
                       if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
                      key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in rows)
        host_ms = sum(ms for _, ms, _ in host)
        sched = f"{comm_mode} {'overlapped' if overlapped else 'reference'}"
        log(f"profile {sched}: wall {wall_ms:.4f} ms/step, device busy {busy:.4f} ms/step "
            f"(idle {max(0.0, 1 - busy / wall_ms):.1%}), host ops' self time {host_ms:.4f} "
            f"ms/step, {n_steps} steps")
        for name, ms in rows[:10]:
            log(f"profile {sched}:   {ms:.4f} ms/step  {name[:90]}")
        for name, ms, calls in host[:10]:
            log(f"profile {sched}: host {ms:.4f} ms/step in {calls:.0f} calls  {name[:70]}")
        out[sched] = dict(wall_ms=wall_ms, device_ms=busy, host_ms=host_ms, device=rows[:10],
                          host=host[:10])
    return out


def phase_reductions(dev) -> tuple[dict, dict]:
    """Phase 5: the fused reductions bit-equal to the static ones, with equal
    stats; each ring step one launch of the gather-fused add, the rooted
    folds on the add kernel; then each reduction timed over ``smi:static``
    and ``smi:fused`` in turns (static, fused, fused, static).  Returns the
    launches of both entry points of A and the times."""
    import torch

    from repro_torch.core import Communicator
    from repro_torch.core.collectives import allreduce, reduce, stream_reduce_scatter
    from repro_torch.transport import get_transport
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    x_before = x.clone()
    ops = {"allreduce": lambda v, c, t: allreduce(v, c, transport=t),
           "reduce_scatter": lambda v, c, t: stream_reduce_scatter(v, c, transport=t),
           "reduce": lambda v, c, t: reduce(v, c, root=3, transport=t)}
    #: launches of the gather-fused add a call makes: one per ring step
    ring_steps = {"allreduce": P - 1, "reduce_scatter": P - 1, "reduce": 0}
    reset_counts()
    times, launches = {}, {"shift": 0, "fold": 0}
    for names, sizes in ((("x",), (8,)), (("x", "y"), (2, 4))):
        comm = Communicator.create(names, sizes, device=dev)
        for name, op in ops.items():
            ts, tf = get_transport("static", device=dev), get_transport("fused", device=dev)
            want = op(x, comm, ts)
            before = (fused_shift_accumulate.launches, fused_accumulate.launches)
            got = op(x, comm, tf)
            torch.cuda.synchronize()
            shifts = fused_shift_accumulate.launches - before[0]
            folds = fused_accumulate.launches - before[1]
            launches["shift"] += shifts
            launches["fold"] += folds
            if not same_bits(got, want) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} on {sizes}: smi:fused != smi:static")
            if (tf.stats.steps, tf.stats.bytes_moved) != (ts.stats.steps, ts.stats.bytes_moved):
                raise AssertionError(f"{name} on {sizes}: stats differ")
            if shifts != ring_steps[name] or (name == "reduce") != (folds > 0):
                raise AssertionError(f"{name} on {sizes}: {shifts} gather-fused launches (not "
                                     f"{ring_steps[name]}) and {folds} plain folds")
            log(f"{name:>14} on {str(sizes):>7}: smi:fused bit-equal to smi:static "
                f"({tf.stats.steps} steps, {tf.stats.bytes_moved} B per rank; A launched "
                f"{shifts} times gather-fused, {folds} as the plain add)")
            del want, got
            ms, dev_ms = {}, {}
            for mode in ("static", "fused", "fused", "static"):
                t = ts if mode == "static" else tf
                ms.setdefault(mode, []).append(time_ms(lambda: op(x, comm, t), reps=10,
                                                       warmup=2))
                dev_ms.setdefault(mode, []).append(device_ms(lambda: op(x, comm, t), reps=5,
                                                             warmup=1))
            key = f"{name}/{'ring(1x8)' if len(sizes) == 1 else 'torus(2x4)'}"
            times[key] = {m: sum(v) / len(v) for m, v in ms.items()} | {
                f"device_{m}": sum(v) / len(v) for m, v in dev_ms.items()} | {"turns_ms": ms}
            tk = times[key]
            log(f"{name:>14} on {str(sizes):>7}: smi:static {tk['static']:.4f} ms, smi:fused "
                f"{tk['fused']:.4f} ms ({tk['fused'] / tk['static'] - 1:+.1%}; turns "
                f"{', '.join(f'{v:.4f}' for v in ms['static'][:1] + ms['fused'] + ms['static'][1:])}"
                f"); device time {tk['device_static']:.4f} and {tk['device_fused']:.4f} ms "
                f"({tk['device_fused'] / tk['device_static'] - 1:+.1%})")
    if not same_bits(x, x_before):
        raise AssertionError("a reduction modified its input")
    if min(launches.values()) == 0:
        raise AssertionError(f"the fused reductions launched kernel A {launches}")
    log(f"reduction path: kernel A launched {launches['shift']} times gather-fused and "
        f"{launches['fold']} times as the plain add (the checked runs; the timed runs come "
        f"after)")
    return launches, times


def phase_kernel_table(dev, launches_a, launches_b, err_a, err_b) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.core.comm import ppermute
    from repro_torch.kernels.build import current_stream
    from repro_torch.kernels.stencil import stencil_sweep, stencil_sweep_plain
    from repro_torch.transport.fused import (
        accumulate_plain,
        fused_accumulate,
        fused_shift_accumulate,
        shift_accumulate_plain,
        source_index,
    )

    torch.backends.cudnn.allow_tf32 = False  # the library stencil stays in float32
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []

    def scalar_add(a, b):
        """Kernel A's scalar predecessor on the same inputs (``ms_before``)."""
        out = torch.empty_like(a)
        smoke_launch(smoke_lib().smoke_accumulate_scalar(a.data_ptr(), b.data_ptr(),
                                                       out.data_ptr(), a.numel(),
                                                       current_stream(a)), "scalar accumulate")
        return out

    # A at the all-reduce's fold shape, one (P, 16Mi/P) block per step, and
    # at the rooted reduce's (P, 16Mi); its scalar predecessor and torch.add
    # on the same inputs, in turns, each by its device time
    per_shape = {}
    for shape in ((P, REDUCE_ELEMS // P), (P, REDUCE_ELEMS)):
        a = torch.randn(shape, generator=g, device=dev)
        b = torch.randn(shape, generator=g, device=dev)
        if not same_bits(scalar_add(a, b), fused_accumulate(a, b)):
            raise AssertionError(f"the scalar accumulate kernel disagrees at {shape}")
        t = {k: [] for k in ("ms", "ms_before", "library_ms")}
        for _ in range(2):
            t["ms"].append(device_ms(lambda: fused_accumulate(a, b)))
            t["ms_before"].append(device_ms(lambda: scalar_add(a, b)))
            t["library_ms"].append(device_ms(lambda: torch.add(a, b)))
        t = {k: sum(v) / len(v) for k, v in t.items()}
        t["bound_ms"] = bound(3 * a.numel() * a.element_size(), a.numel())[0]
        t["plain_ms"] = time_ms(lambda: accumulate_plain(a, b))
        per_shape[shape] = t
        log(f"accumulate at {list(shape)} f32: {t['ms']:.4f} ms (the scalar predecessor "
            f"{t['ms_before']:.4f} ms, torch.add {t['library_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms: "
            f"{t['bound_ms'] / t['ms']:.1%} of the bytes rate)")
        del a, b
    t = per_shape[(P, REDUCE_ELEMS // P)]
    rows.append(dict(
        name="accumulate", route="cuda", path="vector",
        source="src/repro_torch/csrc/accumulate.cu", replaces="src/repro/transport/fused.py:35",
        launches=launches_a["fold"], max_abs_err=err_a, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by="bytes", library_ms=t["library_ms"],
        ms_before=t["ms_before"], shape=[P, REDUCE_ELEMS // P], dtype="float32",
        at_8x16mi={k: v for k, v in per_shape[(P, REDUCE_ELEMS)].items()}))

    # A's gather-fused form at one ring step of the all-reduce: (P, 16Mi/P),
    # a +1 ring shift; beside it the unfused composition (ppermute, then add)
    x = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    addend = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    pairs = [(i, (i + 1) % P) for i in range(P)]
    src = source_index(tuple(pairs), P, dev)
    got = fused_shift_accumulate(x, addend, src)
    if not same_bits(got, torch.add(ppermute(x, pairs), addend)):
        raise AssertionError("shift_accumulate != ppermute + torch.add")
    t = {k: [] for k in ("ms", "unfused_ms")}
    for _ in range(2):
        t["ms"].append(device_ms(lambda: fused_shift_accumulate(x, addend, src)))
        t["unfused_ms"].append(device_ms(lambda: torch.add(ppermute(x, pairs), addend)))
    t = {k: sum(v) / len(v) for k, v in t.items()}
    t_bound, by = bound(3 * x.numel() * x.element_size(), x.numel())
    plain_ms = time_ms(lambda: shift_accumulate_plain(x, addend, src))
    log(f"shift_accumulate at {list(x.shape)} f32, ring +1: {t['ms']:.4f} ms (unfused "
        f"ppermute + torch.add {t['unfused_ms']:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{t_bound:.4f} ms: {t['ms'] / t_bound:.2f}x the bound)")
    rows.append(dict(
        name="shift_accumulate", route="cuda", path="vector",
        source="src/repro_torch/csrc/accumulate.cu", replaces="src/repro/transport/fused.py:35",
        launches=launches_a["shift"], max_abs_err=err_a, ms=t["ms"], plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=None, unfused_ms=t["unfused_ms"],
        shape=list(x.shape), dtype="float32"))
    del x, addend, got

    # B at the stencil path's shape: the (8, 4096, 2048) tile stack
    x = torch.randn((P, 4096, 2048), generator=g, device=dev)
    w = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25], [0.0, 0.25, 0.0]],
                     device=dev).view(1, 1, 3, 3)
    x4 = x.view(P, 1, 4096, 2048)
    t_bound, by = bound(2 * x.numel() * x.element_size(), 5 * x.numel())
    rows.append(dict(
        name="stencil_sweep", route="cuda", path="simt", source="src/repro_torch/csrc/stencil.cu",
        replaces="src/repro/kernels/stencil/kernel.py:43", launches=launches_b,
        max_abs_err=err_b, ms=time_ms(lambda: stencil_sweep(x)),
        plain_ms=time_ms(lambda: stencil_sweep_plain(x)), bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: F.conv2d(x4, w, padding=1)), shape=list(x.shape),
        dtype="float32"))
    return rows


# -- the packet router (kernel C) ----------------------------------------------------


def _stage(dev, n_ports, fifo_cap, pkt_elems, msgs):
    """(src, port, dst, value) messages -> staged (pay, dst, len) on ``dev``."""
    import numpy as np
    import torch

    pay = np.zeros((P, n_ports, fifo_cap, pkt_elems), np.float32)
    dst = np.zeros((P, n_ports, fifo_cap), np.int32)
    ln = np.zeros((P, n_ports), np.int32)
    for s, p, d, val in msgs:
        i = ln[s, p]
        pay[s, p, i] = val
        dst[s, p, i] = d
        ln[s, p] += 1
    return [torch.from_numpy(a).to(dev) for a in (pay, dst, ln)]


def _tables(dev):
    import torch

    from repro_torch.core import Topology, make_router_tables, snake_bus

    return {name: torch.from_numpy(make_router_tables(topo, DIMS)).to(dev)
            for name, topo in (("torus", Topology.torus(DIMS)), ("snake_bus", snake_bus(DIMS)))}


def _halo_job(dev):
    """The router run of one E/W halo permute of the packet stencil: a
    4096-float32 column slab per rank, 32 float32 per packet."""
    import torch

    from repro_torch.core import Communicator
    from repro_torch.netsim import halo_pairs
    from repro_torch.transport import get_transport

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    vec = torch.randn((P, 4096), generator=g, device=dev)
    tp = get_transport("packet", device=dev, pkt_elems=32)
    return comm, tp.router_job(vec, comm, halo_pairs(DIMS, 0, +1))


def _router_paths(dev, cfg, comm, tbl, pay, dst, ln, n_steps, name):
    """One router job through both paths of kernel C (the default one and
    the other forced), each held bit for bit against the vector and scalar
    routers, and the two paths' tick counts equal.  Returns the default
    path's outputs and the ticks."""
    import torch

    from repro_torch.core import run_router
    from repro_torch.core.router import _fabric
    from repro_torch.kernels.router import router_path, router_run, tick_spec_of

    names = ("out_pay", "out_cnt", "overflow", "t_done")
    _, link_ids, src = _fabric(tuple(cfg.dims), dev)
    spec = tick_spec_of(cfg, comm.size, link_ids)
    default = router_path(comm.size, cfg.n_ports, spec.n_links, cfg.fifo_cap, cfg.transit_cap)
    before = (router_run.launches, router_run.warp_launches)
    got = run_router(cfg, comm, tbl, pay, dst, ln, n_steps, impl="kernel")
    torch.cuda.synchronize()
    if (router_run.launches, router_run.warp_launches) != \
            (before[0] + 1, before[1] + (default == "warp")):
        raise AssertionError(f"router {name}: the {default} path's counter did not move")
    outs = {default: got}
    for path in ("warp", "thread"):
        if path != default:
            outs[path] = router_run(spec, tbl, src, pay, dst, ln, n_steps, path=path)[:4]
    ticks = {path: int(router_run(spec, tbl, src, pay, dst, ln, n_steps, path=path)[4])
             for path in outs}
    for impl in ("vector", "scalar"):
        want = run_router(cfg, comm, tbl, pay, dst, ln, n_steps, impl=impl)
        torch.cuda.synchronize()
        for path, out in outs.items():
            for a, b, nm in zip(out, want, names):
                if not same_bits(a, b):
                    raise AssertionError(f"router {name}: the {path} path != {impl} on {nm}")
    if len(set(ticks.values())) != 1:
        raise AssertionError(f"router {name}: the paths ran different ticks {ticks}")
    return got, ticks[default]


def _tick_floor_ms(dev, ticks: int, threads: int) -> float:
    """Milliseconds of ``ticks`` empty ticks of the warp path's barrier
    pattern (one counting named barrier a tick over its ``threads`` ticking
    threads, in a block of 1024): the least a run of that many ticks can
    take on this card."""
    import torch

    from repro_torch.kernels.build import current_stream

    ran = torch.zeros((1,), dtype=torch.int32, device=dev)

    def launch():
        smoke_launch(smoke_lib().smoke_tick_floor(ticks, threads, ran.data_ptr(),
                                                  current_stream(ran)), "tick floor")

    launch()
    torch.cuda.synchronize()
    if int(ran) != ticks:
        raise AssertionError(f"the tick floor kernel ran {int(ran)} of {ticks} ticks")
    return device_ms(launch, reps=50)


def phase_router_kernel(dev) -> tuple[float, list[dict]]:
    """Kernel C, both paths, against the vector and scalar routers; returns
    the worst error and the halo-shape timing rows of the kernel table."""
    import numpy as np

    from repro_torch.core import Communicator, RouterConfig, run_router

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    tables = _tables(dev)
    cases = []
    for name, kw in sorted(EQ_CFGS.items()):
        cfg = RouterConfig(dims=DIMS, fifo_cap=6, transit_cap=8, out_cap=16, pkt_elems=4, **kw)
        rng = np.random.RandomState(sum(map(ord, name)) % 1000)
        msgs = [(s, p, rng.randint(0, P), float(rng.randint(1, 99)))
                for s in range(P) for p in range(cfg.n_ports) for _ in range(rng.randint(0, 5))]
        for topo in ("torus", "snake_bus"):
            cases.append((f"{name}/{topo}", cfg, tables[topo], msgs, 64))
    cfg = RouterConfig(dims=DIMS, n_ports=1, fifo_cap=8, transit_cap=16, out_cap=2, pkt_elems=4)
    cases.append(("out_cap_overrun", cfg, tables["torus"],
                  [(s, 0, 0, float(10 + s)) for s in (1, 2, 4, 5)], 64))
    cfg = RouterConfig(dims=DIMS, n_ports=1, fifo_cap=8, transit_cap=8, out_cap=8, pkt_elems=4,
                       tick_batch=4)
    cases.append(("step_budget", cfg, tables["torus"],
                  [(s, 0, (s + 1 + k) % P, float(10 * s + k)) for s in range(P) for k in range(4)],
                  5))
    cfg = RouterConfig(dims=DIMS, n_ports=2, fifo_cap=6, transit_cap=1, out_cap=16, pkt_elems=4,
                       R=4)
    cases.append(("transit_cap_1", cfg, tables["torus"],
                  [(s, p, (s + 2 + 3 * p) % P, float(10 * s + p)) for s in range(P)
                   for p in range(2) for _ in range(3)], 64))
    worst = 0.0
    for name, cfg, tbl, msgs, n_steps in cases:
        staged = _stage(dev, cfg.n_ports, cfg.fifo_cap, cfg.pkt_elems, msgs)
        got, ticks = _router_paths(dev, cfg, comm, tbl, *staged, n_steps, name)
        log(f"router {name:>26}: warp and thread paths bit-equal to vector and scalar "
            f"(delivered {int(got[1].sum())}, overflow {int(got[2].sum())}, {ticks} ticks)")
        if name == "out_cap_overrun" and (int(got[1][0, 0]), int(got[2].sum())) != (2, 2):
            raise AssertionError("out_cap overrun: expected 2 delivered and 2 counted")
        if name == "transit_cap_1" and int(got[2].sum()) == 0:
            raise AssertionError("an undersized transit counted no overflow")

    # the halo shape: also where kernel C is timed, both paths in turns
    from repro_torch.core.router import _fabric
    from repro_torch.kernels.router import router_run, tick_spec_of
    from repro_torch.kernels.router.kernel import warp_lanes

    comm, (cfg, tbl, pay, dst, ln, n_steps) = _halo_job(dev)
    args = (cfg, comm, tbl, pay, dst, ln, n_steps)
    got, ticks = _router_paths(dev, *args[:3], pay, dst, ln, n_steps, "halo shape")
    for impl in ("vector", "scalar"):
        worst = max(worst, max_abs_err(got[0], run_router(*args, impl=impl)[0]))
    links, link_ids, src = _fabric(DIMS, dev)
    spec = tick_spec_of(cfg, P, link_ids)
    packets = int(ln.sum())
    if int(got[1].sum()) != packets or int(got[2].sum()) != 0:
        raise AssertionError("router halo shape: packets lost")
    # device time: the host issues a warp-path call more slowly than the card
    # runs it, so CUDA events around back-to-back calls would time the host;
    # measured two ways, the kernels' time under the profiler and a CUDA
    # graph of one call replayed
    turns, graph_turns = {"warp": [], "thread": []}, {"warp": [], "thread": []}
    for path in ("warp", "thread", "thread", "warp"):
        run = lambda: router_run(spec, tbl, src, pay, dst, ln, n_steps, path=path)  # noqa: E731
        turns[path].append(device_ms(run))
        graph_turns[path].append(graph_ms(run))
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    wall_ms = time_ms(lambda: router_run(spec, tbl, src, pay, dst, ln, n_steps))
    log("router halo shape, turns (warp, thread, thread, warp) in ms: profiler " + ", ".join(
        f"{p} {v:.4f}" for p, vs in turns.items() for v in vs) + "; graph replay " + ", ".join(
        f"{p} {v:.4f}" for p, vs in graph_turns.items() for v in vs))
    lanes = warp_lanes(cfg.n_ports, len(links))
    ticking = 2 * 32 * -(-P // (32 // lanes))  # the ranks' control and delivery warps
    floor_ms = _tick_floor_ms(dev, ticks, ticking)
    plain_ms = time_ms(lambda: run_router(*args, impl="vector"), reps=3, warmup=1)
    # bytes: each staged packet and header read once, the lengths, route
    # table and exchange table read once, every output written once
    E, itemsize = cfg.pkt_elems, 4
    nbytes = itemsize * (packets * (E + 1) + ln.numel() + tbl.numel() + src.numel() + len(links)
                         + got[0].numel() + got[1].numel() + got[2].numel() + got[3].numel())
    bytes_ms, _ = bound(nbytes, 0)
    log(f"router halo shape: {packets} packets, {ticks} of {n_steps} ticks run; warp path "
        f"{ms['warp']:.4f} ms ({ms['warp'] / ticks * 1e3:.3f} us/tick), thread path "
        f"{ms['thread']:.4f} ms ({ms['thread'] / ticks * 1e3:.3f} us/tick), tick floor "
        f"{floor_ms:.4f} ms ({floor_ms / ticks * 1e3:.3f} us/tick, {ticking} threads), all "
        f"device time; back-to-back calls {wall_ms:.4f} ms a call (CUDA events); plain "
        f"{plain_ms:.4f} ms, bytes {bytes_ms:.6f} ms")
    rows = []
    for path in ("warp", "thread"):
        rows.append(dict(
            name="router_run", route="cuda", path=path, source="src/repro_torch/csrc/router.cu",
            replaces="src/repro/kernels/router/kernel.py:83", launches=0, max_abs_err=worst,
            ms=ms[path], plain_ms=plain_ms, bound_ms=bytes_ms, bound_by="bytes",
            tick_floor_ms=floor_ms, tick_floor_by="tick chain", library_ms=None, ticks=ticks,
            tick_budget=n_steps, events_ms_per_call=wall_ms if path == "warp" else None,
            graph_ms=sum(graph_turns[path]) / len(graph_turns[path]),
            us_per_tick=ms[path] / ticks * 1e3, floor_us_per_tick=floor_ms / ticks * 1e3,
            shape=list(pay.shape), dtype="float32"))
    rows[0]["ms_before"] = ms["thread"]
    return worst, rows


def phase_router_reroute(dev):
    """One RouterConfig, the torus table then the snake-bus table: all
    delivered, nothing lost, no rebuild and no reload of the kernels."""
    from repro_torch.core import Communicator, RouterConfig, run_router
    from repro_torch.kernels import build

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    cfg = RouterConfig(dims=DIMS)
    msgs = [(0, 0, 5, 9.0), (2, 1, 6, 8.0), (7, 0, 1, 3.0), (4, 1, 3, 2.0), (6, 0, 0, 7.0)]
    staged = _stage(dev, cfg.n_ports, cfg.fifo_cap, cfg.pkt_elems, msgs)
    lib, cache, digest = build.library(), build.library.cache_info(), build._digest()
    for topo, tbl in _tables(dev).items():
        out_pay, out_cnt, ovf, _ = run_router(cfg, comm, tbl, *staged, 64, impl="kernel")
        if int(ovf.sum()) != 0:
            raise AssertionError(f"re-route {topo}: packets lost")
        for _s, p, d, val in msgs:
            if val not in out_pay[d, p, :int(out_cnt[d, p]), 0].tolist():
                raise AssertionError(f"re-route {topo}: message {val} not delivered")
    after = build.library.cache_info()
    if build.library() is not lib or after.misses != cache.misses or build._digest() != digest:
        raise AssertionError("re-routing rebuilt or reloaded the kernel library")
    log(f"re-route: torus then snake bus on one config, {len(msgs)} messages each, "
        f"delivered, no loss; the kernel library was neither rebuilt nor reloaded")


def phase_injection(dev) -> list[dict]:
    """The paper's Tab. 4 (benchmarks/injection.py): both FIFOs of every
    rank saturated toward the same +y link, switch bubble on; both paths of
    kernel C checked against the plain routers and timed in turns."""
    from repro_torch.core import Communicator, RouterConfig
    from repro_torch.core.router import _fabric
    from repro_torch.kernels.router import router_run, tick_spec_of

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    tbl = _tables(dev)["torus"]
    _, link_ids, src = _fabric(DIMS, dev)
    rows = []
    for R in (1, 4, 8, 16):
        cfg = RouterConfig(dims=DIMS, n_ports=2, fifo_cap=8, out_cap=32, transit_cap=32, R=R,
                           switch_bubble=True)
        msgs = []
        for r in range(P):
            row, col = divmod(r, 4)
            msgs += [(r, 0, row * 4 + (col + 1) % 4, 0.0)] * 8   # +y, 1 hop
            msgs += [(r, 1, row * 4 + (col + 2) % 4, 0.0)] * 8   # +y twice, 2 hops
        staged = _stage(dev, 2, 8, cfg.pkt_elems, msgs)
        got, ticks = _router_paths(dev, cfg, comm, tbl, *staged, 96, f"injection R={R}")
        delivered, lost = int(got[1].sum()), int(got[2].sum())
        drain = int(got[3].max()) + 1
        if lost:
            raise AssertionError(f"injection R={R}: {lost} packets lost")
        spec = tick_spec_of(cfg, P, link_ids)
        us = {"warp": [], "thread": []}
        for path in ("warp", "thread", "thread", "warp"):
            us[path].append(device_ms(lambda: router_run(spec, tbl, src, *staged, 96,
                                                         path=path)) * 1e3)
        us = {k: sum(v) / len(v) for k, v in us.items()}
        rows.append(dict(R=R, delivered=delivered, drain_ticks=drain, ticks=ticks,
                         ticks_per_packet=drain / (delivered / P), us_per_run_warp=us["warp"],
                         us_per_run_thread=us["thread"]))
        log(f"injection R={R:>2}: delivered {delivered}, drain {drain} ticks ({ticks} run), "
            f"{drain / (delivered / P):.2f} ticks/packet, device time warp {us['warp']:.1f} "
            f"us/run, thread {us['thread']:.1f} us/run, overflow {lost}")
    return rows


def phase_packet_stencil() -> tuple[int, dict]:
    import torch

    from repro_torch.kernels.router import router_run
    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.launch import stencil as launch_stencil

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for sched, extra in (("overlapped", []), ("reference", ["--no-overlap"])):
            out = os.path.join(tmp, f"{sched}.json")
            rc = launch_stencil.main([*PACKET_STENCIL_ARGS, *extra, "--json", out])
            torch.cuda.synchronize()
            res = json.loads(Path(out).read_text())
            if rc != 0 or not res["ok"] or res["max_err"] != 0.0:
                raise AssertionError(f"packet stencil {sched}: rc={rc} result={res}")
            if (res["halo_steps"], res["halo_bytes_per_rank"]) != PACKET_HALO:
                raise AssertionError(f"packet stencil {sched}: halo {res['halo_steps']} steps / "
                                     f"{res['halo_bytes_per_rank']} B, expected {PACKET_HALO}")
            results[sched] = res
        launches_c, launches_b = router_run.launches, stencil_sweep.launches
        warp_c = router_run.warp_launches
    if launches_c == 0 or launches_b == 0 or warp_c != launches_c:
        raise AssertionError(f"packet stencil path launched kernel C {launches_c} times "
                             f"({warp_c} on the warp path) and kernel B {launches_b} times")
    for sched, res in results.items():
        log(f"packet stencil {sched}: {res['wall_per_step_s'] * 1e3:.4f} ms/step, halo "
            f"{res['halo_steps']} steps / {res['halo_bytes_per_rank']} B per rank, equal to "
            f"the single-rank sweep")
    log(f"packet stencil path: kernel C launched {launches_c} times (all on the warp path), "
        f"kernel B {launches_b}")
    return launches_c, results


def phase_packet_reductions(dev) -> dict:
    import torch

    from repro_torch.core import Communicator, snake_bus
    from repro_torch.core.collectives import allreduce, reduce, stream_reduce_scatter
    from repro_torch.kernels.router import router_run
    from repro_torch.transport import get_transport

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    ops = {"allreduce": lambda v, c, t: allreduce(v, c, transport=t),
           "reduce_scatter": lambda v, c, t: stream_reduce_scatter(v, c, transport=t),
           "reduce": lambda v, c, t: reduce(v, c, root=3, transport=t)}
    comms = {"ring(1x8)": Communicator.create(("x",), (8,), device=dev),
             "torus(2x4)": Communicator.create(("x", "y"), DIMS, device=dev),
             "snake_bus(2x4)": Communicator.create(("x", "y"), DIMS, topology=snake_bus(DIMS),
                                                   device=dev)}
    reset_counts()
    for cname, comm in comms.items():
        for name, op in ops.items():
            ts = get_transport("static", device=dev)
            tp = get_transport("packet", device=dev, pkt_elems=2048)
            t0 = time.perf_counter()
            got = op(x, comm, tp)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            want = op(x, comm, ts)
            torch.cuda.synchronize()
            if not same_bits(got, want) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} on {cname}: smi:packet != smi:static")
            if int(tp.stats.overflow.sum()) != 0:
                raise AssertionError(f"{name} on {cname}: packets lost")
            log(f"{name:>14} on {cname:>14}: smi:packet bit-equal to smi:static, overflow 0, "
                f"{tp.stats.steps} router ticks budgeted, {secs * 1e3:.1f} ms")
    launches, warp = router_run.launches, router_run.warp_launches
    if launches == 0 or warp != launches:
        raise AssertionError(f"the packet reductions launched kernel C {launches} times, "
                             f"{warp} on the warp path")
    # 64 ranks, past the warp path's 32: the thread path
    comm = Communicator.create(("x", "y"), (8, 8), device=dev)
    x64 = torch.randn((64, 64 * 1024), generator=g, device=dev)
    tp = get_transport("packet", device=dev, pkt_elems=2048)
    t0 = time.perf_counter()
    got = allreduce(x64, comm, transport=tp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not same_bits(got, allreduce(x64, comm, transport=get_transport("static", device=dev))):
        raise AssertionError("allreduce on torus(8x8): smi:packet != smi:static")
    if int(tp.stats.overflow.sum()) != 0:
        raise AssertionError("allreduce on torus(8x8): packets lost")
    thread = router_run.launches - launches
    if thread == 0 or router_run.warp_launches != warp:
        raise AssertionError(f"the 64-rank allreduce launched kernel C {thread} times, "
                             f"{router_run.warp_launches - warp} on the warp path")
    log(f"     allreduce on     torus(8x8): smi:packet bit-equal to smi:static, overflow 0, "
        f"{tp.stats.steps} router ticks budgeted, {secs * 1e3:.1f} ms")
    log(f"packet reduction path: kernel C launched {launches} times on the warp path (8 ranks) "
        f"and {thread} times on the thread path (64 ranks)")
    return {"warp": launches, "thread": thread}


# -- the dense model: flash attention (kernel E), prefill, serving ---------------------

#: yi-6b's attention at the prefill shape: one sequence of 4096 tokens, its
#: 32 query heads over KV heads expanded to 32 (the model path), head dim 128
PREFILL_TOKENS = 4096
#: kernel E's cases: (name, BH, H, Hkv, Sq, Skv, skv_actual, D, causal, window,
#: dtype); Sq and Skv are the wrapper's padded lengths.  bfloat16 runs on the
#: wgmma kernel, float32 on the FMA one: each bfloat16 shape is there in
#: float32 too, and D = 16 (padded to 64) and an Sq that is a multiple of 64
#: but not of 128 (the wgmma kernel's query block) are bfloat16 only
FA_CASES = (
    ("prefill_bf16_causal", 32, 32, 32, 4096, 4096, 4096, 128, True, None, "bfloat16"),
    ("gqa_32_4_f32_ragged", 32, 32, 4, 1024, 1024, 1000, 128, True, None, "float32"),
    ("sq256_skv1024_f32", 32, 32, 32, 256, 1024, 1024, 128, True, None, "float32"),
    ("window2048_d256_f32", 16, 16, 16, 4096, 4096, 4096, 256, True, 2048, "float32"),
    ("noncausal_f32", 32, 32, 32, 1024, 1024, 1024, 128, False, None, "float32"),
    ("gqa_32_4_bf16_ragged", 32, 32, 4, 1024, 1024, 1000, 128, True, None, "bfloat16"),
    ("sq256_skv1024_bf16", 32, 32, 32, 256, 1024, 1024, 128, True, None, "bfloat16"),
    ("window2048_d256_bf16", 16, 16, 16, 4096, 4096, 4096, 256, True, 2048, "bfloat16"),
    ("noncausal_bf16", 32, 32, 32, 1024, 1024, 1024, 128, False, None, "bfloat16"),
    ("d16_padded_bf16", 32, 32, 8, 1024, 1024, 1000, 16, True, None, "bfloat16"),
    ("sq4032_bf16", 32, 32, 32, 4032, 4032, 4032, 128, True, None, "bfloat16"),
)
FA_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def _fa_inputs(dev, g, BH, Hkv_rows, Sq, Skv, skv, D, dtype):
    """Unit-normal q, k, v in the kernel's padded layout; keys past ``skv``
    are zero, as the wrapper's padding leaves them."""
    import torch

    q = torch.randn((BH, Sq, D), generator=g, device=dev)
    k = torch.randn((Hkv_rows, Skv, D), generator=g, device=dev)
    v = torch.randn((Hkv_rows, Skv, D), generator=g, device=dev)
    k[:, skv:] = 0
    v[:, skv:] = 0
    dt = getattr(torch, dtype)
    return q.to(dt), k.to(dt), v.to(dt)


def phase_flash_kernel(dev) -> tuple[float, dict]:
    """Kernel E against its plain version on the cases of ``FA_CASES``, each
    on the path its dtype picks (the wgmma counter moves for exactly the
    bfloat16 cases); returns the worst error and the prefill-shape timing
    row (CUDA events): kernel E on its wgmma path, the FMA kernel that ran
    bfloat16 before it on the same inputs (``ms_before``), the plain version
    and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain
    from repro_torch.kernels.flash_attention.kernel import launch_flash_attention

    g = torch.Generator(device=dev).manual_seed(12)
    worst = {}
    row = None
    for name, BH, H, Hkv, Sq, Skv, skv, D, causal, window, dtype in FA_CASES:
        q, k, v = _fa_inputs(dev, g, BH, BH // H * Hkv, Sq, Skv, skv, D, dtype)
        kw = dict(n_q_heads=H, n_kv_heads=Hkv, scale=D ** -0.5, causal=causal, window=window,
                  skv_actual=skv)
        path = "wgmma" if dtype == "bfloat16" else "fma"
        before = flash_attention_kernel.wgmma_launches
        got = flash_attention_kernel(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if flash_attention_kernel.wgmma_launches != before + (path == "wgmma"):
            raise AssertionError(f"flash_attention {name}: the {path} path was not taken")
        err = max_abs_err(got, want)
        if not torch.isfinite(got).all() or err > FA_TOL[dtype]:
            raise AssertionError(f"flash_attention {name}: kernel != plain (max abs err {err}, "
                                 f"tolerance {FA_TOL[dtype]})")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        log(f"flash_attention {name:>22} ({path}): max abs err {err:.3e} "
            f"(tolerance {FA_TOL[dtype]})")
        if name == "prefill_bf16_causal":
            ms = time_ms(lambda: flash_attention_kernel(q, k, v, **kw), reps=20)
            out = torch.empty_like(q)
            ms_fma = time_ms(lambda: launch_flash_attention(
                q, k, v, out, n_q_heads=H, n_kv_heads=Hkv, scale=D ** -0.5, causal=True,
                window=None, skv=skv, path="fma"), reps=5, warmup=1)
            err_fma = max_abs_err(out, want)
            plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), reps=3, warmup=1)
            q4, k4, v4 = (t.view(1, BH, Sq, D) for t in (q, k, v))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                              reps=20)
            # this run's data: every query sees the keys at or before it
            pairs = BH * Sq * (Sq + 1) // 2
            t_bound, by = bound(4 * q.numel() * q.element_size(), 4 * D * pairs, BF16_OPS_PER_S)
            row = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention/kernel.py:88", launches=0,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                       library_ms=sdpa_ms, path="wgmma", ms_before=ms_fma,
                       max_abs_err_before=err_fma, shape=list(q.shape), dtype=dtype, causal=True)
            log(f"flash_attention prefill shape {list(q.shape)} bf16 causal: wgmma {ms:.4f} ms "
                f"({4 * D * pairs / ms / 1e9:.1f} TFLOP/s), the FMA kernel {ms_fma:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound {t_bound:.4f} ms ({by})")
            del out
        del q, k, v, got, want
    row["max_abs_err_by_dtype"] = worst
    return max(worst.values()), row


def _profile_device_ms(fn) -> tuple[float, list[tuple[str, float]], float]:
    """Device milliseconds of one call of ``fn`` under ``torch.profiler``:
    the total over kernels, the rows by kernel name, largest first, and the
    host clock's milliseconds of the same call (to its last kernel's end)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])
    return sum(ms for _, ms in rows), rows, wall


def phase_prefill(dev, arch: str = "yi-6b", kernel: str = "E", seed: int = 13
                  ) -> tuple[int, dict]:
    """``arch`` at full width and depth (bfloat16, random weights from a
    seeded generator) through ``build_prefill`` on one sequence of 4096
    seeded tokens: a warm-up run, a timed run whose launches of ``kernel``
    (E: flash attention, F: the SSD scan) are counted (one per layer), a
    profiled run (the kernel's share of the device time), and the same
    prefill with ``use_kernel=False`` (the plain versions).  For E every
    row's cosine similarity must be at least 0.999.  For F the bfloat16
    comparison is reported, not gated: 64 random SSM layers amplify bfloat16
    rounding (two plain runs that differ only in the scan's chunk differ as
    much, also reported); :func:`_ssm_checks` gates F instead."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.models.model import model_dtype

    wrapper, kernel_name = {"E": (flash_attention_kernel, "flash_attention"),
                            "F": (ssd_scan_kernel, "ssd_scan")}[kernel]
    cfg = get_arch(arch)
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
    log(f"prefill: {cfg.name} params {n_params} ({n_params * 2 / 1e9:.2f} GB bf16) initialised "
        f"on the card in {time.perf_counter() - t0:.1f}s")
    prefill = build_prefill(cfg, shape, device=dev)
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS)))
    prefill(params, tokens)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hidden = prefill(params, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = wrapper.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"{cfg.name} prefill launched kernel {kernel} {launches} times, "
                             f"not {cfg.n_layers}")
    if wrapper.wgmma_launches != launches:
        raise AssertionError(f"{cfg.name} prefill: {wrapper.wgmma_launches} of kernel "
                             f"{kernel}'s {launches} launches took the wgmma path")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError(f"prefill hidden states {tuple(hidden.shape)} not finite or "
                             f"not (1, {PREFILL_TOKENS}, {cfg.d_model})")
    on_wgmma = f" ({wrapper.wgmma_launches} on wgmma)"
    busy, rows, prof_wall = _profile_device_ms(lambda: prefill(params, tokens))
    k_ms = sum(t for name, t in rows if kernel_name in name)
    # device time and wall of the one profiled run, unclamped: a device time
    # above the wall (kernels on overlapping streams) shows as a negative
    # share and is named in the log
    idle = 1 - busy / prof_wall
    overlap = " (device time exceeds the wall)" if busy > prof_wall else ""
    plain = prefill(params, tokens, use_kernel=False)
    torch.cuda.synchronize()
    cos = F.cosine_similarity(hidden[0].float(), plain[0].float(), dim=-1)
    err = max_abs_err(hidden, plain)
    log(f"prefill: {cfg.name} {ms:.3f} ms for {PREFILL_TOKENS} tokens "
        f"({PREFILL_TOKENS / ms * 1e3:.1f} tok/s), kernel {kernel} launched {launches} times"
        f"{on_wgmma}; "
        f"profiled device time {busy:.3f} ms, kernel {kernel} {k_ms:.3f} ms ({k_ms / busy:.1%}); "
        f"profiled wall {prof_wall:.3f} ms, device idle {idle:.1%} of it{overlap}")
    for name, t in rows[:8]:
        log(f"prefill profile: {t:9.3f} ms  {name[:90]}")
    log(f"prefill vs use_kernel=False: min row cosine {float(cos.min()):.6f}, max abs diff {err:.4g}")
    res = dict(ms=ms, tok_per_s=PREFILL_TOKENS / ms * 1e3, device_ms=busy, kernel_ms=k_ms,
               kernel_share=k_ms / busy, profiled_wall_ms=prof_wall,
               device_idle_share=idle, min_cos=float(cos.min()),
               max_abs_diff=err, params=n_params)
    if kernel == "E" and float(cos.min()) < 0.999:
        raise AssertionError(f"prefill hidden states disagree with the plain run: min row cosine "
                             f"{float(cos.min())}")
    if kernel == "F":
        del plain
        res.update(_ssm_checks(dev, cfg, params, tokens, prefill, hidden, seed))
    res["decode"] = _decode_profile(cfg, params)
    return launches, res


def _row_cos(a, b):
    """Each row's cosine similarity of two (1, S, D) tensors, in float32."""
    import torch.nn.functional as F

    return F.cosine_similarity(a[0].float(), b[0].float(), dim=-1)


def _ssm_checks(dev, cfg, params, tokens, prefill, hidden, seed) -> dict:
    """What gates kernel F on the mamba2 prefill path:

    * layer by layer at full depth in bfloat16: each block's update (its
      output less its input) from the kernel run's own input, with F and
      with the plain scan; every row's cosine at least 0.999 in every
      layer;
    * end to end in float32 (the same seeded weights, drawn in float32),
      F against the plain scan: every row's cosine at least 0.999, each of
      its launches (one a layer, counted from 0) on the FMA kernel.

    Reported beside them: the bfloat16 prefill with the plain scan at chunk
    64 against chunk 128, the rounding noise of two right answers."""
    from unittest import mock

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import init_lm
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import embed_tokens_sp
    from repro_torch.models.transformer import _layer, apply_block

    ctx = make_ctx()
    x = embed_tokens_sp(params, tokens.to(dev), cfg, ctx)
    worst_layer = (1.0, -1)
    for i in range(cfg.n_layers):
        p = _layer(params["stack"]["periods"][0], i)
        got = apply_block(p, "ssm", x, cfg, ctx, use_kernel=True)
        want = apply_block(p, "ssm", x, cfg, ctx, use_kernel=False)
        c = float(_row_cos(got - x, want - x).min())
        worst_layer = min(worst_layer, (c, i))
        x = got
    torch.cuda.synchronize()
    log(f"prefill per layer (bf16, F vs plain on each layer's own input): min row cosine "
        f"{worst_layer[0]:.6f} (layer {worst_layer[1]})")
    if worst_layer[0] < 0.999:
        raise AssertionError(f"layer {worst_layer[1]}: F's block update disagrees with the plain "
                             f"scan's, min row cosine {worst_layer[0]}")
    del x, got, want

    plain128 = prefill(params, tokens, use_kernel=False)
    with mock.patch.object(ssm_mod, "SSD_CHUNK", 64):
        plain64 = prefill(params, tokens, use_kernel=False)
    torch.cuda.synchronize()
    noise = float(_row_cos(plain64, plain128).min())
    log(f"prefill noise (bf16, plain scan chunk 64 vs chunk 128): min row cosine {noise:.6f}; "
        f"F vs plain: {float(_row_cos(hidden, plain128).min()):.6f}")
    del plain128, plain64

    cfg32 = cfg.scaled(dtype="float32")
    params32 = init_lm(cfg32, torch.Generator(device=dev).manual_seed(seed), dev,
                       dtype=torch.float32)
    prefill32 = build_prefill(cfg32, ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill"),
                              device=dev)
    reset_counts()
    got32 = prefill32(params32, tokens)
    torch.cuda.synchronize()
    launches32, wgmma32 = ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches
    if launches32 != cfg.n_layers or wgmma32:
        raise AssertionError(f"float32 prefill: kernel F launched {launches32} times, "
                             f"{wgmma32} on wgmma; want {cfg.n_layers}, all on the FMA kernel")
    want32 = prefill32(params32, tokens, use_kernel=False)
    torch.cuda.synchronize()
    cos32 = float(_row_cos(got32, want32).min())
    err32 = max_abs_err(got32, want32)
    log(f"prefill float32 end to end, F vs plain: min row cosine {cos32:.8f}, max abs diff "
        f"{err32:.4g}; kernel F launched {launches32} times, all on the FMA kernel")
    if not torch.isfinite(got32).all() or cos32 < 0.999:
        raise AssertionError(f"float32 prefill with F disagrees with the plain scan: min row "
                             f"cosine {cos32}")
    return dict(min_cos_per_layer=worst_layer[0], bf16_noise_min_cos=noise, f32_min_cos=cos32,
                f32_max_abs_diff=err32, f32_fma_launches=launches32)


def _decode_profile(cfg, params, n_ticks: int = 8) -> dict:
    """Where a decode step's time goes: the continuous engine's tick with
    the serving phase's 4 slots and 256 positions, on these params; wall ms
    per tick (host clock, no profiler) against device-busy ms per tick
    (``torch.profiler``)."""
    import torch

    from repro_torch.serving import ContinuousEngine, Request

    eng = ContinuousEngine(cfg, params, batch_slots=4, capacity=256)
    for uid in range(4):
        eng.submit(Request(uid=uid, prompt=[1 + uid, 2, 3], max_new=10 * n_ticks))
    for _ in range(4):
        eng.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        eng.tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_ticks
    busy, rows, _ = _profile_device_ms(lambda: [eng.tick() for _ in range(n_ticks)])
    busy /= n_ticks
    log(f"decode tick (4 slots, 256 positions): wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall):.1%})")
    for name, t in rows[:6]:
        log(f"decode profile: {t / n_ticks:8.3f} ms/tick  {name[:90]}")
    return dict(wall_ms=wall, device_ms=busy)


#: the serving phases: full width, random weights, both engines
SERVE_ARGS = ["--requests", "8", "--max-new", "16", "--slots", "4", "--capacity", "256"]


def phase_serving(arch: str = "yi-6b") -> dict:
    """``launch.serve --arch arch`` with the wave engine, then the
    continuous engine: every request's tokens equal across the two."""
    import torch

    from repro_torch.launch import serve as launch_serve

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("wave", "continuous"):
            out = os.path.join(tmp, f"{engine}.json")
            rc = launch_serve.main(["--arch", arch, *SERVE_ARGS, "--engine", engine,
                                    "--json", out])
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            res = json.loads(Path(out).read_text())
            if rc != 0 or res["completed"] != res["requests"]:
                raise AssertionError(f"serve {engine}: rc={rc}, {res['completed']} of "
                                     f"{res['requests']} requests completed")
            results[engine] = res
            log(f"serve {arch} {engine}: {res['tokens']} tokens in {res['seconds']:.3f}s "
                f"({res['tok_per_s']:.1f} tok/s), {res['decode_steps']} decode steps "
                f"({res['ms_per_step']:.3f} ms/step)")
    if results["wave"]["out"] != results["continuous"]["out"]:
        raise AssertionError("the wave and continuous engines emitted different tokens: "
                             f"{results['wave']['out']} != {results['continuous']['out']}")
    log(f"serve {arch}: wave and continuous tokens equal for all {len(results['wave']['out'])} "
        f"requests")
    return results


# -- mamba2: the SSD scan (kernel F) ---------------------------------------------------

#: kernel F's cases: (name, BH, S, Dh, Dst, G, chunk, dtype, entry, path); B
#: and C have G rows shared by BH / G heads; ``entry`` goes through the
#: padding entry point ``ssd_scan`` (S need not be a multiple of the chunk);
#: ``path`` is the kernel the case must run (``ssd_path``'s pick)
SSD_CASES = (
    ("prefill_bf16_shared_bc", 80, 4096, 64, 128, 1, 128, "bfloat16", False, "wgmma"),
    ("prefill_f32_shared_bc", 80, 4096, 64, 128, 1, 128, "float32", False, "fma"),
    ("broadcast_layout_f32", 32, 2048, 64, 128, 32, 128, "float32", False, "fma"),
    ("chunk64_f32", 16, 1024, 64, 128, 16, 64, "float32", False, "fma"),
    ("one_chunk_bf16", 8, 128, 64, 128, 1, 128, "bfloat16", False, "wgmma"),
    ("s640_five_chunks_bf16", 16, 640, 64, 128, 2, 128, "bfloat16", False, "wgmma"),
    ("ragged_s1000_bf16", 16, 1000, 64, 128, 2, 128, "bfloat16", True, "wgmma"),
    ("small_vs_sequential_f32", 4, 256, 16, 8, 4, 64, "float32", True, "fma"),
)
SSD_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
#: the wgmma path against the plain version, both bfloat16: the mean over
#: rows of |y - y_plain| / |y_plain|.  Kept float32 sums round y as the
#: plain version does; scores rounded once to bf16 move ~a third of the
#: elements by an ulp (``tests/test_torch_ssd.py``, ``ROUNDING_LIMIT``)
SSD_ROUNDING_LIMIT = 1e-3
#: against the sequential recurrence, which sums in another order (the
#: reference's own kernel test holds its Pallas scan to 2e-4)
SSD_SEQ_TOL = 2e-4


def _ssd_inputs(dev, g, BH, S, Dh, Dst, G, dtype):
    """x, B, C ``0.5 randn``, dt uniform in [0.05, 0.55), A ``-exp(0.3
    randn)`` (the reference's test distributions), in ``dtype``."""
    import torch

    x = torch.randn((BH, S, Dh), generator=g, device=dev) * 0.5
    dt = torch.rand((BH, S), generator=g, device=dev) * 0.5 + 0.05
    B = torch.randn((G, S, Dst), generator=g, device=dev) * 0.5
    C = torch.randn((G, S, Dst), generator=g, device=dev) * 0.5
    A = -torch.exp(torch.randn((BH, 1), generator=g, device=dev) * 0.3)
    dt_ = getattr(torch, dtype)
    return [t.to(dt_) for t in (x, dt, B, C, A)]


def _ssd_bound(x, dt, B, C, A, chunk: int) -> tuple[float, str]:
    """The least time for one scan: each input read once and the output
    written once, against the causal products of the chunked form (the
    lower triangle of C B^T and of scores . xd, C . h_in and the state
    update) at the card's peak for the inputs' type (the bf16 tensor cores,
    or float32 outside them)."""
    import torch

    BH, S, Dh = x.shape
    Dst = B.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, B, C, A)) \
        + x.numel() * x.element_size()
    L = chunk
    flop_per_chunk = 2 * (L * (L + 1) // 2 * (Dst + Dh) + 2 * L * Dst * Dh)
    rate = BF16_OPS_PER_S if x.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound(nbytes, flop_per_chunk * BH * (S // L), rate)


def phase_ssd_kernel(dev) -> tuple[float, dict]:
    """Kernel F against its plain version on the cases of ``SSD_CASES``, each
    on the path it names (the counters move for exactly that path; the
    wgmma cases also within ``SSD_ROUNDING_LIMIT``); returns the worst
    relative error and the prefill-shape timing rows by path (CUDA events;
    no single PyTorch call computes an SSD scan): the wgmma path in
    bfloat16, beside the FMA kernel on the same inputs (``ms_before``), and
    the FMA kernel in float32, each on the kernel's layout, beside the
    wrapper (its dtype conversions included) and the plain version."""
    import torch

    from repro_torch.kernels.ssd import ssd_ref, ssd_scan, ssd_scan_kernel, ssd_scan_plain
    from repro_torch.kernels.ssd.kernel import launch_ssd_scan

    g = torch.Generator(device=dev).manual_seed(15)
    worst, rows, rounding = {}, {}, 0.0
    for name, BH, S, Dh, Dst, G, chunk, dtype, entry, path in SSD_CASES:
        x, dt, B, C, A = _ssd_inputs(dev, g, BH, S, Dh, Dst, G, dtype)
        before, before_w = ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches
        if entry:
            got = ssd_scan(x, dt, B, C, A, chunk=chunk)
            want = ssd_scan(x, dt, B, C, A, chunk=chunk, use_kernel=False)
        else:
            got = ssd_scan_kernel(x, dt, B, C, A, chunk=chunk)
            want = ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
        torch.cuda.synchronize()
        if ssd_scan_kernel.launches != before + 1 \
                or ssd_scan_kernel.wgmma_launches != before_w + (path == "wgmma"):
            raise AssertionError(f"ssd_scan {name}: kernel F did not launch once on its "
                                 f"{path} path")
        mag = float(want.abs().max())
        err = max_abs_err(got, want)
        if tuple(got.shape) != (BH, S, Dh) or not torch.isfinite(got).all() \
                or err > SSD_TOL[dtype] * mag:
            raise AssertionError(f"ssd_scan {name} ({path}): kernel != plain (max abs err "
                                 f"{err}, tolerance {SSD_TOL[dtype]} x {mag})")
        worst[dtype] = max(worst.get(dtype, 0.0), err / mag)
        msg = ""
        if path == "wgmma":
            reading = _mean_row_rel_err(got, want)
            if reading > SSD_ROUNDING_LIMIT:
                raise AssertionError(f"ssd_scan {name} (wgmma): mean row relative error "
                                     f"{reading} against the plain version > "
                                     f"{SSD_ROUNDING_LIMIT}")
            rounding = max(rounding, reading)
            msg = f"; mean row relative error {reading:.3e} (limit {SSD_ROUNDING_LIMIT})"
        log(f"ssd_scan {name:>24} ({path}): max abs err {err:.3e} of {mag:.3g} (tolerance "
            f"{SSD_TOL[dtype]} of it){msg}")
        if name.startswith("small_vs_sequential"):
            seq = ssd_ref(x, dt, B, C, A)
            torch.cuda.synchronize()
            err_seq = max_abs_err(got, seq)
            if err_seq > SSD_SEQ_TOL * float(seq.abs().max()):
                raise AssertionError(f"ssd_scan {name}: kernel != ssd_ref (max abs err {err_seq})")
            log(f"ssd_scan {name:>24}: against the sequential ssd_ref, max abs err {err_seq:.3e}")
        if name.startswith("prefill"):
            # the kernels on their layout (dt and A in float32, as the wrapper
            # hands them over); the wrapper's own time, conversions included,
            # beside them
            dt32, A32, out = dt.float(), A.float().reshape(-1), torch.empty_like(x)

            def run(path_):
                return launch_ssd_scan(x, dt32, B, C, A32, out, chunk=chunk, path=path_)

            ms = time_ms(lambda: run(path), reps=20)
            wrapper_ms = time_ms(lambda: ssd_scan_kernel(x, dt, B, C, A, chunk=chunk), reps=20)
            plain_ms = time_ms(lambda: ssd_scan_plain(x, dt, B, C, A, chunk=chunk), reps=3,
                               warmup=1)
            t_bound, by = _ssd_bound(x, dt, B, C, A, chunk)
            row = dict(name="ssd_scan", route="cuda", path=path,
                       source="src/repro_torch/csrc/ssd.cu",
                       replaces="src/repro/kernels/ssd/kernel.py:80", launches=0,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                       library_ms=None, wrapper_ms=wrapper_ms, shape=list(x.shape), state=Dst,
                       bc_rows=G, chunk=chunk, dtype=dtype)
            before_msg = ""
            if path == "wgmma":  # the FMA kernel on the same bfloat16 inputs
                ms_fma = time_ms(lambda: run("fma"), reps=5, warmup=1)
                err_fma = max_abs_err(out, want)
                row.update(ms_before=ms_fma, max_abs_err_before=err_fma)
                before_msg = f", the FMA kernel {ms_fma:.4f} ms"
            del out
            rows[path] = row
            log(f"ssd_scan prefill shape {list(x.shape)} state {Dst} {dtype} ({path}): kernel "
                f"{ms:.4f} ms{before_msg}, the wrapper {wrapper_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {t_bound:.4f} ms ({by})")
        del x, dt, B, C, A, got, want
    # the scores' precision at the prefill shape on a mamba2-2.7b layer's dt
    # range, uniform in [0.01, 3.7), with A = -1
    x, _, B, C, A = _ssd_inputs(dev, g, 80, 4096, 64, 128, 1, "bfloat16")
    dt = (0.01 + torch.rand((80, 4096), generator=g, device=dev) * 3.69).to(torch.bfloat16)
    A = -torch.ones_like(A)
    got = ssd_scan_kernel(x, dt, B, C, A)
    layer_reading = _mean_row_rel_err(got, ssd_scan_plain(x, dt, B, C, A))
    log(f"ssd_scan prefill shape, a layer's dt range (wgmma): mean row relative error "
        f"{layer_reading:.3e} (limit {SSD_ROUNDING_LIMIT})")
    if layer_reading > SSD_ROUNDING_LIMIT:
        raise AssertionError(f"ssd_scan on a layer's dt range (wgmma): mean row relative error "
                             f"{layer_reading} > {SSD_ROUNDING_LIMIT}")
    for row in rows.values():
        row["max_rel_err_by_dtype"] = worst
    rows["wgmma"].update(max_mean_row_rel_err=rounding, mean_row_rel_err_layer_dt=layer_reading)
    return max(worst.values()), rows


def _mean_row_rel_err(got, want) -> float:
    """The mean over rows of |got - want| / |want| (the last dim a row)."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).mean())


# -- tensor parallelism: the per-chunk GEMM (kernel D) and the TP prefill ---------------

#: kernel D's cases: (name, x shape, w shape, dtype, strided, path); the first
#: four are the yi-6b TP prefill's ring steps at P = 8 (512 rows a rank): Q,
#: MLP-up (ragged N = 1376), MLP-down (ragged K = 1376) and the
#: out-projection; ``strided`` hands D views (every other rank row of a
#: buffer, a transposed weight); ``path`` is the kernel ``matmul_path`` picks
#: (bfloat16 with K and N multiples of 8 on wgmma, the rest on mma.sync)
MM_CASES = (
    ("mlp_up_bf16", (8, 512, 4096), (8, 4096, 1376), "bfloat16", False, "wgmma"),
    ("q_bf16", (8, 512, 4096), (8, 4096, 512), "bfloat16", False, "wgmma"),
    ("mlp_down_bf16", (8, 512, 1376), (8, 1376, 4096), "bfloat16", False, "wgmma"),
    ("out_bf16", (8, 512, 512), (8, 512, 4096), "bfloat16", False, "wgmma"),
    ("mlp_up_f32", (8, 512, 4096), (8, 4096, 1376), "float32", False, "mma_sync"),
    ("ragged_2d_f32", (100, 70), (70, 50), "float32", False, "mma_sync"),
    ("ragged_2d_bf16", (1000, 130), (130, 333), "bfloat16", False, "mma_sync"),
    ("odd_k_bf16", (3, 65, 131), (3, 131, 33), "bfloat16", False, "mma_sync"),
    ("strided_batch_bf16", (8, 512, 1024), (8, 1024, 1376), "bfloat16", True, "wgmma"),
    ("shared_w_bf16", (8, 512, 1024), (1024, 1376), "bfloat16", False, "wgmma"),
)
MM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the TP prefill's tensor-parallel degree: the paper's 8-rank testbed
TP = 8


def _mm_bound(x, w, out) -> tuple[float, str]:
    """The least time for one product: each operand read once and the
    output written once, against 2 M N K operations per batch entry on the
    bf16 tensor cores (or float32 outside them)."""
    Bt = x.shape[0] if x.dim() == 3 else 1
    ops = 2 * Bt * x.shape[-2] * x.shape[-1] * w.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out))
    return bound(nbytes, ops, F32_OPS_PER_S if x.element_size() == 4 else BF16_OPS_PER_S)


def phase_matmul_kernel(dev) -> tuple[float, dict]:
    """Kernel D against its plain version on the cases of ``MM_CASES``, each
    on its path (the wgmma counter moves for exactly the wgmma cases);
    returns the worst relative error and the MLP-up timing row (CUDA
    events): D on its wgmma path, the mma.sync kernel that ran it before on
    the same operands (``ms_before``), the plain version and
    ``torch.matmul``; beside it every ring-step shape's time on both paths
    and on the wgmma path's two grids (persistent, one CTA a tile)."""
    import torch

    from repro_torch.kernels.matmul import matmul, matmul_ref
    from repro_torch.kernels.matmul.kernel import launch_matmul

    g = torch.Generator(device=dev).manual_seed(18)
    worst, row, shapes_ms = {}, None, {}
    for name, xs, ws, dtype, strided, path in MM_CASES:
        dt = getattr(torch, dtype)
        if strided:
            x = torch.randn((2 * xs[0],) + xs[1:], generator=g, device=dev).to(dt)[::2]
            w = torch.randn(ws[:1] + ws[:0:-1], generator=g, device=dev).to(dt).transpose(1, 2)
        else:
            x = torch.randn(xs, generator=g, device=dev).to(dt)
            w = torch.randn(ws, generator=g, device=dev).to(dt)
        before, before_wg = matmul.launches, matmul.wgmma_launches
        got = matmul(x, w)
        want = matmul_ref(x, w)
        torch.cuda.synchronize()
        if matmul.launches != before + 1 or \
                matmul.wgmma_launches != before_wg + (path == "wgmma"):
            raise AssertionError(f"matmul {name}: kernel D's {path} path was not launched")
        mag = float(want.abs().max())
        err = max_abs_err(got, want)
        if got.shape != want.shape or got.dtype != dt or not torch.isfinite(got).all() \
                or err > MM_TOL[dtype] * mag:
            raise AssertionError(f"matmul {name}: kernel != plain (max abs err {err}, "
                                 f"tolerance {MM_TOL[dtype]} x {mag})")
        worst[dtype] = max(worst.get(dtype, 0.0), err / mag)
        log(f"matmul {name:>20} ({path}): max abs err {err:.3e} of {mag:.4g} (tolerance "
            f"{MM_TOL[dtype]} of it)")
        if name in ("mlp_up_bf16", "q_bf16", "mlp_down_bf16", "out_bf16"):
            out = torch.empty_like(got)
            flops = 2 * x.numel() * w.shape[-1]
            variant_ms = {k: time_ms(lambda: launch_matmul(x, w, out, persistent=p), reps=20)
                          for k, p in (("persistent", True), ("per_tile", False))}
            ms = time_ms(lambda: matmul(x, w), reps=20)
            ms_mma = time_ms(lambda: launch_matmul(x, w, out, path="mma_sync"), reps=20)
            lib_ms = time_ms(lambda: torch.matmul(x, w), reps=20)
            t_bound, by = _mm_bound(x, w, got)
            shapes_ms[name] = dict(ms=ms, ms_mma_sync=ms_mma, library_ms=lib_ms,
                                   bound_ms=t_bound, tflops=flops / ms / 1e9,
                                   wgmma_grid_ms=variant_ms)
            log(f"matmul {name} {list(x.shape)} @ {list(w.shape)} bf16: wgmma {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), mma.sync {ms_mma:.4f} ms, torch.matmul "
                f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x its time), bound {t_bound:.4f} ms ({by}); "
                f"wgmma grids: " + ", ".join(f"{k} {v:.4f}" for k, v in variant_ms.items()))
            if name == "mlp_up_bf16":
                plain_ms = time_ms(lambda: matmul_ref(x, w), reps=5, warmup=1)
                row = dict(name="matmul", route="cuda", source="src/repro_torch/csrc/matmul.cu",
                           replaces="src/repro/kernels/matmul/kernel.py:38", launches=0,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
                           bound_by=by, library_ms=lib_ms, path="wgmma", ms_before=ms_mma,
                           shape=[list(x.shape), list(w.shape)], dtype=dtype)
                log(f"matmul MLP-up plain version: {plain_ms:.4f} ms")
            del out
        del x, w, got, want
    row["max_rel_err_by_dtype"] = worst
    row["ring_step_shapes"] = shapes_ms
    row["host_us_per_call"] = _host_us_per_call(dev)
    return max(worst.values()), row


def _host_us_per_call(dev, n: int = 2000) -> dict:
    """Host microseconds a call of kernel D's entry point and of
    ``torch.matmul`` cost, on a product small enough that the device waits
    for the host (host clock over ``n`` calls ending in a synchronize): what
    each of the TP prefill's 1,280 launches costs the host."""
    import torch

    from repro_torch.kernels.matmul import matmul

    x = torch.ones((1, 128, 64), device=dev, dtype=torch.bfloat16)
    w = torch.ones((1, 64, 128), device=dev, dtype=torch.bfloat16)
    res = {}
    for name, fn in (("matmul", lambda: matmul(x, w)),
                     ("torch.matmul", lambda: torch.matmul(x, w))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / n * 1e6
    log("host us per call at (1, 128, 64) @ (1, 64, 128) bf16: " +
        ", ".join(f"{k} {v:.2f}" for k, v in res.items()))
    return res


def _tp_closed_form(cfg, P: int, tokens: int) -> dict:
    """Per tag, one rank's (steps, bytes) over one TP prefill of ``tokens``
    tokens: every streamed call moves P - 1 ring steps of one rank's rows
    (tokens / P) of the model width in the model dtype.  Per layer: Q
    (tp.attn.qkv), the K/V gather (tp.attn.kv), the out-projection
    (tp.attn.out), gate and up (tp.mlp.up, two calls) and down
    (tp.mlp.down); the embedding's reduce-scatter (tp.embed) once.  E.g.
    tp.mlp.up = 2 x 7 x 512 x 4096 x 2 bytes a layer at P = 8."""
    step_bytes = (P - 1) * (tokens // P) * cfg.d_model * 2
    calls = {"tp.attn.qkv": 1, "tp.attn.kv": 1, "tp.attn.out": 1, "tp.mlp.up": 2,
             "tp.mlp.down": 1}
    want = {t: {"steps": (P - 1) * n * cfg.n_layers, "bytes": step_bytes * n * cfg.n_layers}
            for t, n in calls.items()}
    want["tp.embed"] = {"steps": P - 1, "bytes": step_bytes}
    return want


def _profile_split(rows) -> dict:
    """Device ms by kind: kernel D, kernel E, cuBLAS GEMMs, the ring's index
    copies and fills, and the elementwise rest."""
    kinds = {"D": ("matmul_bf16_kernel", "matmul_wgmma_kernel"), "E": ("flash_attention",),
             "gemm": ("gemm", "nvjet", "xmma", "cutlass", "cublas"),
             "copies": ("index", "copy", "Copy", "gather", "scatter", "fill", "cat")}
    split = {k: 0.0 for k in (*kinds, "elementwise")}
    for name, ms in rows:
        kind = next((k for k, keys in kinds.items() if any(s in name for s in keys)),
                    "elementwise")
        split[kind] += ms
    return split


def phase_tp_prefill(dev, seed: int = 19) -> tuple[int, dict, object]:
    """yi-6b at full width and depth, P = 8 ranks over ``smi:static``,
    kernel D injected; see the module docstring (phase 19).  Returns D's
    launches, the results and the rank-stacked params (for phase 20)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, init_lm, lm_prefill
    from repro_torch.models.model import model_dtype
    from repro_torch.parallel import ledger

    cfg = get_arch("yi-6b")
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    plain_step = build_prefill(cfg, shape, mesh=(1, TP), comm_mode="smi:static", device=dev)
    tp_params = shard_params(params, cfg, plain_step.ctx)
    torch.cuda.synchronize()
    log(f"tp prefill: {cfg.name} params drawn and split over {TP} ranks in "
        f"{time.perf_counter() - t0:.1f}s")
    ctx_d = make_ctx((1, TP), comm_mode="smi:static", matmul_fn=matmul, device=dev)

    def run_d():
        return gather_hidden(lm_prefill(tp_params, tokens, cfg, ctx_d,
                                        capacity=PREFILL_TOKENS))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    with ledger.capture() as led:
        run_d()  # warm-up, its wire traffic captured
    torch.cuda.synchronize()
    reset_counts()
    hidden, ms_d = timed(run_d)
    launches_d, launches_e = matmul.launches, flash_attention_kernel.launches
    wgmma_d, wgmma_e = matmul.wgmma_launches, flash_attention_kernel.wgmma_launches
    want_d = 5 * TP * cfg.n_layers
    if launches_d != want_d or launches_e != cfg.n_layers:
        raise AssertionError(f"TP prefill launched kernel D {launches_d} times (not {want_d}) "
                             f"and E {launches_e} times (not {cfg.n_layers})")
    if (wgmma_d, wgmma_e) != (launches_d, launches_e):
        raise AssertionError(f"TP prefill: {wgmma_d} of D's {launches_d} and {wgmma_e} of E's "
                             f"{launches_e} launches took the wgmma path")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError(f"TP prefill hidden states {tuple(hidden.shape)} not finite or "
                             f"not (1, {PREFILL_TOKENS}, {cfg.d_model})")
    want_led = _tp_closed_form(cfg, TP, PREFILL_TOKENS)
    if led.by_tag != want_led:
        raise AssertionError(f"TP prefill ledger {led.by_tag} != closed form {want_led}")
    log(f"tp prefill ledger per tag equals the closed form: {json.dumps(led.tag_bytes())}")

    plain_step(tp_params, tokens)
    h_none, ms_none = timed(lambda: plain_step(tp_params, tokens))
    tp1 = build_prefill(cfg, shape, device=dev)
    tp1(params, tokens)
    h_tp1, ms_tp1 = timed(lambda: tp1(params, tokens))
    cos_none = float(_row_cos(hidden, h_none).min())
    cos_tp1 = float(_row_cos(hidden, h_tp1).min())
    cos_none_tp1 = float(_row_cos(h_none, h_tp1).min())
    log(f"tp prefill: D injected {ms_d:.3f} ms ({PREFILL_TOKENS / ms_d * 1e3:.1f} tok/s), "
        f"matmul_fn=None {ms_none:.3f} ms ({PREFILL_TOKENS / ms_none * 1e3:.1f} tok/s), "
        f"tp = 1 {ms_tp1:.3f} ms ({PREFILL_TOKENS / ms_tp1 * 1e3:.1f} tok/s); D launched "
        f"{launches_d} times ({wgmma_d} on wgmma), E {launches_e} ({wgmma_e} on wgmma)")
    log(f"tp prefill min row cosine: D vs matmul_fn=None {cos_none:.6f}, D vs tp = 1 "
        f"{cos_tp1:.6f} (matmul_fn=None vs tp = 1 {cos_none_tp1:.6f})")
    if min(cos_none, cos_tp1) < 0.999:
        raise AssertionError(f"TP prefill with D disagrees: min row cosine {cos_none} against "
                             f"matmul_fn=None, {cos_tp1} against tp = 1")
    del h_none, h_tp1, params, tp1
    torch.cuda.empty_cache()
    busy, rows, _ = _profile_device_ms(run_d)
    split = _profile_split(rows)
    log(f"tp prefill profiled device time {busy:.3f} ms: " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in split.items()))
    for name, t in rows[:12]:
        log(f"tp prefill profile: {t:9.3f} ms  {name[:90]}")
    res = dict(ms_d=ms_d, tok_per_s_d=PREFILL_TOKENS / ms_d * 1e3, ms_matmul_fn_none=ms_none,
               tok_per_s_matmul_fn_none=PREFILL_TOKENS / ms_none * 1e3, ms_tp1=ms_tp1,
               tok_per_s_tp1=PREFILL_TOKENS / ms_tp1 * 1e3, launches_d=launches_d,
               launches_e=launches_e, wgmma_launches_d=wgmma_d, wgmma_launches_e=wgmma_e,
               min_cos_vs_none=cos_none, min_cos_vs_tp1=cos_tp1,
               device_ms=busy, device_split_ms=split, ledger_bytes=led.tag_bytes())
    return launches_d, res, tp_params


def phase_tp_fused(dev, tp_params, n_layers: int = 4, seed: int = 20) -> dict:
    """Phase 19's prefill cut to ``n_layers`` layers over ``smi:fused``
    against ``smi:static``, both with D: bit for bit; kernel A's gather-fused
    form launched once per reduce-scatter ring step (the ledger's closed
    form), its plain add never.  Returns A's launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.matmul import matmul
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, lm_prefill
    from repro_torch.models.common import tree_map
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    cfg = get_arch("yi-6b").scaled(n_layers=n_layers)
    params = dict(tp_params, stack={"periods": tree_map(lambda t: t[:n_layers],
                                                        tp_params["stack"]["periods"]),
                                    "rem": tp_params["stack"]["rem"]})
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    out = {}
    for mode in ("smi:static", "smi:fused"):
        ctx = make_ctx((1, TP), comm_mode=mode, matmul_fn=matmul, device=dev)
        reset_counts()
        out[mode] = gather_hidden(lm_prefill(params, tokens, cfg, ctx, capacity=PREFILL_TOKENS))
        torch.cuda.synchronize()
        out[mode + ":A"] = (fused_shift_accumulate.launches, fused_accumulate.launches)
    if not same_bits(out["smi:fused"], out["smi:static"]):
        raise AssertionError(f"TP prefill over smi:fused differs from smi:static (max abs diff "
                             f"{max_abs_err(out['smi:fused'], out['smi:static'])})")
    # the reduce-scatters: the out-projection and MLP-down of every layer and
    # the embedding's, each P - 1 ring steps
    closed = _tp_closed_form(cfg, TP, PREFILL_TOKENS)
    ring_steps = sum(closed[t]["steps"] for t in ("tp.attn.out", "tp.mlp.down", "tp.embed"))
    shifts, folds = out["smi:fused:A"]
    if (shifts, folds) != (ring_steps, 0) or out["smi:static:A"] != (0, 0):
        raise AssertionError(f"kernel A launched {shifts} times gather-fused (not {ring_steps}) "
                             f"and {folds} as the plain add over smi:fused, "
                             f"{out['smi:static:A']} over smi:static")
    log(f"tp prefill {n_layers} layers: smi:fused bit-equal to smi:static, kernel A launched "
        f"{shifts} times gather-fused, once per reduce-scatter ring step")
    return {"shift": shifts, "fold": folds}


# -- slice 6: channels and the int8 wire (phases 21-24) ---------------------------------

#: the bandwidth phase's sizes per rank (KiB): the reference's three and 64 MiB,
#: where the 8 ranks hold 512 MiB, ten times the 50 MB L2
CHANNEL_BW_KIB = (16, 256, 4096, 65536)
#: GESUMMV: the sizes checked against the single-rank result, and the timed one
GESUMMV_CHECK_N = (1024, 2048)
GESUMMV_N = 16384
#: the compressed all-reduce held against the CPU on the same inputs, per rank
COMPRESSED_ELEMS = 1 << 20
POOL_TRANSFERS = 1000


def phase_channel_latency(dev) -> tuple[list[dict], dict]:
    """Phase 21 (paper Tab. 3): ``launch.channels.latency`` on an 8-rank bus
    at 1, 4 and 7 hops over static, fused and packet: a transfer of 8
    float32 at n_chunks=1 (checked) and a push/pop loop of 64 elements whose
    first element must arrive on the hops-th pop and whose destination must
    pop 64; µs per transfer and per pop.  Kernel C launches once per packet
    pop and transfer."""
    from repro_torch.kernels.router import router_run
    from repro_torch.launch.channels import _line, latency

    reset_counts()
    rows = latency(dev, count=64, reps=20)
    launches = {"C": router_run.launches, "C_warp": router_run.warp_launches}
    if launches["C"] == 0:
        raise AssertionError("the channel latency phase never launched kernel C")
    for row in rows:
        log(_line(row))
    log(f"channel latency: kernel C launched {launches['C']} times "
        f"({launches['C_warp']} on the warp path)")
    return rows, launches


def phase_channel_bandwidth(dev) -> tuple[list[dict], dict]:
    """Phase 22 (paper Fig. 9): ``launch.channels.bandwidth`` on the same bus
    at 16 KiB, 256 KiB, 4 MiB and 64 MiB per rank, 1, 4 and 7 hops,
    n_chunks=16, over static, fused, packet (to 4 MiB) and compressed:static
    beside the unpipelined ``staged_p2p``; every delivery checked; GB/s."""
    from repro_torch.kernels.router import router_run
    from repro_torch.launch.channels import _line, bandwidth

    reset_counts()
    rows = bandwidth(dev, sizes_kib=CHANNEL_BW_KIB, reps=5)
    launches = {"C": router_run.launches, "C_warp": router_run.warp_launches}
    if launches["C"] == 0:
        raise AssertionError("the channel bandwidth phase never launched kernel C")
    for row in rows:
        log(_line(row))
    log(f"channel bandwidth: kernel C launched {launches['C']} times "
        f"({launches['C_warp']} on the warp path)")
    return rows, launches


def phase_gesummv(dev) -> dict:
    """Phase 23 (paper §5.4.1, Fig. 13): GESUMMV on one rank and over two
    stacked ranks whose partial GEMVs meet through a channel; equal within
    2e-4 at N = 1024 and 2048 (the reference's gate); at N = 16384 in float32
    (1 GiB a matrix) both timed by CUDA events and by device time (the
    channel's eager host work shows in the first), GB/s beside the memory
    rate.
    Both ranks read one card's memory: no 2x is expected or claimed."""
    import torch

    from repro_torch.apps import gesummv, gesummv_two_ranks
    from repro_torch.core import Communicator

    comm = Communicator.create("x", (2,), device=dev)
    g = torch.Generator(device=dev).manual_seed(23)
    res = {}
    for N in (*GESUMMV_CHECK_N, GESUMMV_N):
        AB = torch.randn((2, N, N), generator=g, device=dev)
        x = torch.randn(N, generator=g, device=dev)
        one = gesummv(AB[0], AB[1], x)
        two = gesummv_two_ranks(AB, x, comm)
        torch.cuda.synchronize()
        scale = max(float(one.abs().max()), 1.0)
        err = float((two[1] - one).abs().max())
        if not (torch.isfinite(two).all() and err <= 2e-4 * scale and not two[0].any()):
            raise AssertionError(f"gesummv N={N}: two ranks off the single rank by {err}")
        row = {"max_abs_err": err, "scale": scale}
        if N == GESUMMV_N:
            nbytes = 2 * N * N * 4
            for name, fn in (("single", lambda: gesummv(AB[0], AB[1], x)),
                             ("two_ranks", lambda: gesummv_two_ranks(AB, x, comm))):
                ms, dev_ms = time_ms(fn, reps=10), device_ms(fn, reps=10)
                row[name] = {"ms": ms, "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                             "device_ms": dev_ms, "device_gb_per_s": nbytes / (dev_ms * 1e-3) / 1e9}
            row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            for name, r in (("single rank", row["single"]),
                            ("two ranks over a channel", row["two_ranks"])):
                log(f"gesummv N={N} float32, {name}: {r['ms']:.4f} ms by CUDA events "
                    f"({r['gb_per_s']:.1f} GB/s), {r['device_ms']:.4f} ms of device time "
                    f"({r['device_gb_per_s']:.1f} GB/s); memory rate "
                    f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s, bound {row['bound_ms']:.4f} ms")
        else:
            log(f"gesummv N={N}: two ranks within {err:.3e} of the single rank (scale {scale:.1f})")
        res[N] = row
        del AB, x
    return res


def phase_collective_channels(dev) -> tuple[dict, dict]:
    """Phase 24: at 8 x 16 Mi float32 on ring(1x8) and torus(2x4), over
    smi:static and smi:fused, each of the five channel kinds' ``transfer``
    bit-equal to the direct collective; kernel A launched by the reduce
    channel's folds and the all-reduce's ring steps on smi:fused; the reduce
    and all-reduce channels timed beside the direct calls by device time in
    turns (direct, channel, channel, direct).  Then an all-reduce over
    compressed:static whose int8 wire and result are the CPU plain result's
    bits, and a ChannelPool spec serving 1,000 all-reduces on one claim."""
    import dataclasses

    import torch

    import repro_torch.channels as ch
    from repro_torch.core import Communicator
    from repro_torch.core import collectives as C
    from repro_torch.mesh.api import make_ctx
    from repro_torch.parallel import layers
    from repro_torch.transport.compressed import _pack_wire, _quantize_rows
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    xg = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    pairs = {
        "bcast": (lambda c, t: ch.open_bcast_channel(c, root=1, port=None,
                                                     transport=t).transfer(x),
                  lambda c, t: C._stream_bcast_impl(x, c, root=1, transport=t)),
        "reduce": (lambda c, t: ch.open_reduce_channel(c, root=3, port=None,
                                                       transport=t).transfer(x),
                   lambda c, t: C.reduce(x, c, root=3, transport=t)),
        "gather": (lambda c, t: ch.open_gather_channel(c, root=0, port=None,
                                                       transport=t).transfer(xg),
                   lambda c, t: C._stream_gather_impl(xg, c, root=0, transport=t)),
        "scatter": (lambda c, t: ch.open_scatter_channel(c, root=0, port=None,
                                                         transport=t).transfer(x),
                    lambda c, t: C._stream_scatter_impl(x, c, root=0, transport=t)),
        "allreduce": (lambda c, t: ch.open_allreduce_channel(c, port=None,
                                                             transport=t).transfer(x),
                      lambda c, t: C.allreduce(x, c, transport=t)),
    }
    reset_counts()
    res, launched = {"times": {}}, {"fold": 0, "shift": 0}
    for names, sizes in ((("x",), (8,)), (("x", "y"), DIMS)):
        comm = Communicator.create(names, sizes, device=dev)
        cname = "ring(1x8)" if len(sizes) == 1 else "torus(2x4)"
        for wire in ("static", "fused"):
            for kind, (chan, direct) in pairs.items():
                before = (fused_accumulate.launches, fused_shift_accumulate.launches)
                got = chan(comm, wire)
                after = (fused_accumulate.launches, fused_shift_accumulate.launches)
                want = direct(comm, wire)
                torch.cuda.synchronize()
                if not same_bits(got, want) or not torch.isfinite(got).all():
                    raise AssertionError(f"{kind} channel on {cname} over smi:{wire} differs "
                                         "from the direct call")
                launched["fold"] += after[0] - before[0]
                launched["shift"] += after[1] - before[1]
                del got, want
            log(f"collective channels on {cname} over smi:{wire}: all five bit-equal to the "
                f"direct calls")
        for kind in ("reduce", "allreduce"):
            chan, direct = pairs[kind]
            turns = {"direct": [], "channel": []}
            for who in ("direct", "channel", "channel", "direct"):
                fn = direct if who == "direct" else chan
                turns[who].append(device_ms(lambda: fn(comm, "fused"), reps=5, warmup=1))
            t = {k: sum(v) / len(v) for k, v in turns.items()}
            res["times"][f"{kind}/{cname}/fused"] = t | {"turns_ms": turns}
            log(f"{kind} on {cname} over smi:fused: channel {t['channel']:.4f} ms, direct "
                f"{t['direct']:.4f} ms of device time ({t['channel'] / t['direct'] - 1:+.2%})")
    counts = {"A_fold": fused_accumulate.launches, "A_shift": fused_shift_accumulate.launches}
    if launched["fold"] == 0 or launched["shift"] == 0:
        raise AssertionError(f"the collective channels launched kernel A {launched}")
    log(f"collective channels: kernel A launched {launched['fold']} times as the reduce "
        f"channels' plain add and {launched['shift']} times gather-fused by the all-reduce "
        f"channels (the checked transfers; {counts} with the timed ones)")
    del x, xg

    # the int8 wire: the card's codes, scales and all-reduce are the CPU's bits
    xc = torch.randn((P, COMPRESSED_ELEMS), generator=g, device=dev) * 10
    xh = xc.cpu()
    if not same_bits(_pack_wire(*_quantize_rows(xc, 256)).cpu(),
                     _pack_wire(*_quantize_rows(xh, 256))):
        raise AssertionError("the int8 wire's bits differ between the card and the CPU")
    card = ch.open_allreduce_channel(Communicator.create("x", (8,), device=dev), port=None,
                                     transport="compressed:static").transfer(xc)
    cpu = ch.open_allreduce_channel(Communicator.create("x", (8,), device="cpu"), port=None,
                                    transport="compressed:static").transfer(xh)
    if not same_bits(card.cpu(), cpu):
        raise AssertionError("the compressed all-reduce differs between the card and the CPU")
    err = float((card.double() - xc.double().sum(0)).abs().max())
    res["compressed"] = {"elems": COMPRESSED_ELEMS, "max_abs_err_vs_f32_sum": err}
    log(f"compressed:static all-reduce of 8 x {COMPRESSED_ELEMS} float32: the card's wire and "
        f"result equal the CPU's bit for bit; max abs err {err:.4f} against the exact sum")
    del xc, xh, card, cpu

    # the persistent pool: one claim serves every call
    ctx = make_ctx((1, P), comm_mode="smi:fused", device=dev)
    with ch.ChannelPool(ctx.model_comm) as pool:
        pctx = dataclasses.replace(ctx, channels=pool)
        xs = torch.randn((P, 4096), generator=g, device=dev)
        want = layers.all_reduce(xs, ctx)
        if not same_bits(layers.all_reduce(xs, pctx), want):
            raise AssertionError("an all-reduce through the pool differs")
        claims = [(r["port"], r["tag"], id(r["owner"])) for r in pool.claims()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(POOL_TRANSFERS):
            layers.all_reduce(xs, pctx)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) * 1e6 / POOL_TRANSFERS
        after = [(r["port"], r["tag"], id(r["owner"])) for r in pool.claims()]
        if after != claims or len(claims) != 1:
            raise AssertionError(f"the pool's claims moved: {claims} -> {after}")
    res["pool"] = {"transfers": POOL_TRANSFERS, "us_per_transfer": us, "claims": len(claims),
                   "port": claims[0][0], "tag": claims[0][1]}
    log(f"ChannelPool: {POOL_TRANSFERS} all-reduces of (8, 4096) float32 over smi:fused on one "
        f"claim (port {claims[0][0]}, {claims[0][1]}), {us:.1f} us each")
    return res, launched


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
    launches_a, reduce_times = phase_reductions(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows = phase_kernel_table(dev, launches_a, launches_b, err_a, err_b)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phases 1-6: {time.perf_counter() - t_start:.1f}s")

    t0 = time.perf_counter()
    _err_c, rows_c = phase_router_kernel(dev)
    torch.cuda.synchronize()
    log(f"phase 7 (kernel C vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_router_reroute(dev)
    torch.cuda.synchronize()
    log(f"phase 8 (re-route): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    injection = phase_injection(dev)
    torch.cuda.synchronize()
    log(f"phase 9 (injection): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_c, packet_stencil = phase_packet_stencil()
    torch.cuda.synchronize()
    log(f"phase 10 (packet stencil): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    packet_profile = phase_stencil_profile(dev, n_steps=4, comm_mode="smi:packet",
                                           schedules=(True,))
    torch.cuda.synchronize()
    log(f"phase 10 (packet stencil profile): {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_c_red = phase_packet_reductions(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 11 (packet reductions): {time.perf_counter() - t0:.1f}s")
    rows_c[0]["launches"] = launches_c
    rows_c[0]["launches_reductions"] = launches_c_red["warp"]
    rows_c[1]["launches"] = launches_c_red["thread"]
    rows.extend(rows_c)

    t0 = time.perf_counter()
    _err_e, row_e = phase_flash_kernel(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 12 (kernel E vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_e, prefill = phase_prefill(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 13 (yi-6b prefill): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serving = phase_serving()
    log(f"phase 14 (yi-6b serving): {time.perf_counter() - t0:.1f}s")
    row_e["launches"] = launches_e
    rows.append(row_e)

    t0 = time.perf_counter()
    _err_f, rows_f = phase_ssd_kernel(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 15 (kernel F vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_f, ssm_prefill = phase_prefill(dev, "mamba2-2.7b", "F", seed=16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 16 (mamba2-2.7b prefill): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ssm_serving = phase_serving("mamba2-2.7b")
    log(f"phase 17 (mamba2-2.7b serving): {time.perf_counter() - t0:.1f}s")
    rows_f["wgmma"]["launches"] = launches_f
    rows_f["fma"]["launches"] = ssm_prefill["f32_fma_launches"]
    rows.extend((rows_f["wgmma"], rows_f["fma"]))

    t0 = time.perf_counter()
    _err_d, row_d = phase_matmul_kernel(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 18 (kernel D vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_d, tp_prefill, tp_params = phase_tp_prefill(dev)
    torch.cuda.synchronize()
    log(f"phase 19 (yi-6b TP prefill, P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tp_fused = phase_tp_fused(dev, tp_params)
    tp_prefill["launches_a_fused_4_layers"] = tp_fused
    next(r for r in rows if r["name"] == "shift_accumulate")["launches_tp_prefill_fused"] = \
        tp_fused["shift"]
    del tp_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 20 (TP prefill over smi:fused): {time.perf_counter() - t0:.1f}s")
    row_d["launches"] = launches_d
    rows.append(row_d)

    t0 = time.perf_counter()
    latency_rows, lat_c = phase_channel_latency(dev)
    torch.cuda.synchronize()
    log(f"phase 21 (channel latency): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    bandwidth_rows, bw_c = phase_channel_bandwidth(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 22 (channel bandwidth): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    gesummv_res = phase_gesummv(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 23 (GESUMMV): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    coll, coll_a = phase_collective_channels(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 24 (collective channels): {time.perf_counter() - t0:.1f}s")
    by_name = {r["name"]: r for r in rows}
    by_name["accumulate"]["launches_channels"] = coll_a["fold"]
    by_name["shift_accumulate"]["launches_channels"] = coll_a["shift"]
    c_warp = next(r for r in rows if r["name"] == "router_run" and r["path"] == "warp")
    c_thread = next(r for r in rows if r["name"] == "router_run" and r["path"] == "thread")
    c_warp["launches_channels"] = lat_c["C_warp"] + bw_c["C_warp"]
    c_thread["launches_channels"] = lat_c["C"] - lat_c["C_warp"] + bw_c["C"] - bw_c["C_warp"]

    log("stencil_wall_per_step_ms: " + json.dumps(
        {k: v["wall_per_step_s"] * 1e3 for k, v in stencil.items()}))
    log("packet_stencil_wall_per_step_ms: " + json.dumps(
        {k: v["wall_per_step_s"] * 1e3 for k, v in packet_stencil.items()}))
    log("packet_stencil_profile: " + json.dumps(packet_profile))
    log("reductions_static_vs_fused_ms: " + json.dumps(reduce_times))
    log("injection_tab4: " + json.dumps(injection))
    log("prefill_yi6b_4096: " + json.dumps(prefill))
    for name, res in (("serving_yi6b", serving), ("serving_mamba2", ssm_serving)):
        log(f"{name}: " + json.dumps({k: {m: v[m] for m in ("tok_per_s", "ms_per_step",
                                                              "decode_steps", "tokens")}
                                      for k, v in res.items()}))
    log("prefill_mamba2_4096: " + json.dumps(ssm_prefill))
    log("tp_prefill_yi6b_4096_p8: " + json.dumps(tp_prefill))
    log("channel_latency: " + json.dumps(latency_rows))
    log("channel_bandwidth: " + json.dumps(bandwidth_rows))
    log("gesummv: " + json.dumps(gesummv_res))
    log("collective_channels: " + json.dumps(coll))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
