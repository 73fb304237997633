"""Build and load the port's CUDA kernels at first use.

The sources under ``src/repro_torch/csrc/`` expose a plain C interface and
are compiled by ``nvcc`` for ``sm_90a`` (Hopper) — one ``nvcc`` per source,
all started together — and linked into one shared library, loaded with
``ctypes``.  The build lands in ``build/repro_torch/<hash>/`` at the root
of the checkout, keyed on a hash of every file under ``csrc/`` (the sources
and the headers they include, :data:`HEADERS`) and the flags, so a changed
source or header builds anew and an unchanged tree loads at once.
``--fmad=false`` keeps every multiply and add separately rounded, which the
bit-for-bit contract with the plain PyTorch versions needs; kernels D, E and
F, held to a tolerance instead, fuse with explicit ``fmaf``.

Nothing here runs at import: :func:`library` builds on its first call.  A
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("accumulate.cu", "stencil.cu", "router.cu", "flash_attention.cu", "ssd.cu",
           "matmul.cu")
#: headers the sources include (the Hopper building blocks of kernels D, E and F);
#: like every file under ``csrc/`` they are part of the build's hash
HEADERS = ("hopper.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libsmi_kernels.so"
#: where the CUDA toolkit puts nvcc when neither CUDA_HOME nor PATH names it
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-O3", "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
                     "-Xptxas=-v")

#: kernel dtype codes of the C interface
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.int32: 3,
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"),
                 NVCC_FALLBACK):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


def _digest(csrc: Path = CSRC) -> str:
    """The build's key: the flags and every file under ``csrc`` (by relative
    path), so an edit to a header rebuilds as an edit to a source does."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (when not built yet) and return the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    missing = [f for f in SOURCES + HEADERS if not (CSRC / f).is_file()]
    if missing:
        raise RuntimeError(f"kernel sources missing from {CSRC}: {missing}")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(tmp / f"{src}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in SOURCES
        ]
        log, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== nvcc {src} (rc={p.returncode})\n{out}")
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *(str(tmp / f"{s}.o") for s in SOURCES),
             "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
        (out_dir / "build.log").write_text("\n".join(log))
        # atomic: a concurrent builder of the same sources sees all or nothing
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with its C
    signatures declared."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.smi_accumulate.argtypes = [p, p, p, i64, i32, p]
    lib.smi_accumulate.restype = i32
    lib.smi_shift_accumulate.argtypes = [p, p, p, p, i32, i64, i32, p]
    lib.smi_shift_accumulate.restype = i32
    lib.smi_stencil_sweep.argtypes = [p, p, i64, i64, i64, i32, p]
    lib.smi_stencil_sweep.restype = i32
    lib.smi_router_run.argtypes = [p] * 13 + [i32] * 11 + [p]
    lib.smi_router_run.restype = i32
    lib.smi_router_run_warp.argtypes = [p] * 12 + [i32] * 10 + [p]
    lib.smi_router_run_warp.restype = i32
    lib.smi_router_tick_block.argtypes = [p] * 20 + [i32] * 13 + [p]
    lib.smi_router_tick_block.restype = i32
    lib.smi_flash_attention.argtypes = [p] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 4 + [p]
    lib.smi_flash_attention.restype = i32
    lib.smi_ssd_scan.argtypes = [p] * 6 + [i32] * 5 + [p]
    lib.smi_ssd_scan.restype = i32
    lib.smi_ssd_scan_wgmma.argtypes = [p] * 6 + [i32] * 3 + [p]
    lib.smi_ssd_scan_wgmma.restype = i32
    lib.smi_matmul.argtypes = [p] * 3 + [i32] * 4 + [i64] * 2 + [i32] * 2 + [p]
    lib.smi_matmul.restype = i32
    lib.smi_matmul_wgmma.argtypes = [p] * 3 + [i32] * 7 + [p]
    lib.smi_matmul_wgmma.restype = i32
    lib.smi_flash_attention_wgmma.argtypes = ([p] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 3
                                              + [p])
    lib.smi_flash_attention_wgmma.restype = i32
    lib.smi_error_string.argtypes = [i32]
    lib.smi_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, kernel: str):
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = library().smi_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def current_stream(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device, read as
    PyTorch's own generated kernels read it: building a ``torch.cuda.Stream``
    to read its handle costs the host more than launching a small kernel."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
