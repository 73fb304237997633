"""Kernel F: the Mamba2 SSD chunked scan with a carried state.

:func:`ssd_scan_kernel` launches the CUDA kernel ``csrc/ssd.cu`` on CUDA
tensors and runs :func:`ssd_scan_plain` on CPU tensors.  It replaces the
Pallas kernel ``ssd_pallas`` of ``src/repro/kernels/ssd/kernel.py`` and
computes the same function on the same ``(BH, S, Dh)`` / ``(BH, S)`` /
``(BH, S, Dst)`` / ``(BH, 1)`` layout, float32 inside, the output in x's
dtype, for ``A < 0`` and ``dt > 0``.  One extension: B and C may come as
``G`` rows, each shared by ``BH // G`` consecutive head rows (``G == BH`` is
the Pallas kernel's layout; the model passes one row per sequence, which
Mamba2 shares across its heads, rather than a copy broadcast to each head).

Two CUDA kernels compute it, and :func:`ssd_path` picks one by dtype and
dims alone: bfloat16 at mamba2's dims (head dim 64, state 128, chunk 128)
runs on Hopper's wgmma (``"wgmma"``), everything else on float32 FMAs
(``"fma"``: float32 inputs, and smaller dims zero-padded); both walk a head
row's chunks in one CTA with the float32 state carried.  The pick is not a
fallback: a call the dispatch sends to a path launches that path's kernel or
raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..build import DTYPE_CODES, check_launch, current_stream, library
from ..common import on_calling_thread

#: dtypes of x, B and C the kernel takes (dt and A are read as float32)
SSD_DTYPES = (torch.float32, torch.bfloat16)
#: chunk lengths the CUDA kernel walks
KERNEL_CHUNKS = (64, 128)
#: head dim and state dim the CUDA kernel is built for; smaller ones are
#: zero-padded up to them (zero columns add nothing and stay zero)
KERNEL_DH, KERNEL_DST = 64, 128
WGMMA, FMA = "wgmma", "fma"
#: the wgmma path's chunk
WGMMA_CHUNK = 128


def ssd_path(dtype: torch.dtype, Dh: int, Dst: int, chunk: int) -> str:
    """Which kernel F runs x, B, C of ``dtype`` at head dim ``Dh``, state
    ``Dst`` and ``chunk``: :data:`WGMMA` for bfloat16 at exactly
    (:data:`KERNEL_DH`, :data:`KERNEL_DST`, :data:`WGMMA_CHUNK`), :data:`FMA`
    for float32 and for smaller (padded) dims or chunks of 64."""
    if dtype not in SSD_DTYPES or Dh > KERNEL_DH or Dst > KERNEL_DST \
            or chunk not in KERNEL_CHUNKS:
        raise ValueError(f"kernel F takes float32 or bfloat16 with Dh <= {KERNEL_DH}, "
                         f"Dst <= {KERNEL_DST} and chunks of {KERNEL_CHUNKS}, not {dtype} at "
                         f"({Dh}, {Dst}, {chunk})")
    if dtype == torch.bfloat16 and (Dh, Dst, chunk) == (KERNEL_DH, KERNEL_DST, WGMMA_CHUNK):
        return WGMMA
    return FMA


def _check(x, dt, B, C, A):
    if x.dim() != 3 or dt.shape != x.shape[:2] or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"the SSD scan takes x (BH, S, Dh), dt (BH, S) and B, C (G, S, Dst); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    BH, S, _ = x.shape
    G = B.shape[0]
    if B.shape[1] != S or G == 0 or BH % G or A.numel() != BH:
        raise ValueError(f"B, C {tuple(B.shape)} and A {tuple(A.shape)} do not fit x "
                         f"{tuple(x.shape)}: B and C need S rows and G dividing BH, A one "
                         f"value a head row")


def _exp(t: torch.Tensor) -> torch.Tensor:
    """``torch.exp`` on the calling thread: the same bits on every call."""
    return on_calling_thread(torch.exp, t)


def ssd_scan_plain(x, dt, B, C, A, *, chunk: int = 128) -> torch.Tensor:
    """The plain PyTorch version of kernel F: the chunked math of the
    reference's ``_ssd_chunked_jnp`` in float32.  Within each chunk of
    ``chunk`` rows a causal, decay-weighted quadratic form; across chunks a
    loop carrying the ``(Dst, Dh)`` state.  x ``(BH, S, Dh)``, dt ``(BH, S)``,
    B/C ``(G, S, Dst)`` with ``G`` dividing ``BH``, A ``(BH, 1)``; S is
    zero-padded up to a multiple of ``chunk`` (dt = 0 leaves the state as it
    is).  Returns ``(BH, S, Dh)`` in x's dtype."""
    _check(x, dt, B, C, A)
    BH, S, Dh = x.shape
    G, Dst = B.shape[0], B.shape[-1]
    rep, L = BH // G, chunk
    pad = (-S) % L
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, pad))
    n = x.shape[1] // L

    xc = x.reshape(G, rep, n, L, Dh).float()
    dtc = dt.reshape(G, rep, n, L, 1).float()
    Bc = B.reshape(G, 1, n, L, Dst).float()
    Cc = C.reshape(G, 1, n, L, Dst).float()
    a = dtc * A.reshape(G, rep, 1, 1, 1).float()
    cum = torch.cumsum(a, dim=3)                                   # (G, rep, n, L, 1)
    xd = xc * dtc

    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # exp(cum_i - cum_j) for j <= i; above the diagonal the exponent is
    # positive and would overflow: select -inf there, so exp gives 0
    decay = _exp(torch.where(tri, cum - cum.transpose(-1, -2), float("-inf")))
    scores = (Cc @ Bc.transpose(-1, -2)) * decay                   # (G, rep, n, L, L)
    y1 = scores @ xd

    last = cum[..., -1:, :]                                        # (G, rep, n, 1, 1)
    chunk_state = (Bc * _exp(last - cum)).transpose(-1, -2) @ xd   # (G, rep, n, Dst, Dh)
    chunk_decay = _exp(last)
    h = torch.zeros((G, rep, 1, Dst, Dh), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(n):
        h_in.append(h)
        h = chunk_decay[:, :, c:c + 1] * h + chunk_state[:, :, c:c + 1]
    h_in = torch.cat(h_in, dim=2)                                  # (G, rep, n, Dst, Dh)

    y2 = _exp(cum) * (Cc @ h_in)
    return (y1 + y2).reshape(BH, n * L, Dh)[:, :S].to(x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data on a 16-byte boundary (the kernel's
    vector loads), copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_layout(x, dt, B, C, A, out, chunk: int):
    """Raises unless the tensors are on the kernel's layout: the kernels
    read raw pointers (the wgmma one through tensor maps built for dense
    strides), so a strided view or a wrong dtype would read the wrong
    memory without an error."""
    BH, S = x.shape[:2]
    G = B.shape[0]
    want = {"x": (x, (BH, S, KERNEL_DH), x.dtype), "out": (out, (BH, S, KERNEL_DH), x.dtype),
            "B": (B, (G, S, KERNEL_DST), x.dtype), "C": (C, (G, S, KERNEL_DST), x.dtype),
            "dt": (dt, (BH, S), torch.float32), "A": (A, (BH,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t.device != x.device or tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"launch_ssd_scan takes {name} contiguous, 16-byte aligned, "
                             f"{shape} {dtype} on {x.device}; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, strides {t.stride()}, address {t.data_ptr():#x}")
    if x.dtype not in SSD_DTYPES or G == 0 or BH % G or chunk not in KERNEL_CHUNKS or S % chunk:
        raise ValueError(f"launch_ssd_scan takes x in {SSD_DTYPES}, G dividing BH and S a "
                         f"multiple of a chunk of {KERNEL_CHUNKS}; got {x.dtype}, G {G}, BH "
                         f"{BH}, S {S}, chunk {chunk}")


def launch_ssd_scan(x, dt, B, C, A, out, *, chunk: int, path: str | None = None) -> str:
    """One call of kernel F on the kernel's layout (contiguous, 16-byte
    aligned CUDA tensors: x and ``out`` ``(BH, S, 64)``, B/C ``(G, S, 128)``
    alike in dtype, dt ``(BH, S)`` and A ``(BH,)`` float32, ``S`` a multiple
    of ``chunk``), writing ``out``; raises on any other layout.  ``path``
    names the kernel (default :func:`ssd_path`'s pick; the FMA kernel also
    takes bfloat16, which ``chip_smoke.py`` times beside the wgmma one).
    Returns the path taken; raises on a failed launch."""
    _check_layout(x, dt, B, C, A, out, chunk)
    BH, S, _ = x.shape
    G = B.shape[0]
    path = path or ssd_path(x.dtype, x.shape[-1], B.shape[-1], chunk)
    lib = library()
    with torch.cuda.device(x.device):
        if path == WGMMA:
            if x.dtype != torch.bfloat16 or chunk != WGMMA_CHUNK:
                raise ValueError(f"kernel F's wgmma path takes bfloat16 in chunks of "
                                 f"{WGMMA_CHUNK}, not {x.dtype} in chunks of {chunk}")
            err = lib.smi_ssd_scan_wgmma(x.data_ptr(), dt.data_ptr(), B.data_ptr(),
                                         C.data_ptr(), A.data_ptr(), out.data_ptr(), BH, G, S,
                                         current_stream(x))
        elif path == FMA:
            err = lib.smi_ssd_scan(x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                                   A.data_ptr(), out.data_ptr(), BH, G, S, chunk,
                                   DTYPE_CODES[x.dtype], current_stream(x))
        else:
            raise ValueError(f"kernel F has the paths {WGMMA!r} and {FMA!r}, not {path!r}")
    check_launch(err, f"ssd_scan ({path})")
    return path


def ssd_scan_kernel(x, dt, B, C, A, *, chunk: int = 128) -> torch.Tensor:
    """Kernel F on CUDA tensors, :func:`ssd_scan_plain` on CPU tensors.
    x ``(BH, S, Dh)`` and B/C ``(G, S, Dst)`` float32 or bfloat16 alike, dt
    ``(BH, S)`` and A ``(BH, 1)`` of a float type; ``S`` a multiple of
    ``chunk`` (64 or 128), ``Dh <= 64``, ``Dst <= 128``, ``G`` dividing
    ``BH``.  Raises on anything the kernel does not take and on a failed
    launch.  ``ssd_scan_kernel.launches`` counts calls that launched, and
    ``ssd_scan_kernel.wgmma_launches`` those that took the wgmma path
    (:func:`ssd_path`)."""
    _check(x, dt, B, C, A)
    BH, S, Dh = x.shape
    G, Dst = B.shape[0], B.shape[-1]
    if S % chunk:
        raise ValueError(f"the SSD scan kernel needs S padded to a multiple of the chunk "
                         f"({chunk}); got {S}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
    if x.device.type != "cuda" or any(t.device != x.device for t in (dt, B, C, A)):
        raise ValueError(f"ssd_scan_kernel runs on one cuda device or the cpu, not "
                         f"{[str(t.device) for t in (x, dt, B, C, A)]}")
    if x.dtype not in SSD_DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"the SSD scan kernel takes x, B and C in float32 or bfloat16 alike, "
                        f"not {x.dtype}, {B.dtype}, {C.dtype}")
    if not (dt.is_floating_point() and A.is_floating_point()):
        raise TypeError(f"dt and A must be floating point, not {dt.dtype}, {A.dtype}")
    if chunk not in KERNEL_CHUNKS:
        raise ValueError(f"the SSD scan kernel walks chunks of {KERNEL_CHUNKS}, not {chunk}")
    if Dh > KERNEL_DH or Dst > KERNEL_DST:
        raise ValueError(f"the SSD scan kernel takes Dh <= {KERNEL_DH} and Dst <= {KERNEL_DST}, "
                         f"not {Dh}, {Dst}")
    if BH == 0 or S == 0:
        return torch.empty_like(x)
    path = ssd_path(x.dtype, Dh, Dst, chunk)
    if Dh != KERNEL_DH:
        x = F.pad(x, (0, KERNEL_DH - Dh))
    if Dst != KERNEL_DST:
        B, C = (F.pad(t, (0, KERNEL_DST - Dst)) for t in (B, C))
    x, B, C = (_aligned(t) for t in (x, B, C))
    dt, A = (_aligned(t.float()) for t in (dt, A.reshape(BH)))
    out = torch.empty_like(x)
    launch_ssd_scan(x, dt, B, C, A, out, chunk=chunk, path=path)
    ssd_scan_kernel.launches += 1
    ssd_scan_kernel.wgmma_launches += int(path == WGMMA)
    return out[..., :Dh] if Dh != KERNEL_DH else out


ssd_scan_kernel.launches = 0
ssd_scan_kernel.wgmma_launches = 0
