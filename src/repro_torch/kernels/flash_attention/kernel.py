"""Kernel E: the flash-attention forward pass (online softmax, causal and
sliding-window masks, grouped-query heads).

:func:`flash_attention_kernel` launches the CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and runs
:func:`flash_attention_plain` on CPU tensors.  It replaces the Pallas kernel
``flash_attention_pallas`` of ``src/repro/kernels/flash_attention/kernel.py``
and computes the same function on the same padded ``(B*H, S, D)`` layout:

* query and key positions both count from 0 (left-aligned; the refs
  right-align the queries, so the two agree only when ``Sq == Skv``);
* a key is seen when ``kpos < skv_actual``, and ``qpos >= kpos`` (causal),
  and ``qpos - kpos < window`` (window);
* masked scores are ``-1e30``, masked probabilities 0, and the normaliser is
  clamped at ``1e-30`` before the divide, so padded query rows are finite;
* query row ``bh`` reads KV row ``(bh // H) * Hkv + (bh % H) // (H // Hkv)``.

Two CUDA kernels compute it, and :func:`flash_attention_path` picks one by
dtype and head dim alone: bfloat16 runs on Hopper's wgmma fed by TMA
(``"wgmma"``), float32 on float32 FMAs (``"fma"``).  The pick is not a
fallback: a call the dispatch sends to a path launches that path's kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import DTYPE_CODES, check_launch, current_stream, library
from ..common import aligned16

NEG_INF = -1e30
#: dtypes the kernel takes (float32 arithmetic inside, output in q's dtype)
FA_DTYPES = (torch.float32, torch.bfloat16)
#: head dims the CUDA kernel is built for; a smaller head dim is zero-padded
#: up to the next one (zeros add nothing to a dot product)
KERNEL_HEAD_DIMS = (64, 128, 256)
#: keys per block of the plain version (the Pallas kernel's default block_k)
PLAIN_BLOCK_K = 128
#: query rows and keys per tile of the CUDA kernel: the padded lengths must
#: be multiples of it
KERNEL_TILE = 64
WGMMA, FMA = "wgmma", "fma"


def flash_attention_path(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel E runs q, k, v of ``dtype`` and ``head_dim`` (at most the
    largest of :data:`KERNEL_HEAD_DIMS`, to which it is padded):
    :data:`WGMMA` for bfloat16, :data:`FMA` for float32."""
    if head_dim > KERNEL_HEAD_DIMS[-1] or dtype not in FA_DTYPES:
        raise ValueError(f"kernel E takes float32 or bfloat16 with head dims up to "
                         f"{KERNEL_HEAD_DIMS[-1]}, not {dtype} at {head_dim}")
    return WGMMA if dtype == torch.bfloat16 else FMA


def _kv_rows(BH: int, H: int, Hkv: int, device) -> torch.Tensor:
    """The KV row each query row reads (the Pallas kernel's ``kv_idx``)."""
    bh = torch.arange(BH, device=device)
    return (bh // H) * Hkv + (bh % H) // (H // Hkv)


def flash_attention_plain(q, k, v, *, n_q_heads: int, n_kv_heads: int, scale: float,
                          causal: bool = True, window: int | None = None,
                          skv_actual: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of kernel E: the Pallas kernel's function,
    computed the way the Pallas kernel does it at its default blocks, an
    online softmax over blocks of 128 keys in float32.  q ``(B*H, Sq, D)``, k/v
    ``(B*Hkv, Skv, D)``; returns ``(B*H, Sq, D)`` in q's dtype."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    skv = skv_actual if skv_actual is not None else Skv
    rows = _kv_rows(BH, n_q_heads, n_kv_heads, q.device)
    qf = q.float() * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((BH, Sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, Sq, D), dtype=torch.float32, device=q.device)
    for k_first in range(0, Skv, PLAIN_BLOCK_K):
        kb = k[rows, k_first:k_first + PLAIN_BLOCK_K].float()
        vb = v[rows, k_first:k_first + PLAIN_BLOCK_K].float()
        s = torch.bmm(qf, kb.transpose(1, 2))                        # (BH, Sq, bk)
        kpos = k_first + torch.arange(kb.shape[1], device=q.device)[None, :]
        mask = kpos < skv
        if causal:
            mask = mask & (qpos >= kpos)
        if window is not None:
            mask = mask & (qpos - kpos < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.bmm(p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def launch_flash_attention(q, k, v, out, *, n_q_heads: int, n_kv_heads: int, scale: float,
                           causal: bool, window: int | None, skv: int,
                           path: str | None = None) -> str:
    """One launch of kernel E on the kernel's layout (contiguous CUDA
    tensors, ``Sq`` and ``Skv`` multiples of :data:`KERNEL_TILE`, the head dim
    one of :data:`KERNEL_HEAD_DIMS`), writing ``out``.  ``path`` names the
    kernel (default :func:`flash_attention_path`'s pick; the FMA kernel also
    takes bfloat16, which ``chip_smoke.py`` times beside the wgmma one).
    Returns the path taken; raises on a failed launch."""
    BH, Sq, Dk = q.shape
    Skv = k.shape[1]
    path = path or flash_attention_path(q.dtype, Dk)
    lib = library()
    window = -1 if window is None else int(window)
    with torch.cuda.device(q.device):
        if path == WGMMA:
            q, k, v = (aligned16(t) for t in (q, k, v))
            err = lib.smi_flash_attention_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq, Skv, Dk,
                n_q_heads, n_kv_heads, ctypes.c_float(scale), int(causal), window, skv,
                current_stream(q))
        elif path == FMA:
            err = lib.smi_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq, Skv, Dk,
                n_q_heads, n_kv_heads, ctypes.c_float(scale), int(causal), window, skv,
                DTYPE_CODES[q.dtype], current_stream(q))
        else:
            raise ValueError(f"kernel E has the paths {WGMMA!r} and {FMA!r}, not {path!r}")
    check_launch(err, f"flash_attention ({path})")
    return path


def flash_attention_kernel(q, k, v, *, n_q_heads: int, n_kv_heads: int, scale: float,
                           causal: bool = True, window: int | None = None,
                           skv_actual: int | None = None) -> torch.Tensor:
    """Kernel E on CUDA tensors, :func:`flash_attention_plain` on CPU
    tensors.  q ``(B*H, Sq, D)``, k/v ``(B*Hkv, Skv, D)``, float32 or
    bfloat16, contiguous, with ``Sq`` and ``Skv`` multiples of
    :data:`KERNEL_TILE` and ``D <= 256``.  Raises on anything the kernel
    does not take and on a failed launch.  ``flash_attention_kernel.launches``
    counts launches, and ``flash_attention_kernel.wgmma_launches`` those that
    took the wgmma path (:func:`flash_attention_path`)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention_kernel takes q (BH, Sq, D) and k, v (BKV, Skv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, D = q.shape
    BKV, Skv, Dk = k.shape
    H, Hkv = n_q_heads, n_kv_heads
    if Dk != D or H % Hkv or BH % H or BKV != BH // H * Hkv:
        raise ValueError(f"inconsistent heads or head dims: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, H={H}, Hkv={Hkv}")
    skv = Skv if skv_actual is None else int(skv_actual)
    if not 0 <= skv <= Skv:
        raise ValueError(f"skv_actual={skv} outside [0, {Skv}]")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, n_q_heads=H, n_kv_heads=Hkv, scale=scale,
                                     causal=causal, window=window, skv_actual=skv)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_kernel runs on one cuda device or the cpu, "
                         f"not {q.device}, {k.device}, {v.device}")
    if q.dtype not in FA_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 alike, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if Sq % KERNEL_TILE or Skv % KERNEL_TILE:
        raise ValueError(f"flash_attention kernel needs Sq and Skv padded to multiples of "
                         f"{KERNEL_TILE}; got {Sq}, {Skv}")
    if D > KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention kernel takes head dims up to "
                         f"{KERNEL_HEAD_DIMS[-1]}, not {D}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, not {window}")
    if BH == 0 or Sq == 0:
        return torch.empty_like(q)
    Dk = next(d for d in KERNEL_HEAD_DIMS if d >= D)
    if Dk != D:
        pad = (0, Dk - D)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    path = launch_flash_attention(q, k, v, out, n_q_heads=H, n_kv_heads=Hkv, scale=scale,
                                  causal=causal, window=window, skv=skv)
    flash_attention_kernel.launches += 1
    flash_attention_kernel.wgmma_launches += int(path == WGMMA)
    return out[..., :D] if Dk != D else out


flash_attention_kernel.launches = 0
flash_attention_kernel.wgmma_launches = 0
