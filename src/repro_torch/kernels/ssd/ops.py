"""The public SSD entry points: padding and dispatch of the scan, and the
single-token decode step (``repro.kernels.ssd.ops``).  On the card the scan
launches kernel F through :class:`~..common.RecomputeFn`, whose backward
is the plain scan's."""

from __future__ import annotations

import functools

import torch

from ..common import RecomputeFn, pad_to
from .kernel import ssd_scan_kernel, ssd_scan_plain


def ssd_scan(x, dt, B, C, A, *, chunk: int = 128, use_kernel: bool | None = None):
    """The full-sequence SSD scan (prefill).  x ``(BH, S, Dh)``, dt
    ``(BH, S)``, B/C ``(G, S, Dst)`` with ``G`` dividing ``BH`` (``G == BH``
    is the reference's layout), A ``(BH, 1)``; returns ``(BH, S, Dh)`` in x's
    dtype.

    ``use_kernel`` mirrors the reference's ``use_pallas``: ``None`` launches
    kernel F on CUDA tensors and runs :func:`ssd_scan_plain` (the reference's
    chunked CPU dispatch) on CPU tensors; ``True`` on CPU tensors raises
    (kernel F has no CPU mode); ``False`` runs the plain version anywhere,
    which on the card is for comparisons only.  For the kernel, S is
    zero-padded up to a multiple of ``chunk``: a padded dt of 0 leaves the
    state as it is, and the padded rows are cut off the output.  On the card
    the launch goes through :class:`~..common.RecomputeFn`: its backward
    recomputes :func:`ssd_scan_plain` under autograd (the reference has no
    backward kernel)."""
    on_cuda = x.device.type == "cuda"
    if use_kernel is None:
        use_kernel = on_cuda
    plain = functools.partial(ssd_scan_plain, chunk=chunk)
    if not use_kernel:
        return plain(x, dt, B, C, A)
    if not on_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors: kernel F has no CPU mode")
    return RecomputeFn.apply(functools.partial(_kernel, chunk=chunk), plain, x, dt, B, C, A)


def _kernel(x, dt, B, C, A, *, chunk: int):
    """Kernel F on S zero-padded up to a multiple of ``chunk``."""
    S = x.shape[1]
    x, _ = pad_to(x, chunk, 1)
    dt, _ = pad_to(dt, chunk, 1)
    B, _ = pad_to(B, chunk, 1)
    C, _ = pad_to(C, chunk, 1)
    return ssd_scan_kernel(x, dt, B, C, A, chunk=chunk)[:, :S]


def ssd_decode_step(h, xt, dtt, Bt, Ct, A):
    """One decode token: h ``(BH, Dst, Dh)``, xt ``(BH, Dh)``, dtt ``(BH,)``,
    Bt/Ct ``(BH, Dst)``, A ``(BH, 1)`` -> ``(h', y (BH, Dh))``, h' in h's
    dtype and y in xt's, as the reference computes them (the decay and
    ``dt x`` in the inputs' dtype, the state in float32).  Plain PyTorch:
    the reference's step is plain jnp, not a kernel."""
    hf = h.float()
    dec = torch.exp(dtt[:, None] * A[:, 0:1])                      # (BH, 1)
    upd = Bt.float()[:, :, None] * (dtt[:, None] * xt).float()[:, None, :]
    h_new = dec[..., None] * hf + upd
    y = torch.einsum("bs,bsd->bd", Ct.float(), h_new)
    return h_new.to(h.dtype), y.to(xt.dtype)
