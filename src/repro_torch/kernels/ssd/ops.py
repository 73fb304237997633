"""The public SSD entry points: padding and dispatch of the scan, and the
single-token decode step (``repro.kernels.ssd.ops``).  On the card the scan
launches kernel F through :class:`~..common.RecomputeFn`, whose backward
is the plain scan's."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

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
    backward kernel).  On the ``meta`` device (the dry run,
    ``launch/dryrun.py``) it goes through :class:`~..common.RecomputeFn` and
    :data:`ssd_scan_op` as on the card, shapes only."""
    on_card = x.device.type in ("cuda", "meta")
    if use_kernel is None:
        use_kernel = on_card
    plain = functools.partial(ssd_scan_plain, chunk=chunk)
    if not use_kernel:
        return plain(x, dt, B, C, A)
    if not on_card:
        raise ValueError("use_kernel=True needs CUDA tensors: kernel F has no CPU mode")
    return RecomputeFn.apply(functools.partial(_kernel, chunk=chunk), plain, x, dt, B, C, A)


def _kernel(x, dt, B, C, A, *, chunk: int):
    """Kernel F on S zero-padded up to a multiple of ``chunk``."""
    S = x.shape[1]
    x, _ = pad_to(x, chunk, 1)
    dt, _ = pad_to(dt, chunk, 1)
    B, _ = pad_to(B, chunk, 1)
    C, _ = pad_to(C, chunk, 1)
    launch = ssd_scan_op if x.is_meta else ssd_scan_kernel
    return launch(x, dt, B, C, A, chunk=chunk)[:, :S]


#: kernel F on the ``meta`` device as the dispatcher op
#: ``repro_torch::ssd_scan_f`` (Meta: the output's shape; the card launches
#: :func:`ssd_scan_kernel` directly), so that the dry run's dispatch modes
#: see one op moving its inputs and output, its operations counted by
#: :func:`_ssd_flops`
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan_f(Tensor x, Tensor dt, Tensor B, Tensor C, Tensor A, *, int chunk) "
            "-> Tensor")
_LIB.impl("ssd_scan_f", lambda x, *_, **__: torch.empty_like(x), "Meta")
ssd_scan_op = torch.ops.repro_torch.ssd_scan_f.default


@register_flop_formula(torch.ops.repro_torch.ssd_scan_f)
def _ssd_flops(x_shape, dt_shape, B_shape, C_shape, A_shape, *, chunk, out_shape=None,
               **_) -> int:
    """Kernel F's operations for ``torch.utils.flop_counter``: per chunk of
    ``L`` positions and head, the causal products of the chunked form (the
    lower triangle of C B^T and of the scores x dt x, C h_in and the state
    update), two a multiply-add."""
    BH, S, Dh = x_shape
    Dst, L = B_shape[-1], chunk
    return 2 * (L * (L + 1) // 2 * (Dst + Dh) + 2 * L * Dst * Dh) * BH * (S // L)


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
