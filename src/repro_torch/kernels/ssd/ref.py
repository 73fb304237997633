"""The sequential SSD recurrence (``repro.kernels.ssd.ref``): the
definition, in float32, an oracle for small shapes only."""

from __future__ import annotations

import torch


def ssd_ref(x, dt, B, C, A):
    """x ``(BH, S, Dh)``, dt ``(BH, S)``, B/C ``(BH, S, Dst)``, A ``(BH, 1)``.

    ``h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)``;  ``y_t = C_t · h_t``,
    from ``h_0 = 0``; returns y ``(BH, S, Dh)`` in x's dtype."""
    BH, S, Dh = x.shape
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    a = A.float()[:, 0]
    h = torch.zeros((BH, B.shape[-1], Dh), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = torch.exp(dtf[:, t] * a)[:, None, None] * h \
            + Bf[:, t, :, None] * (dtf[:, t, None] * xf[:, t])[:, None, :]
        ys.append(torch.einsum("bs,bsd->bd", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)
