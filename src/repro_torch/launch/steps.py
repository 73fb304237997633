"""Step builders (``repro.launch.steps``), at tensor-parallel degree 1."""

from __future__ import annotations

import torch

from ..configs import ModelConfig, ShapeConfig
from ..core.comm import resolve_device
from ..mesh.api import make_ctx
from ..models import lm_prefill


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, *, device=None):
    """The prefill step of ``cfg`` for ``shape`` on ``device`` (``cuda``
    unless named): a callable ``prefill(params, tokens, *, use_kernel=None)``
    that runs :func:`~repro_torch.models.lm_prefill` on tokens (B, S) and
    returns the final hidden states (B, S, D).  On the card its attention is
    kernel E and its SSD scan kernel F; ``use_kernel=False`` runs their
    plain versions there, for comparisons.

    The reference shards the params over a mesh and switches FSDP on for
    yi-6b (12.1 GB of bfloat16 > 10 GB); on one card both are the identity.
    """
    dev = resolve_device(device)
    ctx = make_ctx()

    def prefill(params, tokens: torch.Tensor, *, use_kernel=None) -> torch.Tensor:
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be (B, S), got {tuple(tokens.shape)}")
        return lm_prefill(params, tokens.to(dev), cfg, ctx, capacity=shape.seq_len,
                          use_kernel=use_kernel)

    prefill.device = dev
    return prefill
