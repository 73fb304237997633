"""Step builders (``repro.launch.steps``): the prefill step at any
tensor-parallel degree of a ``(1, P)`` mesh."""

from __future__ import annotations

import torch

from ..configs import ModelConfig, ShapeConfig
from ..core.comm import resolve_device
from ..mesh.api import make_ctx
from ..models import gather_hidden, lm_prefill


def _layer_plan(cfg: ModelConfig, comm_mode: str):
    """The layer plan a launch selects: the config's ``comm_plan`` (default
    ``"auto"``) when the comm_mode does not pin a transport backend; an
    explicit ``smi:<backend>`` (or bulk/none) keeps the layers on the pinned
    backend (plan None)."""
    return cfg.comm_plan if comm_mode == "smi" else None


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None, comm_mode: str = "smi",
                  shared_gather: bool = False, device=None):
    """The prefill step of ``cfg`` for ``shape`` on ``device`` (``cuda``
    unless named): a callable ``prefill(params, tokens, *, use_kernel=None)``
    that runs :func:`~repro_torch.models.lm_prefill` on tokens (B, S) and
    returns the final hidden states (B, S, D).  On the card its attention is
    kernel E and its SSD scan kernel F; ``use_kernel=False`` runs their
    plain versions there, for comparisons.

    ``mesh=(1, P)`` runs it tensor-parallel over P stacked ranks, the
    layers' collectives over ``comm_mode``: a bare ``"smi"`` (the default)
    takes the config's ``comm_plan`` (``"auto"``: the netsim tuning table
    picks each layer's backend and wire), a pinned ``"smi:static"``,
    ``"smi:fused"`` or ``"bulk"`` keeps every layer there; ``params`` are then
    :func:`~repro_torch.interop.shard_params`'s for ``prefill.ctx``.  The
    products are ``torch.matmul``, as the reference's are unless a caller
    injects a kernel through ``make_ctx(..., matmul_fn=...)``.  FSDP stays
    off: a data axis of one rank has nothing to shard over.
    """
    dev = resolve_device(device)
    ctx = make_ctx(mesh, comm_mode=comm_mode, opt_shared_gather=shared_gather,
                   plan=_layer_plan(cfg, comm_mode), device=dev)

    def prefill(params, tokens: torch.Tensor, *, use_kernel=None) -> torch.Tensor:
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be (B, S), got {tuple(tokens.shape)}")
        h = lm_prefill(params, tokens.to(dev), cfg, ctx, capacity=shape.seq_len,
                       use_kernel=use_kernel)
        return gather_hidden(h) if ctx.tp > 1 else h

    prefill.device = dev
    prefill.ctx = ctx
    return prefill
