"""Model inputs per (arch, shape) (``repro.data.inputs``): their shapes and
dtypes, and deterministic arrays of them.

The modality frontends are the reference's stubs: a vision model's
InternViT and an audio model's EnCodec are not modelled; the backbone gets
the precomputed patch embeddings (``pixel_embeds``, (B, n_patches, D) in
the model dtype) or the codebook token streams (tokens ``(B, S, n_cb)``).
:func:`make_inputs` draws from ``numpy.random.RandomState(seed)`` in the
reference's order, so both packages get the same arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.comm import resolve_device


class InputSpec(NamedTuple):
    """One input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _tok_shape(cfg: ModelConfig, B: int, S: int) -> tuple:
    return (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, batch_override=None) -> dict:
    """Every model input of this (arch, shape) cell, in the reference's
    order: ``tokens`` (and ``labels`` for training) int32, a vision model's
    ``pixel_embeds``; a decode step's ``token`` and scalar ``pos``."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32 = torch.int32
    emb_dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": InputSpec(_tok_shape(cfg, B, S), i32)}
        if shape.kind == "train":
            spec["labels"] = InputSpec(_tok_shape(cfg, B, S), i32)
        if cfg.frontend == "vit_stub":
            spec["pixel_embeds"] = InputSpec((B, cfg.n_patches, cfg.d_model), emb_dt)
        return spec
    if shape.kind == "decode":
        tok = (B, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B,)
        return {"token": InputSpec(tok, i32), "pos": InputSpec((), i32)}
    raise ValueError(shape.kind)


def make_inputs(cfg: ModelConfig, shape: ShapeConfig, seed=0, *, batch_override=None,
                device=None) -> dict:
    """Deterministic tensors matching :func:`input_specs` on ``device``
    (``cuda`` unless named): token ids uniform over the vocabulary, patch
    embeddings 0.02 times a standard normal, ``pos`` half the sequence;
    a vision model's labels ignore (-100) its patch positions."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    out = {}
    for k, sd in input_specs(cfg, shape, batch_override=batch_override).items():
        if sd.dtype == torch.int32:
            if k == "pos":
                a = np.asarray(shape.seq_len // 2, np.int32)
            else:
                a = rng.randint(0, cfg.vocab_size, sd.shape).astype(np.int32)
            out[k] = torch.from_numpy(a)
        else:
            # float64 draws cast as the reference casts them: through float32
            out[k] = torch.from_numpy((rng.randn(*sd.shape) * 0.02).astype(np.float32)).to(sd.dtype)
    if "labels" in out and cfg.frontend == "vit_stub":
        out["labels"][:, :cfg.n_patches] = -100
    return {k: v.to(dev) for k, v in out.items()}
