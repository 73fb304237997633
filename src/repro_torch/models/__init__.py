"""The model families (``repro.models``): prefill, decode and the training
loss at any tensor-parallel degree."""

from .model import (
    assemble_logits,
    gather_hidden,
    init_lm,
    lm_cache_specs,
    lm_caches,
    lm_decode_step,
    lm_loss,
    lm_prefill,
    lm_specs,
    param_shapes,
)

__all__ = ["assemble_logits", "gather_hidden", "init_lm", "lm_cache_specs", "lm_caches",
           "lm_decode_step", "lm_loss", "lm_prefill", "lm_specs", "param_shapes"]
