"""The dense, MoE and Mamba2 model families (``repro.models``): prefill
and decode at any tensor-parallel degree."""

from .model import (
    assemble_logits,
    gather_hidden,
    init_lm,
    lm_cache_specs,
    lm_caches,
    lm_decode_step,
    lm_prefill,
    lm_specs,
)

__all__ = ["assemble_logits", "gather_hidden", "init_lm", "lm_cache_specs", "lm_caches",
           "lm_decode_step", "lm_prefill", "lm_specs"]
