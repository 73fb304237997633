"""The dense and Mamba2 model families (``repro.models``): prefill at any
tensor-parallel degree for the dense blocks, decode at tp = 1."""

from .model import gather_hidden, init_lm, lm_caches, lm_decode_step, lm_prefill, lm_specs

__all__ = ["gather_hidden", "init_lm", "lm_caches", "lm_decode_step", "lm_prefill", "lm_specs"]
