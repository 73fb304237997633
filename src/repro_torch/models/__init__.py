"""The dense and Mamba2 model families at tensor-parallel degree 1
(``repro.models``)."""

from .model import init_lm, lm_caches, lm_decode_step, lm_prefill

__all__ = ["init_lm", "lm_caches", "lm_decode_step", "lm_prefill"]
