"""The optimiser (``repro.optim``): AdamW, global-norm clipping, the
error-feedback arithmetic and the learning-rate schedule."""

from .adamw import adamw_init, adamw_update, opt_specs
from .grad import ErrorFeedback, clip_by_global_norm
from .schedule import cosine_warmup

__all__ = ["ErrorFeedback", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_warmup"]
