"""Model inputs per (arch, shape) and the synthetic training pipeline
(``repro.data``)."""

from .inputs import InputSpec, input_specs, make_inputs
from .pipeline import SyntheticTokenPipeline

__all__ = ["InputSpec", "SyntheticTokenPipeline", "input_specs", "make_inputs"]
