"""Model inputs per (arch, shape) (``repro.data``)."""

from .inputs import InputSpec, input_specs, make_inputs

__all__ = ["InputSpec", "input_specs", "make_inputs"]
