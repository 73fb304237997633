"""Configuration: the architectures and input shapes (a copy of
``repro.configs``), and the launch tables of the ported slices (transport
backends, comm_mode strings, stencil cells)."""

from .base import SHAPES, ModelConfig, ShapeConfig, pad_vocab
from .registry import ARCHS, COMM_MODES, STENCIL_CASES, TRANSPORT_BACKENDS, cells, get_arch, smoke

__all__ = ["ARCHS", "COMM_MODES", "SHAPES", "STENCIL_CASES", "TRANSPORT_BACKENDS", "ModelConfig",
           "ShapeConfig", "cells", "get_arch", "pad_vocab", "smoke"]
