"""Checkpointing (``repro.checkpoint``)."""

from .checkpointer import Checkpointer, tree_structure

__all__ = ["Checkpointer", "tree_structure"]
