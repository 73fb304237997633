"""Channel descriptors (the open-time configuration of paper §2.2)."""

from .spec import KINDS, ChannelSpec, default_channel_spec

__all__ = ["KINDS", "ChannelSpec", "default_channel_spec"]
