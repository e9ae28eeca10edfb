"""Checkpointing: the port of ``repro/checkpoint``."""

from .manager import CheckpointManager                        # noqa: F401
