"""Checkpoint substrate: atomic, async, placed on restore (port of
``repro.checkpoint``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
