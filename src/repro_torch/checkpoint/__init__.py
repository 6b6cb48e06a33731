"""Fault-tolerant checkpointing: atomic save, retention, async writer,
restore onto any device (the port of ``repro.checkpoint``)."""

from .manager import CheckpointManager  # noqa: F401
