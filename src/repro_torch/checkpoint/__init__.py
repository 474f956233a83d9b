"""Checkpointing (counterpart of ``repro.checkpoint``), in the reference's
on-disk format so that checkpoints cross between the two packages."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
