"""Checkpoints (torch port of ``repro.checkpoint``): atomic, checksummed,
async-capable snapshots of a tree of tensors, in the reference's on-disk
layout (:class:`~repro_torch.checkpoint.manager.CheckpointManager`)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
