"""Atomic, async checkpointing in the reference's on-disk format (port of
`repro.checkpoint`)."""
from repro_torch.checkpoint.manager import CheckpointManager, latest_step

__all__ = ["CheckpointManager", "latest_step"]
