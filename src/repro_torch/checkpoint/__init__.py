"""Checkpointing substrate of the port: save/restore with atomic commit
and an async writer."""
from .ckpt import (CheckpointManager, latest_step, restore_checkpoint,
                   save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
