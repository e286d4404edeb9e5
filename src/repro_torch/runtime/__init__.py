"""Runtime fault tolerance: checkpointing (atomic manifest commit, async
writer, restore onto the target's device).  The straggler monitor and the
elastic controller of the reference's ``runtime`` package come with the
training loop."""

from .checkpoint import (
    CheckpointError,
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "latest_step",
    "load_checkpoint",
    "save_checkpoint",
]
