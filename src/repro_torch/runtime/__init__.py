"""Runtime fault tolerance: checkpointing (atomic manifest commit, async
writer, restore onto the target's device), failure simulation, the
elastic controller (planner-driven restart) and straggler detection."""

from .checkpoint import (
    CheckpointError,
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from .elastic import ElasticController, FailureEvent, simulate_failures
from .straggler import StragglerMonitor, StragglerVerdict

__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "ElasticController",
    "FailureEvent",
    "StragglerMonitor",
    "StragglerVerdict",
    "latest_step",
    "load_checkpoint",
    "save_checkpoint",
    "simulate_failures",
]
