"""Online model server (DESIGN.md §9).

Per-workload surrogate models, versioned and content-addressed, kept
fresh from observed traces: ingest -> drift detection -> gated retrain ->
invalidation events that the MOO service turns into warm frontier
re-solves.  The optimizer only ever consumes frozen snapshots — the
paper's decoupled modeling engine, online.

The reference's dry-run ingest bridge (``ingest_dryrun``) comes with the
planner and trace harvest; the registry's vault with the persistence
plane.
"""

from .drift import DriftConfig, DriftDetector
from .registry import (
    ModelEvent,
    ModelRegistry,
    ModelSnapshot,
    TrainReport,
    WorkloadRecord,
    workload_signature,
)
from .trainer import (
    TrainerConfig,
    TrainOutcome,
    nearest_embedding,
    trace_embedding,
    train_candidate,
)

__all__ = [
    "DriftConfig",
    "DriftDetector",
    "ModelEvent",
    "ModelRegistry",
    "ModelSnapshot",
    "TrainReport",
    "TrainOutcome",
    "TrainerConfig",
    "WorkloadRecord",
    "nearest_embedding",
    "trace_embedding",
    "train_candidate",
    "workload_signature",
]
