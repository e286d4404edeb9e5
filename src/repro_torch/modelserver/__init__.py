"""Online model server (DESIGN.md §9).

Per-workload surrogate models, versioned and content-addressed, kept
fresh from observed traces: ingest -> drift detection -> gated retrain ->
invalidation events that the MOO service turns into warm frontier
re-solves.  The optimizer only ever consumes frozen snapshots — the
paper's decoupled modeling engine, online.

``ingest_dryrun`` feeds harvested dry-run traces (``data/harvest.py``)
into the registry over the planner's knob space.
"""

from .drift import DriftConfig, DriftDetector
from .ingest import DRYRUN_OBJECTIVES, ingest_dryrun
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
    "DRYRUN_OBJECTIVES",
    "DriftConfig",
    "DriftDetector",
    "ModelEvent",
    "ModelRegistry",
    "ModelSnapshot",
    "TrainReport",
    "TrainOutcome",
    "TrainerConfig",
    "WorkloadRecord",
    "ingest_dryrun",
    "nearest_embedding",
    "trace_embedding",
    "train_candidate",
    "workload_signature",
]
