"""Multi-session MOO service layer (DESIGN.md §5).

Turns the per-call Progressive Frontier solver into a long-lived,
multi-tenant optimizer service: many concurrent tuning sessions, each a
resumable ``PFState``, with MOGD solvers cached by problem signature (the
paper's recurring-job amortization made explicit), probe work coalesced
across sessions into shared MOGD batches, and multi-stage DAG jobs whose
stage frontiers compose into one job frontier.
"""

from ..core.task import (
    Objective,
    Preference,
    TaskSpec,
    UtopiaNearest,
    WeightedUtopiaNearest,
    WorkloadAware,
)
from .moo_service import (
    DagRecommendation,
    MOOService,
    Recommendation,
    SessionInfo,
)

__all__ = [
    "DagRecommendation",
    "MOOService",
    "Objective",
    "Preference",
    "Recommendation",
    "SessionInfo",
    "TaskSpec",
    "UtopiaNearest",
    "WeightedUtopiaNearest",
    "WorkloadAware",
]
