"""Probe-budget allocation plane (DESIGN.md §15).

The Progressive Frontier spends its dominant cost — MOGD probe batches —
uniformly: every session gets ``batch_rects`` rectangles per round no
matter which tenants are still improving.  This package decides, per
coalesced round, how many rectangles each session may pop, behind one
:class:`BudgetPolicy` protocol:

- :class:`UniformPolicy` — bit-for-bit legacy behavior (every candidate
  gets its own ``batch_rects``); the default-off safety baseline.
- :class:`GainBanditPolicy` — an epsilon-greedy linear contextual bandit
  scoring sessions by expected hypervolume gain per probe-second, with a
  minimum-probe floor (no tenant starves) and a deadline guard (budget is
  never routed away from a ticket inside ``deadline_guard``x its wall
  EMA).

Feature extraction (:func:`feature_matrix`) feeds on the gain-attribution
telemetry recorded by ``PFState.gain_log`` and on frontdesk context
(SLO class, deadline slack, wall EMA).  The service wires policies in via
``MOOService(budget_policy=...)``; allocation always respects the
executor's compiled (G, R) buckets — routing never triggers a fresh
compile (see ``MOOService._budget_allocations``).
"""

from .features import FEATURE_NAMES, SLO_URGENCY, Candidate, feature_matrix
from .policy import BudgetPolicy, GainBanditPolicy, UniformPolicy

__all__ = [
    "BudgetPolicy",
    "Candidate",
    "FEATURE_NAMES",
    "GainBanditPolicy",
    "SLO_URGENCY",
    "UniformPolicy",
    "feature_matrix",
]
