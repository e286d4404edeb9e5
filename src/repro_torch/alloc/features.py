"""Per-(session, round) feature extraction for budget policies.

Every feature is a bounded [0, 1] transform so the linear bandit's
weights stay comparable across heterogeneous tenant mixes, and the
relative features (volume share, gain share) are computed *within* the
candidate set — the bandit compares cells competing for the same round's
budget, not absolute magnitudes across unrelated workloads.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# SLO class -> urgency prior (the frontdesk's admission classes);
# unknown classes read as "standard"
SLO_URGENCY = {"interactive": 1.0, "standard": 0.5, "batch": 0.2}

FEATURE_NAMES = (
    "bias",
    "uncertain_fraction",   # Def-3.7 undecided share of this session's box
    "volume_share",         # this session's uncertain volume / round total
    "top_rect_share",       # head rectangle's share of the session volume
    "gain_share",           # recent hv-gain-per-probe EMA / round max
    "inv_log_probes",       # cheap-tenant prior: few probes spent so far
    "staleness",            # rounds since this session last got budget
    "slo_urgency",          # admission-class prior (SLO_URGENCY)
    "deadline_pressure",    # 1/(1+slack_s); inf slack -> 0
)


@dataclasses.dataclass
class Candidate:
    """One session competing for this round's probe budget.

    The service fills the optimizer-side fields from ``PFState`` /
    ``_Session`` telemetry; the frontdesk-side fields (``slo``,
    ``deadline_slack_s``, ``wall_ema_s``, ``sheddable``) arrive via the
    ``context`` argument of ``step_sessions`` and keep their neutral
    defaults for direct (non-frontdesk) callers.

    ``cap_rects`` is the bucket-safe ceiling: the most rectangles this
    session may pop without pushing its group's dispatch outside the
    executor's already-planned (G, R) bucket (DESIGN.md §15).
    """

    session_id: str
    group_key: tuple | None = None
    batch_rects: int = 1            # the legacy per-round allowance
    cap_rects: int = 1              # bucket-safe ceiling (>= batch_rects)
    queue_len: int = 0              # rectangles currently queued
    uncertain_volume: float = 0.0   # queue total volume
    uncertain_fraction: float = 1.0
    top_rect_volume: float = 0.0
    probes: int = 0
    frontier_points: int = 0
    gain_ema: float = 0.0           # EMA of hv delta per probe (service)
    rounds_idle: int = 0            # rounds since last non-zero allocation
    slo: str = "standard"
    deadline_slack_s: float = math.inf
    wall_ema_s: float = 0.0         # batcher's per-group dispatch wall EMA
    sheddable: bool = True


def feature_matrix(candidates: list[Candidate]) -> np.ndarray:
    """``(N, len(FEATURE_NAMES))`` bounded feature rows, aligned with
    ``candidates``.  Relative shares normalize within the set."""
    n = len(candidates)
    X = np.zeros((n, len(FEATURE_NAMES)), dtype=np.float64)
    if n == 0:
        return X
    total_vol = sum(max(c.uncertain_volume, 0.0) for c in candidates)
    max_gain = max((max(c.gain_ema, 0.0) for c in candidates), default=0.0)
    for i, c in enumerate(candidates):
        vol = max(c.uncertain_volume, 0.0)
        slack = c.deadline_slack_s
        X[i] = (
            1.0,
            float(np.clip(c.uncertain_fraction, 0.0, 1.0)),
            vol / total_vol if total_vol > 0 else 0.0,
            (max(c.top_rect_volume, 0.0) / vol) if vol > 0 else 0.0,
            (max(c.gain_ema, 0.0) / max_gain) if max_gain > 0 else 0.0,
            1.0 / (1.0 + math.log1p(max(c.probes, 0))),
            1.0 - 1.0 / (1.0 + max(c.rounds_idle, 0)),
            SLO_URGENCY.get(c.slo, SLO_URGENCY["standard"]),
            0.0 if not math.isfinite(slack) else 1.0 / (1.0 + max(slack, 0.0)),
        )
    return X
