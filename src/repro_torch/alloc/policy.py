"""Budget policies: how a round's probe budget is split across sessions.

``allocate`` maps one round's candidate set to per-session rectangle
budgets; ``observe`` feeds realized rewards back after the absorb.  The
service calls both under its lock, one candidate set per coalescing
group, so policies may keep cheap mutable state without their own locks.
"""

from __future__ import annotations

import math
from typing import Protocol, runtime_checkable

import numpy as np

from .features import FEATURE_NAMES, Candidate, feature_matrix


@runtime_checkable
class BudgetPolicy(Protocol):
    """The allocation seam (DESIGN.md §15).

    ``allocate`` returns ``{session_id: n_rects}`` covering every
    candidate; 0 means "skip this session this round" (its queue is left
    untouched — idle, not exhausted).  ``observe`` reports what one
    session's allocation actually bought: ``probes`` solved rows,
    ``hv_delta`` the normalized hypervolume gain the absorb logged, and
    ``wall_s`` the session's share of the dispatch wall time.
    """

    name: str

    def allocate(self, candidates: list[Candidate]) -> dict[str, int]:
        """Rectangles per candidate session for this round."""
        ...  # pragma: no cover - protocol

    def observe(self, session_id: str, probes: int, hv_delta: float,
                wall_s: float) -> None:
        """What one session's allocation bought."""
        ...  # pragma: no cover - protocol


class UniformPolicy:
    """Bit-for-bit legacy behavior: every session pops its own
    ``batch_rects`` every round, feedback is ignored.  The default-off
    safety baseline — ``tests/test_torch_alloc.py`` proves schedule
    parity against a policy-free service."""

    name = "uniform"

    def allocate(self, candidates: list[Candidate]) -> dict[str, int]:
        """Every candidate's own ``batch_rects``."""
        return {c.session_id: c.batch_rects for c in candidates}

    def observe(self, session_id: str, probes: int, hv_delta: float,
                wall_s: float) -> None:
        """Feedback is ignored."""


class GainBanditPolicy:
    """Epsilon-greedy linear contextual bandit over hypervolume gain.

    Scores each candidate ``w . x`` (x from :func:`feature_matrix`) as a
    proxy for expected hypervolume gain per probe-second, then deals a
    shrunken round budget (``budget_fraction`` of the legacy total) slot
    by slot to the highest scorers — that is where the <=0.7x probe
    saving comes from.  Slots restore candidates to their legacy
    ``batch_rects`` rate before anyone may exceed it (see ``allocate``),
    so the saving is funded by plateaued tenants, never by starving a
    still-gaining one.  Hard constraints come first:

    - **floor**: every candidate with queued work gets >= ``min_rects``
      (no tenant starves, however lopsided the learned weights);
    - **deadline guard**: a candidate whose deadline slack is inside
      ``deadline_guard`` x its dispatch wall EMA keeps its full legacy
      ``batch_rects`` — the bandit never routes budget away from a
      ticket about to miss its SLO;
    - **bucket cap**: per-session spend never exceeds ``cap_rects``
      (the executor's planned (G, R) bucket), so learned routing reuses
      compiled programs instead of triggering fresh compiles.

    The update rule is plain SGD on squared error against a
    running-scale-normalized reward ``(hv_delta/probes)/wall_s`` — see
    DESIGN.md §15 for what this linear model can and cannot capture.
    """

    name = "gain_bandit"

    def __init__(
        self,
        budget_fraction: float = 0.6,
        min_rects: int = 1,
        epsilon: float = 0.1,
        lr: float = 0.1,
        deadline_guard: float = 2.0,
        seed: int = 0,
    ):
        if not 0.0 < budget_fraction <= 1.0:
            raise ValueError("budget_fraction must be in (0, 1]")
        if min_rects < 1:
            raise ValueError("min_rects must be >= 1")
        self.budget_fraction = float(budget_fraction)
        self.min_rects = int(min_rects)
        self.epsilon = float(epsilon)
        self.lr = float(lr)
        self.deadline_guard = float(deadline_guard)
        self._rng = np.random.default_rng(seed)
        # optimistic prior: recent gain and volume share dominate until
        # observed rewards reshape the weights
        self.w = np.zeros(len(FEATURE_NAMES), dtype=np.float64)
        prior = {"gain_share": 1.0, "volume_share": 0.5,
                 "uncertain_fraction": 0.3, "inv_log_probes": 0.3,
                 "deadline_pressure": 0.3, "slo_urgency": 0.2,
                 "top_rect_share": 0.2, "staleness": 0.2}
        for name, v in prior.items():
            self.w[FEATURE_NAMES.index(name)] = v
        self._scale = 1e-9      # running |reward| scale (EMA)
        self._last_x: dict[str, np.ndarray] = {}
        self.updates = 0

    # ------------------------------------------------------------------
    def allocate(self, candidates: list[Candidate]) -> dict[str, int]:
        """Floors and deadline-guarded allowances first, then the shrunken
        budget dealt slot by slot (see the class docstring)."""
        if not candidates:
            return {}
        X = feature_matrix(candidates)
        scores = X @ self.w
        alloc: dict[str, int] = {}
        caps: dict[str, int] = {}
        for i, c in enumerate(candidates):
            self._last_x[c.session_id] = X[i]
            cap = max(1, int(c.cap_rects))
            if c.queue_len > 0:
                cap = min(cap, int(c.queue_len))
            caps[c.session_id] = cap
            if self._protected(c):
                alloc[c.session_id] = min(max(c.batch_rects, self.min_rects),
                                          cap)
            else:
                alloc[c.session_id] = min(self.min_rects, cap)
        budget = int(round(self.budget_fraction
                           * sum(c.batch_rects for c in candidates)))
        remaining = budget - sum(alloc.values())
        # deal the remaining slots epsilon-greedily, one rectangle at a
        # time, in two tiers: while any candidate sits BELOW its legacy
        # ``batch_rects`` rate, slots go to those candidates only (best
        # scorer first) — nobody runs above the uniform schedule while a
        # gaining tenant runs below it, which is what the worst-tenant
        # acceptance bar demands.  Only once every open candidate holds
        # its legacy rate may the surplus chase the top scorer up to its
        # bucket cap.  Greedy water-filling without the tier (pure
        # score/(1+extra) discounting) hands out slots proportional to
        # score, letting one hot tenant absorb the budget while a
        # slower-converging tenant with real gains idles at the floor.
        order = list(range(len(candidates)))
        while remaining > 0:
            open_idx = [i for i in order
                        if alloc[candidates[i].session_id]
                        < caps[candidates[i].session_id]]
            if not open_idx:
                break
            if self.epsilon > 0 and self._rng.random() < self.epsilon:
                pick = int(self._rng.choice(open_idx))
            else:
                below_legacy = [
                    i for i in open_idx
                    if alloc[candidates[i].session_id]
                    < max(candidates[i].batch_rects, self.min_rects)]

                def _disc(i: int) -> float:
                    sid = candidates[i].session_id
                    extra = alloc[sid] - self.min_rects
                    return scores[i] / (1.0 + max(extra, 0)) ** 2
                pick = max(below_legacy or open_idx, key=_disc)
            alloc[candidates[pick].session_id] += 1
            remaining -= 1
        return alloc

    def _protected(self, c: Candidate) -> bool:
        """Deadline guard: inside ``deadline_guard`` dispatch-walls of the
        deadline, the legacy allowance is untouchable."""
        return (math.isfinite(c.deadline_slack_s) and c.wall_ema_s > 0.0
                and c.deadline_slack_s
                <= self.deadline_guard * c.wall_ema_s)

    # ------------------------------------------------------------------
    def observe(self, session_id: str, probes: int, hv_delta: float,
                wall_s: float) -> None:
        """One SGD step of the linear model toward the realized reward."""
        x = self._last_x.get(session_id)
        if x is None or probes <= 0:
            return
        reward = (max(hv_delta, 0.0) / probes) / max(wall_s, 1e-6)
        self._scale = max(0.99 * self._scale, abs(reward), 1e-12)
        r = float(np.clip(reward / self._scale, 0.0, 2.0))
        pred = float(x @ self.w)
        self.w += self.lr * (r - pred) * x
        np.clip(self.w, -5.0, 5.0, out=self.w)
        self.updates += 1
