"""Drift detection: rolling prediction-error watermark per workload.

The paper's architecture keeps per-workload models fresh by retraining
from observed traces; the *trigger* for that refresh is model drift — the
frozen snapshot's predictions diverging from what the system actually
measures.  Lyu et al.'s adaptive optimizer (PAPERS.md) makes the same
observation at the query level: fine-grained adaptivity is where the
end-to-end wins come from, and it starts with noticing, cheaply and
online, that the model is wrong.

:class:`DriftDetector` keeps a bounded window of relative prediction
errors (one scalar per observed trace: the mean relative error across the
objective vector).  The watermark is *relative to the snapshot's own
validation error*: a model that validated at 8% error is stale when live
error sits at several multiples of that, while a model that validated at
30% (the paper's OtterTune band) is given proportionally more slack.  An
absolute floor stops a near-perfect snapshot from flapping on noise.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Watermark policy (see module docstring).

    ``window``     — number of recent traces the rolling error covers.
    ``min_obs``    — no verdict before this many post-(re)train traces.
    ``mult``       — watermark = ``mult * snapshot_val_error`` …
    ``floor``      — … but never below this absolute relative error.
    """

    window: int = 32
    min_obs: int = 8
    mult: float = 3.0
    floor: float = 0.15

    def __post_init__(self):
        if self.window < 1 or self.min_obs < 1:
            raise ValueError("window and min_obs must be >= 1")
        if self.min_obs > self.window:
            raise ValueError("min_obs cannot exceed window")
        if self.mult <= 0.0 or self.floor < 0.0:
            raise ValueError("mult must be > 0 and floor >= 0")


class DriftDetector:
    """Rolling median of relative prediction errors + watermark test.

    The median (not mean) makes the verdict robust to the occasional
    straggler run: one pathological trace cannot trip the watermark, a
    *shifted distribution* of errors does.
    """

    def __init__(self, config: DriftConfig = DriftConfig()):
        self.config = config
        self._errors: collections.deque = collections.deque(
            maxlen=config.window)

    def reset(self) -> None:
        """Forget the window (called after a version bump: the new
        snapshot gets a clean slate)."""
        self._errors.clear()

    @property
    def n_obs(self) -> int:
        return len(self._errors)

    def rolling_error(self) -> float:
        """Median relative error over the window (nan when empty)."""
        if not self._errors:
            return float("nan")
        return float(np.median(np.fromiter(self._errors, dtype=np.float64)))

    def watermark(self, val_error: float) -> float:
        return max(self.config.floor, self.config.mult * float(val_error))

    def update(self, rel_error: float, val_error: float) -> bool:
        """Record one trace's relative error; True iff the rolling error
        now crosses the snapshot's watermark (the *crossing* decision —
        debouncing repeated True verdicts is the registry's job)."""
        self._errors.append(float(rel_error))
        if len(self._errors) < self.config.min_obs:
            return False
        return self.rolling_error() > self.watermark(val_error)
