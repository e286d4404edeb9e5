"""Straggler mitigation.

SPMD training programs are bulk-synchronous: one slow host delays every
step.  The standard mitigations are (a) detecting the straggler from step-time
telemetry and (b) evicting/replacing it via the elastic path.  This module
implements the detection half with an online robust z-score over per-host
step times, plus a data-loading double-buffer hint (the most common
non-hardware straggler source).

Off a fleet (one host, or the tests) per-host timings are given or
simulated; on a fleet they come from the runtime's per-host heartbeat.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerVerdict:
    """One flagged host: its robust z-score and the proposed action."""

    host: int
    z_score: float
    action: str  # "none" | "warn" | "evict"


class StragglerMonitor:
    """Online per-host step-time tracker with robust (median/MAD) scoring.

    ``observe(step, times)`` with times[h] = host h's step seconds.
    A host whose time exceeds median + z_warn*MAD for ``patience``
    consecutive steps is flagged; beyond z_evict it is proposed for
    eviction (the elastic controller handles the rest).
    """

    def __init__(self, n_hosts: int, window: int = 32, z_warn: float = 3.0,
                 z_evict: float = 6.0, patience: int = 3):
        self.n_hosts = n_hosts
        self.window = window
        self.z_warn, self.z_evict = z_warn, z_evict
        self.patience = patience
        self._hist = [collections.deque(maxlen=window)
                      for _ in range(n_hosts)]
        self._bad_streak = np.zeros(n_hosts, np.int32)

    def observe(self, times: np.ndarray) -> list[StragglerVerdict]:
        """Score one step's per-host times; returns hosts flagged this
        step (``warn`` after ``patience`` consecutive outliers, ``evict``
        beyond ``z_evict``)."""
        times = np.asarray(times, np.float64)
        for h in range(self.n_hosts):
            self._hist[h].append(times[h])
        med = np.median(times)
        mad = np.median(np.abs(times - med)) + 1e-9
        verdicts = []
        for h in range(self.n_hosts):
            z = (times[h] - med) / (1.4826 * mad)
            if z > self.z_warn:
                self._bad_streak[h] += 1
            else:
                self._bad_streak[h] = 0
            if self._bad_streak[h] >= self.patience:
                action = "evict" if z > self.z_evict else "warn"
                verdicts.append(StragglerVerdict(h, float(z), action))
        return verdicts

    def slowdown(self) -> float:
        """Fleet slowdown: mean(max per-step) / mean(median per-step)."""
        if not self._hist[0]:
            return 1.0
        arr = np.array([list(h) for h in self._hist])  # (hosts, t)
        return float(np.mean(arr.max(0)) / (np.mean(np.median(arr, 0)) + 1e-12))
