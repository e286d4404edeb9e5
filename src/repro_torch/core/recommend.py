"""Automatic solution selection from a Pareto set — paper §5.

* **UN**  (Utopia Nearest): Euclidean-nearest point to the Utopia point in
  the normalized objective space.
* **WUN** (Weighted Utopia Nearest): weighted distance, weights capture
  application preference across objectives.
* **Workload-aware WUN**: final weights = internal (expert) weights ×
  external (application) weights; internal weights are derived from the
  workload's latency class (low/medium/high) following the parallel-DB
  folklore the paper cites (give long jobs more weight on latency, short
  jobs more weight on cost).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _normalize(F: np.ndarray, utopia: np.ndarray, nadir: np.ndarray) -> np.ndarray:
    span = np.maximum(np.asarray(nadir) - np.asarray(utopia), 1e-12)
    return (np.asarray(F) - np.asarray(utopia)) / span


def utopia_nearest(F: np.ndarray, utopia: np.ndarray, nadir: np.ndarray) -> int:
    """Index of the UN recommendation within the Pareto set F (N, k)."""
    z = _normalize(F, utopia, nadir)
    return int(np.argmin(np.linalg.norm(z, axis=1)))


def weighted_utopia_nearest(
    F: np.ndarray, utopia: np.ndarray, nadir: np.ndarray, weights
) -> int:
    """WUN: weights scale normalized objective distances; larger weight on
    an objective pulls the recommendation toward points good on it.

    Weights must be non-negative with a positive sum — a zero or negative
    weight vector has no meaningful normalization and raises."""
    w = np.asarray(weights, dtype=np.float64)
    if np.any(w < 0.0):
        raise ValueError(f"WUN weights must be >= 0, got {list(w)}")
    if w.sum() <= 0.0:
        raise ValueError(f"WUN weights must have positive sum, got {list(w)}")
    w = w / w.sum()
    z = _normalize(F, utopia, nadir)
    return int(np.argmin(np.linalg.norm(w * z, axis=1)))


@dataclasses.dataclass(frozen=True)
class WorkloadClassWeights:
    """Internal (expert) weights per workload latency class (§5).

    Defaults follow the paper's rule: long-running workloads weight latency
    over cost (allocate more resources), short ones weight cost.
    Assumes objective order (latency, cost, ...).
    """

    low: tuple = (0.3, 0.7)
    medium: tuple = (0.5, 0.5)
    high: tuple = (0.7, 0.3)

    def for_class(self, cls: str, k: int) -> np.ndarray:
        """Internal weights ``(k,)`` for a latency class."""
        table = {"low": self.low, "medium": self.medium, "high": self.high}
        if cls not in table:
            raise ValueError(
                f"unknown workload class {cls!r}; valid classes: "
                f"{sorted(table)}")
        base = table[cls]
        w = np.ones(k)
        w[: min(len(base), k)] = base[: min(len(base), k)]
        return w


def classify_workload(default_latency_s: float,
                      thresholds=(30.0, 300.0)) -> str:
    """Bucket a workload by latency under the default configuration."""
    if default_latency_s < thresholds[0]:
        return "low"
    if default_latency_s < thresholds[1]:
        return "medium"
    return "high"


def workload_aware_wun(
    F: np.ndarray,
    utopia: np.ndarray,
    nadir: np.ndarray,
    external_weights,
    default_latency_s: float,
    internal: WorkloadClassWeights = WorkloadClassWeights(),
) -> int:
    """w = w_internal ⊙ w_external (paper §5)."""
    k = np.asarray(F).shape[1]
    wi = internal.for_class(classify_workload(default_latency_s), k)
    we = np.asarray(external_weights, dtype=np.float64)
    return weighted_utopia_nearest(F, utopia, nadir, wi * we)


def select(
    F: np.ndarray,
    utopia: np.ndarray,
    nadir: np.ndarray,
    strategy: str = "un",
    weights=None,
    default_latency_s: float | None = None,
) -> int:
    """Unified entry point over the §5 selectors.

    ``strategy`` is one of ``"un"``, ``"wun"`` (requires ``weights``), or
    ``"workload"`` (requires ``weights`` and ``default_latency_s``).

    Deprecated in favor of the typed :class:`repro_torch.core.task.Preference`
    policies (``UtopiaNearest`` / ``WeightedUtopiaNearest`` /
    ``WorkloadAware``); kept as the shim behind
    :func:`repro_torch.core.task.preference_from_legacy`.
    """
    s = strategy.lower()
    if s == "un":
        return utopia_nearest(F, utopia, nadir)
    if s == "wun":
        if weights is None:
            raise ValueError("strategy 'wun' requires weights")
        return weighted_utopia_nearest(F, utopia, nadir, weights)
    if s == "workload":
        if weights is None or default_latency_s is None:
            raise ValueError(
                "strategy 'workload' requires weights and default_latency_s")
        return workload_aware_wun(F, utopia, nadir, weights, default_latency_s)
    raise ValueError(f"unknown recommendation strategy {strategy!r}")


def weighted_single_objective_pick(F: np.ndarray, weights,
                                    utopia: np.ndarray, nadir: np.ndarray) -> int:
    """The Ottertune-style competitor (§6.2): collapse objectives into one
    weighted sum *before* optimizing; equivalent here to picking the
    frontier point minimizing the scalarization.  Used by expt3/expt4 to
    contrast against WUN."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / max(w.sum(), 1e-12)
    z = _normalize(F, utopia, nadir)
    return int(np.argmin((z * w).sum(axis=1)))
