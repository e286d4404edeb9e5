"""Hyperrectangle geometry for the Progressive Frontier (paper §3.3).

A rectangle is the axis-aligned box between a local Utopia point ``u`` and a
local Nadir point ``n`` in objective space (Def 3.5).  The middle-point
probe (Def 3.6) solves a CO restricted to the *lower half-box*
``[u, (u+n)/2]``; a returned Pareto point ``m`` splits the box into ``2^k``
blocks of which the all-dominating corner ``[u, m]`` and the all-dominated
corner ``[m, n]`` contain no Pareto points (Props. 3.2-3.4) and are
discarded — the remaining ``2^k - 2`` blocks are the new uncertain space.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np


@dataclasses.dataclass(order=True)
class Rectangle:
    """Priority-queue entry; ordered by descending volume (paper Alg. 1)."""

    neg_volume: float
    utopia: np.ndarray = dataclasses.field(compare=False)
    nadir: np.ndarray = dataclasses.field(compare=False)

    @property
    def volume(self) -> float:
        """Box volume."""
        return -self.neg_volume


def make_rectangle(utopia, nadir) -> Rectangle:
    """The box ``[utopia, nadir]`` as a queue entry."""
    u = np.asarray(utopia, dtype=np.float64)
    n = np.asarray(nadir, dtype=np.float64)
    return Rectangle(-float(np.prod(np.maximum(n - u, 0.0))), u, n)


def compute_bounds(reference_points: np.ndarray):
    """Global Utopia/Nadir from the k single-objective reference points
    (Def 3.4/3.5): componentwise min / max."""
    ref = np.asarray(reference_points, dtype=np.float64)
    return ref.min(axis=0), ref.max(axis=0)


def split_rectangle(u: np.ndarray, m: np.ndarray, n: np.ndarray,
                    eps: float = 1e-12) -> list[Rectangle]:
    """Split box [u, n] at interior Pareto point m into 2^k blocks and keep
    the 2^k - 2 uncertain ones.  Degenerate (zero-volume) blocks are
    dropped: they cannot contain points distinct from already-known ones.
    """
    u = np.asarray(u, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    m = np.clip(np.asarray(m, dtype=np.float64), u, n)
    k = len(u)
    out: list[Rectangle] = []
    for corner in itertools.product((0, 1), repeat=k):
        if all(c == 0 for c in corner) or all(c == 1 for c in corner):
            continue  # dominating / dominated corner blocks (Prop 3.4)
        lo = np.where(np.asarray(corner) == 0, u, m)
        hi = np.where(np.asarray(corner) == 0, m, n)
        if np.all(hi - lo > eps):
            out.append(make_rectangle(lo, hi))
    return out


def grid_cells(u: np.ndarray, n: np.ndarray, l: int) -> list[Rectangle]:
    """Partition box [u, n] into an l^k grid (PF-AP, §4.3)."""
    u = np.asarray(u, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    k = len(u)
    edges = [np.linspace(u[j], n[j], l + 1) for j in range(k)]
    cells = []
    for idx in itertools.product(range(l), repeat=k):
        lo = np.array([edges[j][idx[j]] for j in range(k)])
        hi = np.array([edges[j][idx[j] + 1] for j in range(k)])
        cells.append(make_rectangle(lo, hi))
    return cells


class RectangleQueue:
    """Max-volume priority queue over uncertain rectangles.

    Tracks the total uncertain volume so the incremental uncertain-space
    fraction (Def 3.7, Fig 4a) is O(1) to read.
    """

    def __init__(self, initial: Rectangle):
        self._heap: list[Rectangle] = []
        self.initial_volume = max(initial.volume, 1e-300)
        self.total_volume = 0.0
        self.push(initial)

    @classmethod
    def from_rects(cls, rects, initial_volume: float) -> "RectangleQueue":
        """Rebuild a queue from an explicit rectangle set — the durable
        restore path: ``initial_volume`` must be the
        ORIGINAL queue's initial volume so the uncertain-space fraction
        (Def 3.7) resumes where it left off instead of resetting to 1."""
        q = cls.__new__(cls)
        q._heap = []
        q.initial_volume = max(float(initial_volume), 1e-300)
        q.total_volume = 0.0
        for r in rects:
            q.push(r)
        return q

    def rects(self) -> list[Rectangle]:
        """The queued rectangles (no order guarantee beyond heap layout)."""
        return list(self._heap)

    def push(self, rect: Rectangle) -> None:
        """Queue a rectangle (zero-volume ones are dropped)."""
        if rect.volume <= 0.0:
            return
        heapq.heappush(self._heap, rect)
        self.total_volume += rect.volume

    def pop(self) -> Rectangle:
        """Remove and return the largest rectangle."""
        rect = heapq.heappop(self._heap)
        self.total_volume -= rect.volume
        return rect

    def peek(self) -> Rectangle | None:
        """The rectangle the next ``pop`` would return (None if empty) —
        the budget plane's head-of-queue volume feature reads this
        without disturbing the heap."""
        return self._heap[0] if self._heap else None

    def __len__(self) -> int:
        """Number of queued rectangles."""
        return len(self._heap)

    @property
    def uncertain_fraction(self) -> float:
        """Queued volume over the initial volume (Def 3.7), in [0, 1]."""
        return min(1.0, max(0.0, self.total_volume / self.initial_volume))
