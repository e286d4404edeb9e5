"""Pareto geometry primitives (paper Defs. 3.1-3.3).

All functions operate on objective-space points of shape ``(N, k)`` under
*minimization* semantics.  Masks compare in float32 on the device of their
input (host arrays on the CPU), as the reference compares in fp32 with JAX
x64 off; the O(N^2) masked comparison is what the CUDA ``pareto_filter``
kernel tiles for the frontier store.  Hypervolume and the coverage metrics
are host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .problem import to_numpy


def _f32(points) -> torch.Tensor:
    return torch.as_tensor(points).to(torch.float32)


def dominates(f1, f2) -> torch.Tensor:
    """Def 3.1: f1 Pareto-dominates f2 (leq everywhere, lt somewhere).

    Broadcasts: ``f1: (..., k)``, ``f2: (..., k)`` -> bool tensor ``(...)``.
    """
    f1, f2 = torch.as_tensor(f1), torch.as_tensor(f2)
    leq = torch.all(f1 <= f2, dim=-1)
    lt = torch.any(f1 < f2, dim=-1)
    return torch.logical_and(leq, lt)


def pareto_mask(points) -> torch.Tensor:
    """Boolean mask of non-dominated points among ``points: (N, k)``.

    A point is kept iff no other point dominates it (Def 3.2).  Duplicate
    points do not dominate each other, so all copies of a non-dominated
    value survive (dedupe separately if needed).
    """
    p = _f32(points)
    a = p[:, None, :]  # (N, 1, k)
    b = p[None, :, :]  # (1, N, k)
    dom = torch.logical_and(torch.all(b <= a, dim=-1),
                            torch.any(b < a, dim=-1))
    return ~torch.any(dom, dim=1)


def pareto_filter(points, payload=None):
    """Return the Pareto subset of points (and aligned payload rows)."""
    mask = to_numpy(pareto_mask(points))
    pts = to_numpy(points)[mask]
    if payload is None:
        return pts
    return pts, to_numpy(payload)[mask]


def pareto_filter_masked(points, valid) -> torch.Tensor:
    """Pareto mask restricted to ``valid`` rows; invalid rows are neither
    dominators nor survivors.  Used by the PF loop where some CO probes
    return infeasible (no-point) results (Prop. 3.3/3.4)."""
    p = _f32(points)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=p.device)
    big = torch.where(valid[:, None], p, torch.full_like(p, float("inf")))
    a = big[:, None, :]
    b = big[None, :, :]
    dom = torch.logical_and(torch.all(b <= a, dim=-1),
                            torch.any(b < a, dim=-1))
    return torch.logical_and(~torch.any(dom, dim=1), valid)


def hypervolume_2d(points, ref) -> float:
    """Exact 2-D hypervolume dominated by ``points`` w.r.t. ``ref`` point
    (minimization).  Used by tests/benchmarks to score frontier quality."""
    pts = to_numpy(points, np.float64)
    ref = to_numpy(ref, np.float64)
    pts = pts[np.all(pts <= ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    mask = to_numpy(pareto_mask(pts))
    pts = pts[mask]
    order = np.argsort(pts[:, 0])
    pts = pts[order]
    hv, prev_y = 0.0, ref[1]
    for x, y in pts:
        if y < prev_y:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return float(hv)


def hypervolume(points, ref) -> float:
    """Hypervolume for k<=3 (exact recursive sweep); tests/benchmark metric."""
    pts = to_numpy(points, np.float64)
    ref = to_numpy(ref, np.float64)
    k = pts.shape[1] if pts.ndim == 2 and len(pts) else len(ref)
    if len(pts) == 0:
        return 0.0
    if k == 1:
        return float(max(0.0, ref[0] - pts[:, 0].min()))
    if k == 2:
        return hypervolume_2d(pts, ref)
    if k == 3:
        # Sweep over sorted z; accumulate 2-D HV slabs.
        pts = pts[np.all(pts <= ref, axis=1)]
        if len(pts) == 0:
            return 0.0
        mask = to_numpy(pareto_mask(pts))
        pts = pts[mask]
        zs = np.unique(pts[:, 2])
        hv, prev_z = 0.0, ref[2]
        for z in zs[::-1]:
            # The slab of heights (z, prev_z] contains no point z-coords, so
            # its dominated cross-section is the union of the 2-D boxes of
            # exactly the points with z-coordinate <= z.
            area = hypervolume_2d(pts[pts[:, 2] <= z + 1e-18][:, :2], ref[:2])
            hv += area * (prev_z - z)
            prev_z = z
        return float(hv)
    raise NotImplementedError("hypervolume implemented for k<=3")


def crowding_distance(points) -> np.ndarray:
    """NSGA-II crowding distance (used by the Evo baseline and coverage
    metrics).  (N, k) -> (N,) with inf at extremes."""
    pts = to_numpy(points, np.float64)
    n, k = pts.shape
    if n <= 2:
        return np.full(n, np.inf)
    order = np.argsort(pts, axis=0)  # (n, k): order[r, j] = r-th smallest
    srt = np.take_along_axis(pts, order, axis=0)
    span = srt[-1] - srt[0]  # (k,)
    # Interior contribution per column: neighbour gap normalized by span;
    # degenerate columns (zero span) contribute nothing to interior points.
    inner = np.where(span > 1e-30, (srt[2:] - srt[:-2]) / np.where(
        span > 1e-30, span, 1.0), 0.0)  # (n-2, k)
    per_col = np.zeros((n, k))
    cols = np.arange(k)[None, :]
    per_col[order[1:-1], cols] = inner
    per_col[order[[0, -1]], cols] = np.inf  # extremes (also when degenerate)
    return per_col.sum(axis=1)


def coverage_spread(points) -> float:
    """Frontier coverage metric: mean nearest-neighbour gap along the
    normalized frontier (lower = denser/more even coverage).  Quantifies
    the paper's "poor coverage of WS" observation (Fig 4b)."""
    pts = to_numpy(points, np.float64)
    if len(pts) < 2:
        return float("inf")
    lo, hi = pts.min(0), pts.max(0)
    span = np.where(hi - lo < 1e-30, 1.0, hi - lo)
    z = (pts - lo) / span
    d2 = ((z[:, None, :] - z[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float(np.sqrt(d2.min(axis=1)).mean())
