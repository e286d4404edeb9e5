"""Competitor MOO methods from the paper's evaluation (§3.2, §6.1).

* Weighted Sum (WS) [Marler & Arora 2004] — scalarize with a lattice of
  weight vectors; known to give poor frontier coverage (Fig. 4b).
* Normalized Constraints (NC) [Messac et al. 2003] — probe an evenly spaced
  grid of the objective space; realized here as the ε-constraint grid the
  paper describes ("divides the objective space into an evenly distributed
  grid and probes the grid points").  Non-incremental by construction.
* NSGA-II (Evo) [Deb et al. 2002] — full implementation: fast non-dominated
  sort, crowding distance, tournament selection, SBX crossover, polynomial
  mutation.  Exhibits the paper's inconsistency-across-probe-budgets issue.

All methods accept the same :class:`~repro_torch.core.task.TaskSpec` (or a
compiled :class:`MOOProblem`) and share PF's gradient / evaluation
machinery, so timing comparisons are apples-to-apples; declared objective
bounds are honored by every method (infeasible points are excluded).
Each returns a :class:`BaselineResult` whose trace rows are
``(elapsed_s, uncertain_fraction_or_nan, n_points)`` — WS/NC/Evo produce
their first frontier only at the end of a full pass, which is exactly the
latency pathology Fig. 4(a) highlights.

Each entry point takes ``device=None`` (meaning ``cuda``), which must be
the problem's device.  WS descends every (weight, start) row in one
batched autograd loop on that device; NC's solves go through the problem's
MOGD solver (the fused descend kernel for MLP programs on the card);
NSGA-II's variation is numpy (``np.random.default_rng(seed)``) and only its
evaluations touch the device.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from ..kernels.platform import resolve_device
from . import pareto
from .mogd import MOGDConfig, estimate_objective_bounds
from .problem import MOOProblem, feasible_mask, to_numpy
from .task import as_problem


@dataclasses.dataclass
class BaselineResult:
    F: np.ndarray
    X: np.ndarray
    trace: list
    probes: int
    elapsed: float


def _apply_value_constraints(problem: MOOProblem, F: np.ndarray,
                             X: np.ndarray, tol: float = 1e-6):
    """Mark-and-exclude points violating the task's hard value bounds, so
    WS/NC/Evo honor a declared budget cap exactly like PF does (fair
    comparison under the same TaskSpec).  Must run BEFORE Pareto masking —
    an infeasible point may dominate the constrained optimum, and
    filtering after the mask would drop both (FrontierStore.add applies
    the same order)."""
    vc = problem.value_constraints
    if vc is None or len(F) == 0:
        return F, X
    ok = feasible_mask(vc, F, tol)
    return F[ok], X[ok]


def _problem_on(problem, device) -> MOOProblem:
    """Compile a TaskSpec (or take a problem) and check it lives on the
    resolved ``device``."""
    dev = resolve_device(device)
    problem = as_problem(problem)
    if problem.device != dev:
        raise ValueError(f"problem lives on {problem.device}, baseline "
                         f"asked for {dev}")
    return problem


def _pareto_rows(F: np.ndarray, X: np.ndarray):
    """The mutually non-dominated rows of ``F`` and their ``X``."""
    if len(F):
        mask = to_numpy(pareto.pareto_mask(F))
        F, X = F[mask], X[mask]
    return F, X


# ---------------------------------------------------------------------------
# Weight lattices (Das-Dennis simplex) for WS
# ---------------------------------------------------------------------------


def weight_lattice(k: int, n_points: int) -> np.ndarray:
    """~n_points weight vectors on the k-simplex."""
    if k == 2:
        w = np.linspace(0.0, 1.0, n_points)
        return np.stack([w, 1.0 - w], axis=1)
    # smallest H with C(H+k-1, k-1) >= n_points
    H = 1
    while True:
        cnt = len(list(itertools.combinations(range(H + k - 1), k - 1)))
        if cnt >= n_points:
            break
        H += 1
    ws = []
    for c in itertools.combinations(range(H + k - 1), k - 1):
        prev, w = -1, []
        for ci in c:
            w.append(ci - prev - 1)
            prev = ci
        w.append(H + k - 2 - prev)
        ws.append(np.array(w, dtype=np.float64) / H)
    ws = np.stack(ws)
    if len(ws) > n_points:
        idx = np.linspace(0, len(ws) - 1, n_points).astype(int)
        ws = ws[idx]
    return ws


def weighted_sum(
    problem,  # MOOProblem or TaskSpec
    n_probes: int = 10,
    mogd: MOGDConfig = MOGDConfig(),
    bounds: np.ndarray | None = None,
    device=None,
) -> BaselineResult:
    """WS: each weight vector defines one scalarized SO problem, solved by
    multi-start gradient descent on sum_i w_i * F̂_i.

    All (weights x starts) rows descend together: the rows are
    independent, so the gradient of the summed loss gives each row its
    own.  In fp32 and in the reference's order: non-finite gradient
    entries set to 0, Adam with bias correction (``t`` a float from 1),
    the clip to [0,1].  The starts are ``problem.sample`` of a generator
    seeded with ``mogd.seed``, ``W * S`` rows reshaped to ``(W, S, D)``."""
    problem = _problem_on(problem, device)
    dev = problem.device
    t0 = time.perf_counter()
    if bounds is None:
        bounds = estimate_objective_bounds(problem)
    f32 = dict(dtype=torch.float32, device=dev)
    lo = torch.as_tensor(np.asarray(bounds[0]), **f32)
    hi = torch.as_tensor(np.asarray(bounds[1]), **f32)
    width = torch.maximum(hi - lo, lo.new_tensor(1e-12))
    Wn = weight_lattice(problem.k, n_probes)
    W = torch.as_tensor(Wn, **f32)
    nW, S, D = len(Wn), mogd.multistart, problem.dim
    batch = problem._batch_fn  # vmap of the per-point objective

    x0s = problem.sample(torch.Generator().manual_seed(int(mogd.seed)),
                         nW * S).to(**f32)
    w_rows = W.repeat_interleave(S, dim=0)  # row b*S + s -> weight b
    x = x0s
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    t = torch.ones((), **f32)
    for _ in range(mogd.steps):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.sum(w_rows * (batch(xg) - lo) / width)
            (g,) = torch.autograd.grad(loss, xg)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        x = x - mogd.lr * (m / (1 - 0.9 ** t)) / (
            torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        x = torch.clamp(x, 0.0, 1.0)
        t = t + 1.0
    with torch.no_grad():
        snapped = problem.encoder.snap(x)
        fv = batch(snapped).reshape(nW, S, problem.k)
        snapped = snapped.reshape(nW, S, D)
        score = torch.einsum("bk,bsk->bs", W, (fv - lo) / width)
        best = torch.argmin(score, dim=1)
        rows = torch.arange(nW, device=dev)
        X, F = to_numpy(snapped[rows, best]), to_numpy(fv[rows, best])
    F, X = _pareto_rows(*_apply_value_constraints(problem, F, X))
    el = time.perf_counter() - t0
    return BaselineResult(F, X, [(el, np.nan, len(F))], int(nW), el)


def normalized_constraints(
    problem,  # MOOProblem or TaskSpec
    n_probes: int = 10,
    mogd: MOGDConfig = MOGDConfig(),
    bounds: np.ndarray | None = None,
    device=None,
) -> BaselineResult:
    """NC as an even ε-constraint grid over objectives 2..k: minimize F_1
    subject to F_j within each grid slab.  Requires N^p = n_probes grid
    points fixed *up front* (the paper's efficiency criticism: not
    incremental, cost grows with grid resolution).

    Like the original NC method, the grid spans the box of the k anchor
    (reference) points, which are found first by k single-objective solves
    — part of why NC's time-to-first-frontier is long (Fig. 4a).  The
    grid's boxes go to the problem's MOGD solver in one solve.
    """
    problem = _problem_on(problem, device)
    t0 = time.perf_counter()
    solver = problem.solver_for(mogd, device=problem.device)
    if bounds is None:
        bounds = estimate_objective_bounds(problem)
        # Anchor-point pass (Def. 3.4): shrink the grid box to the span of
        # the reference points, as NC prescribes.
        refs = []
        for i in range(problem.k):
            r = solver.solve_single_objective(i, bounds)
            if bool(r.feasible[0]):
                refs.append(r.f[0])
        if len(refs) == problem.k:
            refs = np.stack(refs)
            lo_a, hi_a = refs.min(0), refs.max(0)
            span = np.maximum(hi_a - lo_a, 1e-9)
            bounds = np.stack([lo_a, lo_a + span])
    k = problem.k
    per_axis = max(2, int(round(n_probes ** (1.0 / max(k - 1, 1)))))
    lo, hi = bounds[0], bounds[1]
    edges = [np.linspace(lo[j], hi[j], per_axis + 1) for j in range(1, k)]
    boxes = []
    for idx in itertools.product(range(per_axis), repeat=k - 1):
        blo, bhi = lo.copy(), hi.copy()
        for a, j in enumerate(range(1, k)):
            blo[j] = edges[a][idx[a]]
            bhi[j] = edges[a][idx[a] + 1]
        boxes.append(np.stack([blo, bhi]))
    boxes = np.stack(boxes)
    res = solver.solve(boxes, target=0)
    F, X = _pareto_rows(*_apply_value_constraints(
        problem, res.f[res.feasible], res.x[res.feasible]))
    el = time.perf_counter() - t0
    return BaselineResult(F, X, [(el, np.nan, len(F))], len(boxes), el)


# ---------------------------------------------------------------------------
# NSGA-II
# ---------------------------------------------------------------------------


def _fast_non_dominated_sort(F: np.ndarray) -> np.ndarray:
    """Return front index per individual (0 = best front)."""
    n = len(F)
    leq = np.all(F[:, None, :] <= F[None, :, :], axis=2)
    lt = np.any(F[:, None, :] < F[None, :, :], axis=2)
    dom = leq & lt  # dom[i, j] = i dominates j
    n_dom = dom.sum(axis=0)  # how many dominate j
    fronts = np.full(n, -1)
    current = np.where(n_dom == 0)[0]
    rank = 0
    while len(current):
        fronts[current] = rank
        n_dom = n_dom - dom[current].sum(axis=0)
        n_dom[fronts >= 0] = np.iinfo(np.int64).max
        current = np.where(n_dom == 0)[0]
        rank += 1
    return fronts


def nsga2(
    problem,  # MOOProblem or TaskSpec
    n_probes: int = 50,
    pop_size: int = 40,
    seed: int = 0,
    eta_c: float = 15.0,
    eta_m: float = 20.0,
    record_every_gen: bool = True,
    n_gens: int | None = None,
    device=None,
) -> BaselineResult:
    """NSGA-II; ``n_probes`` caps the number of *frontier points* requested,
    generations continue until the population's first front stabilizes at
    that size or the generation budget runs out."""
    problem = _problem_on(problem, device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    D = problem.dim

    def snap(P):
        return to_numpy(problem.encoder.snap(torch.as_tensor(
            P, dtype=torch.float32, device=problem.device)))

    def evaluate(P):
        return to_numpy(problem.evaluate_batch(snap(P)))

    P = rng.random((pop_size, D))
    F = evaluate(P)
    trace = []
    if n_gens is None:
        n_gens = max(4, int(np.ceil(3 * n_probes / pop_size)) + 6)
    evals = pop_size
    for gen in range(n_gens):
        # --- variation: binary tournament on (rank, crowding) ------------
        ranks = _fast_non_dominated_sort(F)
        crowd = np.zeros(len(F))
        for r in np.unique(ranks):
            idx = np.where(ranks == r)[0]
            crowd[idx] = pareto.crowding_distance(F[idx])

        def tournament():
            a, b = rng.integers(0, pop_size, 2)
            if ranks[a] != ranks[b]:
                return a if ranks[a] < ranks[b] else b
            return a if crowd[a] > crowd[b] else b

        children = np.empty_like(P)
        for i in range(0, pop_size, 2):
            p1, p2 = P[tournament()], P[tournament()]
            # SBX crossover
            u = rng.random(D)
            beta = np.where(
                u <= 0.5,
                (2 * u) ** (1.0 / (eta_c + 1)),
                (1.0 / (2 * (1 - u))) ** (1.0 / (eta_c + 1)),
            )
            c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
            c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
            children[i] = c1
            children[min(i + 1, pop_size - 1)] = c2
        # polynomial mutation
        mut = rng.random(children.shape) < (1.0 / D)
        u = rng.random(children.shape)
        delta = np.where(
            u < 0.5,
            (2 * u) ** (1.0 / (eta_m + 1)) - 1.0,
            1.0 - (2 * (1 - u)) ** (1.0 / (eta_m + 1)),
        )
        children = np.clip(children + mut * delta, 0.0, 1.0)
        Fc = evaluate(children)
        evals += pop_size
        # --- environmental selection -------------------------------------
        allP = np.concatenate([P, children])
        allF = np.concatenate([F, Fc])
        ranks = _fast_non_dominated_sort(allF)
        order = []
        for r in np.unique(ranks):
            idx = np.where(ranks == r)[0]
            if len(order) + len(idx) <= pop_size:
                order.extend(idx.tolist())
            else:
                cd = pareto.crowding_distance(allF[idx])
                take = idx[np.argsort(-cd)][: pop_size - len(order)]
                order.extend(take.tolist())
                break
        P, F = allP[order], allF[order]
        # stopping criterion and trace count only *feasible* first-front
        # points — a bounded task must not stop early (or report frontier
        # sizes) on the strength of cap-violating individuals
        vc = problem.value_constraints
        feas_F = F if vc is None else F[feasible_mask(vc, F)]
        first_front = (feas_F[_fast_non_dominated_sort(feas_F) == 0]
                       if len(feas_F) else feas_F)
        if record_every_gen:
            trace.append((time.perf_counter() - t0, np.nan,
                          len(first_front)))
        if len(np.unique(np.round(first_front, 9), axis=0)) >= n_probes:
            break
    Fo, Xo = _apply_value_constraints(problem, F, snap(P))
    if len(Fo):
        sel = _fast_non_dominated_sort(Fo) == 0
        Fo, Xo = Fo[sel], Xo[sel]
        _, uniq = np.unique(np.round(Fo, 9), axis=0, return_index=True)
        Fo, Xo = Fo[uniq], Xo[uniq]
    el = time.perf_counter() - t0
    return BaselineResult(Fo, Xo, trace, evals, el)
