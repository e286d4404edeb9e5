"""Multi-Objective Gradient Descent (MOGD) solver — paper §4.2.

Solves the constrained optimization (CO) problems produced by the
Progressive Frontier:

    x* = argmin_x  F_t(x)   s.t.  C_j^L <= F_j(x) <= C_j^U  for all j,
                                   x in [0,1]^D

via multi-start projected gradient descent on the penalty loss of Eq. 4:

    L(x) = 1{0 <= F̂_t <= 1} · F̂_t(x)^2
         + Σ_j 1{F̂_j < 0 or F̂_j > 1} · [(F̂_j(x) - 1/2)^2 + P]

with F̂_j = (F_j - C_j^L) / (C_j^U - C_j^L).

Device adaptation (DESIGN.md §2, §10): the paper dispatches CO problems to
a multi-threaded solver; here *all* (problems × multi-starts) descend in a
single batched dispatch owned by the :class:`~repro_torch.exec.ProbeExecutor`
— one launch of the fused CUDA descend kernel for MLP surrogates.
:class:`MOGDSolver` is a thin frontend that packages its problem as a
``(structure, params)`` :class:`~repro_torch.exec.ParamProgram` plus per-box
data (boxes, user bounds, uncertainty weights, target index) and hands the
batch to the executor.  Problems sharing a model architecture therefore
share ONE program across solvers, sessions, and model versions.
Subgradients of the non-smooth indicator terms are handled by autograd as
the paper prescribes ("machine learning libraries allow subgradients"),
with JAX's conventions at ties (``kernels.ref.clip``).

Multistart seeds come from a ``torch.Generator`` seeded with
``MOGDConfig.seed``: the numbers differ from the reference's JAX PRNG draws
for the same seed.

Model uncertainty (§4.2.3) enters by replacing F with F̃ = E[F] + α·std[F]
before loss construction (see ``MOOProblem.effective_objectives``; on the
executor path the α vector rides as per-box data).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..exec import ParamProgram, ProbeRequest, closure_program, default_executor
from ..kernels.platform import resolve_device
from .problem import MOOProblem, bound_scales, to_numpy


@dataclasses.dataclass(frozen=True)
class MOGDConfig:
    """MOGD hyperparameters (hashable: part of the executor's structure)."""

    steps: int = 120
    lr: float = 0.1
    multistart: int = 16
    penalty: float = 100.0  # P in Eq. 4
    feas_tol: float = 1e-4  # relative slack when checking box feasibility
    alpha: float = 0.0  # uncertainty weight: F̃ = E[F] + alpha * std[F]
    # Tie-break regularizer: adds eps * Σ_{j≠t} clip(F̂_j,0,1)^2 so that when
    # the target-objective minimizer is non-unique the solver lands on the
    # Pareto-optimal representative (Prop. 3.1 assumes uniqueness; learned
    # models can be flat in knobs an objective ignores).  eps is small enough
    # never to trade target-objective value for it.
    tie_break_eps: float = 1e-4
    # Cosine LR decay floor (fraction of lr); improves landing precision on
    # tight constraint boxes.
    lr_floor: float = 0.05
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    seed: int = 0


@dataclasses.dataclass
class COResult:
    """Batched result of solving B constrained-optimization problems."""

    x: np.ndarray  # (B, D) snapped encoded configurations
    f: np.ndarray  # (B, k) objective values at x
    feasible: np.ndarray  # (B,) bool — Prop 3.3: probe may return nothing


def single_objective_box(bounds: np.ndarray) -> np.ndarray:
    """Constraint box for an unconstrained single-objective reference solve
    (Def 3.4): the global objective bounds *widened downward* by one full
    span — sampled bounds under-estimate the achievable minimum, and an
    over-tight lower edge would make the true optimum look infeasible."""
    bounds = np.asarray(bounds, dtype=np.float64)
    span = np.maximum(bounds[1] - bounds[0], 1e-12)
    return np.stack([bounds[0] - span, bounds[1]])


def _user_bound_arrays(problem: MOOProblem):
    """Per-objective hard-bound arrays ``(ulo, uhi, uscale)`` as ``(k,)``
    numpy rows, or None.

    ``uscale`` normalizes the violation penalty and tolerance; it is the
    shared :func:`~repro_torch.core.problem.bound_scales` scale, so MOGD,
    the frontier store, and the baselines judge near-cap points
    identically."""
    vc = problem.value_constraints
    if vc is None:
        return None
    vc = np.asarray(vc, dtype=np.float64).reshape(problem.k, 2)
    if not np.any(np.isfinite(vc)):
        return None
    scale = bound_scales(vc)
    return vc[:, 0], vc[:, 1], scale


class MOGDSolver:
    """Batched MOGD over a fixed :class:`MOOProblem` — a thin frontend
    over the :class:`~repro_torch.exec.ProbeExecutor`.

    The solver packages its problem once as a ``(structure, params)``
    program: problems sharing a model architecture (e.g. many workloads
    served by one MLP family, or one workload across model versions)
    share a single compiled executor program, with this problem's weights
    riding as data.  Solvers whose :meth:`dispatch_key` matches can be
    batched into ONE device dispatch via :func:`solve_grouped` — the
    multi-tenant coalescing primitive behind ``MOOService.step_all``.

    When the problem carries user value constraints (a TaskSpec objective
    ``bound``), every CO solve additionally penalizes bound violations and
    reports bound-infeasible results as infeasible — a declared budget cap
    is enforced at the solver, not filtered after the fact.  Bounds ride
    as per-box data (±inf = open edge), so bounded and unbounded tenants
    still share one compiled program.

    ``device`` (``None`` means ``cuda``) must be the problem's device; the
    default executor is that device's.
    """

    def __init__(self, problem: MOOProblem, config: MOGDConfig = MOGDConfig(),
                 executor=None, split_params: bool = True, device=None):
        self.device = resolve_device(device)
        if problem.device != self.device:
            raise ValueError(f"problem lives on {problem.device}, solver "
                             f"asked for {self.device}")
        self.problem = problem
        self.config = config
        self.executor = (executor if executor is not None
                         else default_executor(self.device))
        if self.executor.device != self.device:
            raise ValueError(f"executor runs on {self.executor.device}, "
                             f"solver on {self.device}")
        # split_params=False forces the opaque-closure program (one
        # structure per problem content) — the pre-executor dispatch
        # behavior, kept as the benchmark baseline and an escape hatch.
        self.split_params = split_params
        self._gen = torch.Generator().manual_seed(int(config.seed))
        self._program: ParamProgram | None = None
        self._dispatch_key: tuple | None = None
        self._use_std = False
        self._alphas_vec: np.ndarray | None = None

    # ------------------------------------------------------------------
    def draw_starts(self, B: int) -> np.ndarray:
        """``(B, multistart, D)`` uniform multistart seeds from this
        solver's own generator (per-session determinism)."""
        return torch.rand((B, self.config.multistart, self.problem.dim),
                          generator=self._gen).numpy()

    def _alphas(self) -> np.ndarray:
        a = self.problem.alphas
        if a is not None:
            return np.asarray(a, dtype=np.float64).reshape(self.problem.k)
        return np.full(self.problem.k, float(self.config.alpha))

    def program(self) -> ParamProgram:
        """The problem's effective-objective program (lazy, cached)."""
        if self._program is not None:
            return self._program
        prog = getattr(self.problem, "program", None)
        alphas = self._alphas()
        wants_std = bool(np.any(alphas != 0.0))
        if (self.split_params and prog is not None
                and (not wants_std or prog.apply_std is not None)):
            self._program = prog
            self._use_std = wants_std and prog.apply_std is not None
            self._alphas_vec = alphas
        else:
            # Opaque model: fold uncertainty in exactly as before and key
            # the structure by problem content (never id() when the
            # content is fingerprintable).
            obj = self.problem.effective_objectives(self.config.alpha)
            self._program = closure_program(obj, _problem_token(self.problem))
            self._use_std = False
            self._alphas_vec = alphas
        return self._program

    def dispatch_key(self) -> tuple:
        """The executor structure key: solvers with equal dispatch keys
        batch into one device dispatch (params as data).  Cached — every
        ingredient (program, encoder, config, use_std) is immutable after
        the first call, and the service grouping loop asks per round."""
        if self._dispatch_key is None:
            prog = self.program()
            self._dispatch_key = self.executor.structure_key(
                prog, self.problem.encoder, self.config, self._use_std)
        return self._dispatch_key

    # ------------------------------------------------------------------
    def _request(self, x0s, los, his, target: int) -> ProbeRequest:
        prog = self.program()
        B = int(np.shape(x0s)[0])
        k = self.problem.k
        ub = _user_bound_arrays(self.problem)
        bounds = None
        if ub is not None:
            bounds = tuple(np.broadcast_to(b, (B, k)) for b in ub)
        alphas = (np.broadcast_to(self._alphas_vec, (B, k))
                  if self._use_std else None)
        return ProbeRequest(
            program=prog,
            encoder=self.problem.encoder,
            cfg=self.config,
            x0s=x0s,
            los=np.asarray(los, dtype=np.float64).reshape(B, k),
            his=np.asarray(his, dtype=np.float64).reshape(B, k),
            targets=np.full((B,), int(target), dtype=np.int32),
            bounds=bounds,
            alphas=alphas,
            use_std=self._use_std,
        )

    def solve(self, boxes: np.ndarray, target: int = 0) -> COResult:
        """Solve B CO problems; ``boxes: (B, 2, k)`` rows are (lo, hi)."""
        return solve_grouped([(self, boxes, target)])

    def refine(self, x0s: np.ndarray, box: np.ndarray, target: int = 0):
        """Descend from given starts (reference-solver elite refinement).

        ``x0s: (B, D)``; ``box: (2, k)``. Returns (x, f, feasible) arrays.
        """
        x0s = to_numpy(x0s, np.float64)
        B = x0s.shape[0]
        lo = np.broadcast_to(np.asarray(box[0]), (B, len(box[0])))
        hi = np.broadcast_to(np.asarray(box[1]), (B, len(box[1])))
        req = self._request(x0s[:, None, :], lo, hi, target)
        x, f, feas = self.executor.solve_requests([req])
        return x, f, feas

    def solve_single_objective(self, target: int, bounds: np.ndarray) -> COResult:
        """Unconstrained single-objective min (reference points, Def 3.4);
        see :func:`single_objective_box` for the widening rationale."""
        return self.solve(single_objective_box(bounds)[None], target=target)


def solve_grouped(items, origin: str | None = None,
                  parent_span=None) -> COResult:
    """One shared executor dispatch over many solvers' box spans.

    ``items`` is a list of ``(solver: MOGDSolver, boxes: (B, 2, k),
    target: int)`` whose solvers share one :meth:`MOGDSolver.dispatch_key`
    (and executor).  Each solver draws its own multistart seeds from its
    own RNG stream — per-session determinism is preserved — and its
    problem's params/bounds/targets ride as per-box data in the single
    concatenated batch.  This is the multi-tenant coalescing primitive
    the service's coalesced step dispatches through (DESIGN.md §10);
    ``origin`` tags the dispatch in executor telemetry (``"frontdesk"``
    for admission-plane traffic) and ``parent_span`` (when tracing)
    parents the executor's compile/dispatch spans — it is only forwarded
    when set, so executor stand-ins with the legacy two-argument
    ``solve_requests`` signature keep working.
    """
    executor = items[0][0].executor
    requests = []
    for solver, boxes, target in items:
        if solver.executor is not executor:
            raise ValueError(
                "solve_grouped items mix ProbeExecutor instances — a "
                "group must share one dispatch plane (telemetry and mesh "
                "config live per executor)")
        boxes = np.asarray(boxes, dtype=np.float64)
        if boxes.ndim == 2:
            boxes = boxes[None]
        x0s = solver.draw_starts(boxes.shape[0])
        requests.append(
            solver._request(x0s, boxes[:, 0], boxes[:, 1], target))
    if parent_span is not None:
        x, f, feas = executor.solve_requests(requests, origin=origin,
                                             parent_span=parent_span)
    else:
        x, f, feas = executor.solve_requests(requests, origin=origin)
    return COResult(np.asarray(x), np.asarray(f), np.asarray(feas))


def _problem_token(problem: MOOProblem):
    """Content token for an opaque problem's program structure.

    Prefers the TaskSpec signature stamped by ``TaskSpec.compile``; falls
    back to fingerprinting the objective callables, and only as a last
    resort to a process-unique token (per-problem compilation — exactly
    the pre-executor behavior for unfingerprintable models)."""
    tok = getattr(problem, "_structure_token", None)
    if tok is not None:
        return tok
    sig = getattr(problem, "signature", None)
    if isinstance(sig, str):
        tok = ("sig", sig)
    else:
        try:
            from .task import _fingerprint

            tok = ("fp", _fingerprint(
                (problem.objectives, problem.objective_stds,
                 None if problem.alphas is None
                 else np.asarray(problem.alphas))))
        except TypeError:
            # a fresh object() is unique and hashable, and the token is
            # kept alive on the problem itself, so it can never collide
            tok = ("uid", object())
    problem._structure_token = tok
    return tok


# ---------------------------------------------------------------------------
# Reference solver (Knitro stand-in, DESIGN.md §6): dense random multistart
# + elite gradient refinement.  Slow but model-agnostic; used by PF-S.
# ---------------------------------------------------------------------------


def grid_reference_solve(
    problem: MOOProblem,
    box: np.ndarray,
    target: int = 0,
    n_samples: int = 20000,
    n_refine: int = 64,
    refine_steps: int = 300,
    seed: int = 0,
):
    """Solve one CO problem by brute force.  ``box: (2, k)``.  Samples
    come from a ``torch.Generator`` seeded with ``seed``; the refinement
    runs on the problem's device."""
    X = problem.sample(torch.Generator().manual_seed(int(seed)), n_samples)
    X = problem.encoder.snap(X)
    F = to_numpy(problem.evaluate_batch(X))
    lo, hi = box[0], box[1]
    width = np.maximum(hi - lo, 1e-12)
    fhat = (F - lo) / width
    feas = np.all((fhat >= -1e-9) & (fhat <= 1 + 1e-9), axis=1)
    if not feas.any():
        elite_idx = np.argsort(np.abs(fhat - 0.5).max(1))[:n_refine]
    else:
        score = np.where(feas, F[:, target], np.inf)
        elite_idx = np.argsort(score)[:n_refine]
    # Elite refinement with the MOGD machinery (high budget).
    cfg = MOGDConfig(steps=refine_steps, multistart=1, lr=0.02, seed=seed)
    solver = MOGDSolver(problem, cfg, device=problem.device)
    x, f, fs = solver.refine(to_numpy(X)[elite_idx], np.stack([lo, hi]),
                             target=target)
    score = np.where(fs, f[:, target], np.inf)
    b = int(np.argmin(score))
    return COResult(x[b : b + 1], f[b : b + 1], fs[b : b + 1])


def estimate_objective_bounds(
    problem: MOOProblem, n: int = 4096, seed: int = 0, margin: float = 0.05
) -> np.ndarray:
    """Estimate global objective bounds by snapped random sampling.

    Returns ``(2, k)`` [lo, hi] with a relative margin.  Used to normalize
    reference-point solves when the user gave no value constraints.
    Samples come from a ``torch.Generator`` seeded with ``seed``.
    """
    X = problem.encoder.snap(
        problem.sample(torch.Generator().manual_seed(int(seed)), n))
    F = to_numpy(problem.evaluate_batch(X))
    F = F[np.all(np.isfinite(F), axis=1)]
    lo, hi = F.min(0), F.max(0)
    span = np.maximum(hi - lo, 1e-12)
    return np.stack([lo - margin * span, hi + margin * span])
