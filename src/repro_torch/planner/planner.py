"""The planning entry point: Progressive Frontier over execution plans.

``plan_job(arch, shape)`` builds the declarative :class:`TaskSpec` (plan
knobs x analytic or surrogate models, objectives with optional hard value
bounds, a typed preference policy), compiles it into the MOOProblem, runs
PF-AP (the paper's parallel approximate algorithm), and recommends a plan
via the spec's preference — returning both the recommendation and the
whole Pareto frontier (latency/cost/energy).  The compiled-solver cache is
keyed by ``TaskSpec.signature()`` and the device, so recurring planning
jobs re-submitted with fresh model closures reuse their solver, and a
host problem and a card problem never share one.

``replan_elastic`` is the paper's serverless/auto-scaling use case mapped
to accelerator fleets: after a node failure or resize, re-run PF against
the surviving chip counts under a strict deadline and return a fresh plan
in seconds.  The PF state is resumable, so repeated replans extend the
same frontier instead of recomputing it (the paper's incrementality
argument).

Every entry point takes ``device=None`` (meaning ``cuda``): the plan
model's objective closure runs there, under the executor's
``torch.func.vmap``/``grad`` (no read-back, no branch on a value).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import (
    JobDAG,
    MOGDConfig,
    Objective,
    Preference,
    ProgressiveFrontier,
    TaskSpec,
    WeightedUtopiaNearest,
    solve_dag,
)
from ..core.problem import SpaceEncoder, categorical
from ..kernels.platform import resolve_device
from ..launch.plans import Plan
from ..nn import SHAPES, ArchConfig, ShapeSpec
from .cost_model import PlanModel
from .space import decode_plan, plan_space

_CANON_CHIPS = (64, 128, 256, 512)


@dataclasses.dataclass
class JobPlanRecommendation:
    """Recommendation for a multi-stage job: one config per stage plus the
    composed job-level frontier (latency over the critical path, cost over
    all stages — the DAG's compose operators)."""

    stage_configs: dict           # stage name -> raw knob dict
    objectives: np.ndarray        # (k,) composed values of the pick
    frontier_F: np.ndarray        # (N, k) composed Pareto frontier
    frontier_X: np.ndarray        # (N, D_total) per-stage encoded configs
    stage_frontiers: dict         # stage name -> (F, X) per-stage frontier
    probes: int                   # total probes spent (deduped stages)
    elapsed_s: float


def plan_dag(dag: JobDAG,
             n_probes_per_stage: int = 24,
             preference: Preference | None = None,
             mogd: MOGDConfig = MOGDConfig(steps=80, multistart=8),
             grid_l: int = 2,
             batch_rects: int = 4,
             use_kernel: bool = False,
             deadline_s: float | None = None,
             device=None) -> JobPlanRecommendation:
    """Plan a multi-stage job: batched per-stage Progressive Frontier,
    DAG frontier composition, then one preference pick on the *composed*
    frontier — returning the per-stage configurations that realize it.
    With ``use_kernel`` the stores and the composition run the dominance
    and compose kernels on the card."""
    t0 = time.perf_counter()
    res = solve_dag(dag, n_probes_per_stage=n_probes_per_stage, mogd=mogd,
                    grid_l=grid_l, batch_rects=batch_rects,
                    use_kernel=use_kernel, deadline_s=deadline_s,
                    device=device)
    comp = res.frontier
    pref = preference or WeightedUtopiaNearest((0.5,) * dag.k)
    i = pref.pick(comp.F, comp.utopia, comp.nadir)
    return JobPlanRecommendation(
        stage_configs=dag.decode(comp.X[i]),
        objectives=np.asarray(comp.F[i]),
        frontier_F=np.asarray(comp.F),
        frontier_X=np.asarray(comp.X),
        stage_frontiers=res.stage_frontiers,
        probes=res.probes,
        elapsed_s=time.perf_counter() - t0,
    )


@dataclasses.dataclass
class PlanRecommendation:
    plan: Plan
    num_chips: int
    model_parallel: int
    objectives: np.ndarray        # (latency_s, cost_$, energy)
    frontier_F: np.ndarray
    frontier_plans: list
    elapsed_s: float
    pf_state: object              # resumable


def plan_task(cfg: ArchConfig, shape: ShapeSpec,
              model: PlanModel | None = None,
              objectives=("latency", "cost"),
              chip_choices=None,
              objective_bounds: dict | None = None,
              preference: Preference | None = None,
              shape_name: str = "",
              device=None) -> tuple[TaskSpec, PlanModel]:
    """Build the declarative TaskSpec for one planning job.

    ``objective_bounds`` maps objective name -> (low, high) hard value
    constraints (e.g. ``{"cost": (None, 120.0)}`` for a budget cap); bounds
    are enforced by MOGD and the frontier store, not merely reported.  The
    spec's ``model_id`` encodes arch/shape/objectives/chips/calibration and
    the fleet, so a recurring planning job re-submitted later signatures
    equal and reuses the compiled solver.  The spec lives on ``device``."""
    dev = resolve_device(device)
    model = model or PlanModel(cfg, shape)
    specs = plan_space()
    if chip_choices is not None:
        # elastic replan: restrict the chip knob to the surviving sizes
        specs[0] = categorical("num_chips", tuple(chip_choices))
    idx = {"latency": 0, "cost": 1, "energy": 2}
    sel = torch.as_tensor([idx[o] for o in objectives], device=dev)

    enc = SpaceEncoder(specs)
    choices = [float(ch) for ch in (chip_choices or _CANON_CHIPS)]
    proj = None
    if len(choices) != len(_CANON_CHIPS):
        # re-express restricted chip weights over the canonical choices:
        # a constant matrix on the device, built once outside the traced
        # objective
        proj = torch.as_tensor(
            np.array(choices)[:, None] == np.array(_CANON_CHIPS,
                                                   dtype=np.float64)[None, :],
            dtype=torch.float32, device=dev)

    def obj(x):
        soft = dict(enc.decode_soft(x))
        if proj is not None:
            soft["num_chips"] = soft["num_chips"] @ proj
        return model.objectives(soft)[sel]

    bounds = objective_bounds or {}
    unknown = set(bounds) - set(objectives)
    if unknown:
        raise ValueError(f"objective_bounds for unknown objectives "
                         f"{sorted(unknown)}; declared: {objectives}")
    objs = tuple(Objective(o, bound=bounds.get(o)) for o in objectives)
    spec = TaskSpec(
        knobs=tuple(specs),
        objectives=objs,
        model=obj,
        preference=preference or WeightedUtopiaNearest((0.5,) * len(objs)),
        # stable content id: recurring jobs (same arch/shape/objectives/
        # chips/calibration/fleet) signature equal across fresh closures
        model_id=("plan", cfg.name, shape_name, tuple(objectives),
                  tuple(chip_choices) if chip_choices else None,
                  round(model.cal_compute, 6), round(model.cal_memory, 6),
                  round(model.cal_collective, 6),
                  dataclasses.astuple(model.fleet)),
        name=f"plan:{cfg.name}:{shape_name}",
        device=dev,
    )
    return spec, model


# Compiled-solver cache keyed by (TaskSpec.signature(), device, mogd,
# grid_l, batch_rects): recurring planning sessions (the paper's setting)
# reuse the solver across plan_job calls for the same task.  The device is
# part of the key (the signature holds it too), so a host problem and a
# card problem never share a solver.
_PF_CACHE: dict = {}


def plan_job(arch_cfg: ArchConfig, shape_name: str = "train_4k",
             objectives=("latency", "cost"),
             weights=(0.5, 0.5),
             n_probes: int = 24,
             deadline_s: float | None = 2.5,
             model: PlanModel | None = None,
             chip_choices=None,
             mogd: MOGDConfig = MOGDConfig(steps=80, multistart=8),
             grid_l: int = 2,
             batch_rects: int = 4,
             state=None,
             objective_bounds: dict | None = None,
             preference: Preference | None = None,
             task: TaskSpec | None = None,
             device=None) -> PlanRecommendation:
    """Plan a job by Progressive Frontier over the declarative task spec.

    ``task`` overrides the internally-built spec; ``preference`` is the
    typed §5 policy (``weights`` remains as a shim building a
    WeightedUtopiaNearest); ``objective_bounds`` declares hard value caps
    that provably constrain the returned frontier.

    A :class:`~repro_torch.core.dag.JobDAG` may be passed in place of the
    arch config: the job is then planned per stage (batched probes,
    composed frontier) and a :class:`JobPlanRecommendation` is returned.
    ``weights``/``preference``, ``n_probes`` (per stage), ``mogd``,
    ``grid_l``, ``batch_rects`` and ``deadline_s`` apply as usual;
    arch-planning parameters that have no DAG meaning are rejected.

    The frontier store is the host's (``use_kernel=False``), as the
    reference's; the descent runs on ``device``."""
    dev = resolve_device(device)
    if isinstance(arch_cfg, JobDAG):
        inapplicable = {
            "objectives": tuple(objectives) != ("latency", "cost"),
            "model": model is not None,
            "chip_choices": chip_choices is not None,
            "state": state is not None,
            "objective_bounds": objective_bounds is not None,
            "task": task is not None,
        }
        bad = sorted(k for k, v in inapplicable.items() if v)
        if bad:
            raise ValueError(
                f"plan_job(JobDAG): parameter(s) {bad} do not apply to "
                f"DAG planning — the DAG's stages declare objectives, "
                f"models, and bounds")
        if preference is not None:
            pref = preference
        else:
            w = tuple(weights)
            if len(w) != arch_cfg.k:
                if w == (0.5, 0.5):  # untouched default: adapt to k
                    w = (0.5,) * arch_cfg.k
                else:
                    raise ValueError(
                        f"plan_job(JobDAG): {len(w)} weights for "
                        f"{arch_cfg.k} objectives")
            pref = WeightedUtopiaNearest(w)
        return plan_dag(arch_cfg, n_probes_per_stage=n_probes,
                        preference=pref, mogd=mogd, grid_l=grid_l,
                        batch_rects=batch_rects, deadline_s=deadline_s,
                        device=dev)
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    user_task = task is not None
    if task is None:
        task, model = plan_task(arch_cfg, shape, model, objectives,
                                chip_choices, objective_bounds,
                                preference, shape_name, device=dev)
    # preference precedence: explicit policy > caller-supplied task's
    # policy > the legacy `weights` kwarg (shimmed into WUN)
    if preference is not None:
        pref = preference
    elif user_task:
        pref = task.preference
    else:
        pref = WeightedUtopiaNearest(tuple(weights))
    key = (task.signature(), str(dev), mogd, grid_l, batch_rects)
    if key in _PF_CACHE:
        problem, pf = _PF_CACHE[key]
    else:
        problem = task.compile()
        # Cross-rectangle batched PF-AP: every planning iteration solves the
        # cells of the top-`batch_rects` rectangles in one MOGD dispatch.
        pf = ProgressiveFrontier(problem, mode="AP", mogd=mogd,
                                 grid_l=grid_l, batch_rects=batch_rects,
                                 device=dev)
        _PF_CACHE[key] = (problem, pf)
    res = pf.run(n_probes=n_probes, deadline_s=deadline_s, state=state)
    i = pref.pick(res.F, res.utopia, res.nadir)
    raw = problem.encoder.decode(np.asarray(res.X[i]))
    plan, chips, tp = decode_plan(raw)
    plans = [decode_plan(problem.encoder.decode(np.asarray(x)))
             for x in res.X]
    return PlanRecommendation(
        plan=plan, num_chips=chips, model_parallel=tp,
        objectives=np.asarray(res.F[i]),
        frontier_F=np.asarray(res.F),
        frontier_plans=plans,
        elapsed_s=time.perf_counter() - t0,
        pf_state=res.state,
    )


def replan_elastic(arch_cfg: ArchConfig, shape_name: str,
                   surviving_chips: int,
                   weights=(0.5, 0.5),
                   deadline_s: float = 2.5,
                   device=None) -> PlanRecommendation:
    """Elastic event: restrict the chip knob to what survives and replan
    under the deadline (the paper's serverless auto-scaling path)."""
    choices = [c for c in _CANON_CHIPS if c <= surviving_chips]
    if not choices:
        choices = [surviving_chips]
    return plan_job(arch_cfg, shape_name, weights=weights,
                    deadline_s=deadline_s, chip_choices=choices,
                    device=device)
