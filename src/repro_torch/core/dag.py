"""Multi-stage job DAGs: per-stage frontiers composed along precedence
edges (DESIGN.md §8).

The paper tunes each analytic job as one flat MOO problem, but real cloud
jobs are *DAGs of stages*, each with its own configuration subspace, and
the follow-up work (arXiv:2403.00995 per-stage Spark tuning,
arXiv:2207.02026 stage-level resource modeling) shows fine-grained
per-stage tuning dominates job-level tuning.  This module is that layer:

* :class:`StageSpec` — one stage: a name plus a declarative
  :class:`~repro_torch.core.task.TaskSpec` (its knob subspace, objectives,
  model).  Signatures stay content-addressed *per stage*, so a recurring
  job re-submitted with fresh closures reuses each stage's compiled
  solver, and identical stages inside one job are solved once.
* :class:`StageFamily` — a parametric stage-model family
  ``model(theta, x)``: every stage of the family shares ONE executor
  program (:class:`FamilySolver`), so PF probes for *all* stages of a job
  run in a single batched device dispatch instead of a Python loop over
  stages.
* :class:`JobDAG` — stages wired by precedence edges, with per-objective
  composition operators: ``"critical_path"`` (series-add, parallel-max —
  latency), ``"sum"`` (total over all stages — cost), ``"max"`` (peak over
  stages — e.g. memory).
* :func:`JobDAG.compose_frontiers` — combines per-stage Pareto frontiers
  along the DAG by series/parallel reduction, re-filtering after every
  pairwise composition through the :class:`FrontierStore` incremental
  dominance pass (the dominator-count kernel with ``use_kernel``).  The
  pairwise compose itself has a CUDA kernel (``kernels.compose``) with a
  plain torch oracle (``kernels.ref.pairwise_compose``); both compose in
  float32, as the reference does.  Exact for series-parallel DAGs; small
  non-SP DAGs fall back to an exact cross-product sweep.
* :func:`solve_dag` — the batched per-stage solve path: per-signature
  deduped PF sessions, probes coalesced across stages into one MOGD (or
  family) dispatch per round via ``coalesce_step``, frontier composition
  at the end.

Composition requires every stage to declare the same objective names in
minimized orientation (``direction="min"``); per-stage value bounds stay
enforced inside each stage's own solve.  Entry points take ``device=None``,
which means ``cuda``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..exec import ParamProgram, ProbeRequest, default_executor
from ..kernels.compose import pairwise_compose_blocked
from ..kernels.platform import resolve_device
from ..kernels.ref import pairwise_compose
from .frontier_store import FrontierStore
from .mogd import COResult, MOGDConfig, single_objective_box
from .problem import SpaceEncoder, VariableSpec
from .progressive_frontier import ProgressiveFrontier, coalesce_step
from .task import (
    Objective,
    Preference,
    TaskSpec,
    UtopiaNearest,
    _fingerprint,
    as_problem,
)

COMPOSE_OPS = ("critical_path", "sum", "max")


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One DAG stage: a named, declarative tuning subproblem.

    ``family``/``theta`` are set when the stage was built from a
    :class:`StageFamily`; the DAG solver then batches its probes with
    every sibling stage into one dispatch.
    """

    name: str
    task: TaskSpec
    family: "StageFamily | None" = None
    theta: tuple | None = None

    def __post_init__(self):
        """Check the task and normalize theta to a tuple of floats."""
        if not isinstance(self.task, TaskSpec):
            raise TypeError(f"stage {self.name!r}: task must be a TaskSpec")
        if self.theta is not None:
            object.__setattr__(self, "theta",
                               tuple(float(t) for t in np.asarray(
                                   self.theta).reshape(-1)))

    def signature(self) -> str:
        """Content-addressed per-stage identity (= the task's)."""
        return self.task.signature()


class StageFamily:
    """A parametric stage-model family: ``model(theta, x) -> (k,)`` in
    torch ops, for one point ``x: (D,)`` and a float32 parameter tensor
    ``theta``.

    Stages built via :meth:`stage` differ only in their parameter vector
    ``theta``, so one executor program (:class:`FamilySolver`) serves all
    of them — theta rides along as batched data.  Each stage still gets a
    stable content signature (family model fingerprint + theta), so
    recurring jobs reuse per-stage frontiers and solvers.  ``device``
    (``None`` means ``cuda``) is where the stages' thetas and models live.
    """

    def __init__(self, knobs: Sequence[VariableSpec], objectives: Sequence,
                 model: Callable, name: str = "family", device=None):
        self.knobs = tuple(knobs)
        self.objectives = tuple(
            Objective(o) if isinstance(o, str) else o for o in objectives)
        bad = [o.name for o in self.objectives if o.direction != "min"]
        if bad:
            raise ValueError(
                f"family {name!r}: DAG composition requires minimized "
                f"objectives; {bad} declare direction='max'")
        self.model = model
        self.name = name
        self.device = resolve_device(device)
        self.encoder = SpaceEncoder(self.knobs)
        self._model_fp = hashlib.sha256(
            _fingerprint(model).encode()).hexdigest()

    def stage(self, name: str, theta,
              preference: Preference = UtopiaNearest()) -> StageSpec:
        """One stage of the family with parameters ``theta``."""
        th = np.asarray(theta, dtype=np.float64).reshape(-1)
        tht = torch.tensor(th, dtype=torch.float32, device=self.device)
        fam_model = self.model

        def stage_model(x):
            return fam_model(tht, x)

        task = TaskSpec(
            knobs=self.knobs,
            objectives=self.objectives,
            model=stage_model,
            preference=preference,
            # content identity: family model fingerprint + this theta —
            # fresh closures for equal theta signature equal
            model_id=("stage-family", self.name, self._model_fp,
                      tuple(float(t) for t in th)),
            name=name,
            device=self.device,
        )
        return StageSpec(name=name, task=task, family=self,
                         theta=tuple(float(t) for t in th))


class FamilySolver:
    """Batched MOGD over a :class:`StageFamily`: one executor program,
    per-box theta — the params-as-data path of the
    :class:`~repro_torch.exec.ProbeExecutor`.

    ``solve(boxes, thetas, target)`` descends every (box, multistart)
    problem of *all* stages in one executor dispatch — the DAG
    generalization of the PF-AP cross-rectangle batch (DESIGN.md §8/§10).
    The program structure is the family's model fingerprint, so two
    FamilySolvers over content-equal families (and any MOGD work sharing
    that structure) reuse one program.  Stage value bounds are not
    supported here (stages declaring bounds fall back to their per-stage
    :class:`~repro_torch.core.mogd.MOGDSolver`).  Multistarts come from a
    ``torch.Generator`` seeded with ``config.seed``, through
    :meth:`draw_starts`.  ``device`` (``None`` means ``cuda``) must be the
    family's.
    """

    def __init__(self, family: StageFamily,
                 config: MOGDConfig = MOGDConfig(), executor=None,
                 device=None):
        self.device = resolve_device(device)
        if family.device != self.device:
            raise ValueError(f"family lives on {family.device}, solver "
                             f"asked for {self.device}")
        self.family = family
        self.config = config
        self.executor = (executor if executor is not None
                         else default_executor(self.device))
        self._gen = torch.Generator().manual_seed(int(config.seed))
        self.dispatches = 0
        model = family.model
        self._program = ParamProgram(
            apply=lambda theta, x: model(theta, x),
            params=None,  # per-box thetas ride in each request
            structure=("family", family._model_fp, len(family.objectives)),
        )

    def draw_starts(self, B: int) -> np.ndarray:
        """``(B, multistart, D)`` uniform multistart seeds from this
        solver's own generator."""
        return torch.rand((B, self.config.multistart, self.family.encoder.dim),
                          generator=self._gen).numpy()

    def solve(self, boxes: np.ndarray, thetas: np.ndarray,
              target: int = 0) -> COResult:
        """``boxes: (B, 2, k)`` with per-box stage parameters
        ``thetas: (B, T)`` -> one executor dispatch over all boxes."""
        boxes = np.asarray(boxes, dtype=np.float64)
        if boxes.ndim == 2:
            boxes = boxes[None]
        thetas = np.array(thetas, dtype=np.float64, ndmin=2)  # writable
        if thetas.shape[0] != boxes.shape[0]:
            raise ValueError(
                f"{boxes.shape[0]} boxes but {thetas.shape[0]} thetas")
        B = boxes.shape[0]
        req = ProbeRequest(
            program=self._program,
            encoder=self.family.encoder,
            cfg=self.config,
            x0s=self.draw_starts(B),
            los=boxes[:, 0],
            his=boxes[:, 1],
            targets=np.full((B,), int(target), dtype=np.int32),
            params_b=thetas,
        )
        x, f, feas = self.executor.solve_requests([req])
        self.dispatches += 1
        return COResult(np.asarray(x), np.asarray(f), np.asarray(feas))


class _StageBoundSolver:
    """Per-stage view of a :class:`FamilySolver` with the MOGDSolver
    interface (used for PF initialization's reference-point solves)."""

    def __init__(self, fam_solver: FamilySolver, theta):
        self.fam = fam_solver
        self.theta = np.asarray(theta, dtype=np.float64).reshape(1, -1)

    def solve(self, boxes: np.ndarray, target: int = 0) -> COResult:
        boxes = np.asarray(boxes, dtype=np.float64)
        if boxes.ndim == 2:
            boxes = boxes[None]
        thetas = np.broadcast_to(self.theta,
                                 (boxes.shape[0], self.theta.shape[1]))
        return self.fam.solve(boxes, thetas, target=target)

    def solve_single_objective(self, target: int,
                               bounds: np.ndarray) -> COResult:
        return self.solve(single_objective_box(bounds)[None], target=target)


# ---------------------------------------------------------------------------
# The DAG
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ComposedFrontier:
    """The job-level Pareto set with full provenance: row ``i`` of ``X``
    concatenates every stage's encoded configuration (columns per
    ``slices``), so each composed point decodes back to one concrete
    configuration per stage."""

    F: np.ndarray  # (N, k) composed objective values
    X: np.ndarray  # (N, D_total) per-stage encoded configs, concatenated
    slices: dict  # stage name -> column slice of X
    objective_names: tuple

    def __len__(self) -> int:
        """Number of composed Pareto points."""
        return len(self.F)

    @property
    def utopia(self) -> np.ndarray:
        """Per-objective minimum over the composed frontier."""
        return self.F.min(axis=0)

    @property
    def nadir(self) -> np.ndarray:
        """Per-objective maximum over the composed frontier."""
        return self.F.max(axis=0)


class JobDAG:
    """Stages (TaskSpecs) wired by precedence edges.

    ``compose`` gives one operator per objective: ``"critical_path"``
    (series-add, parallel-max — elapsed time), ``"sum"`` (accumulates over
    every stage — cost), ``"max"`` (peak over stages).  Default:
    critical-path for the first objective, sum for the rest — the paper's
    (latency, cost) pair.
    """

    def __init__(self, stages: Sequence[StageSpec],
                 edges: Sequence[tuple] = (),
                 compose: Sequence[str] | None = None,
                 name: str = "job"):
        stages = tuple(stages)
        if not stages:
            raise ValueError("JobDAG needs at least one stage")
        if not all(isinstance(s, StageSpec) for s in stages):
            raise ValueError("stages must be StageSpecs")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        self.stages = stages
        self.name = name
        self._by_name = {s.name: s for s in stages}
        obj_names = stages[0].task.objective_names
        for s in stages:
            if s.task.objective_names != obj_names:
                raise ValueError(
                    f"stage {s.name!r} declares objectives "
                    f"{s.task.objective_names}, expected {obj_names} — "
                    f"composition needs aligned objectives")
            bad = [o.name for o in s.task.objectives if o.direction != "min"]
            if bad:
                raise ValueError(
                    f"stage {s.name!r}: composition requires minimized "
                    f"objectives; {bad} declare direction='max'")
        self.objective_names = obj_names
        self.k = len(obj_names)
        if compose is None:
            compose = ("critical_path",) + ("sum",) * (self.k - 1)
        compose = tuple(compose)
        if len(compose) != self.k:
            raise ValueError(
                f"{len(compose)} compose ops for {self.k} objectives")
        unknown = [op for op in compose if op not in COMPOSE_OPS]
        if unknown:
            raise ValueError(
                f"unknown compose op(s) {unknown}; valid: {COMPOSE_OPS}")
        self.compose = compose
        self.edges = tuple((str(u), str(v)) for u, v in edges)
        for u, v in self.edges:
            if u not in self._by_name or v not in self._by_name:
                raise ValueError(f"edge ({u!r}, {v!r}) references unknown "
                                 f"stage")
            if u == v:
                raise ValueError(f"self-edge on stage {u!r}")
        self._preds = {s.name: set() for s in stages}
        self._succs = {s.name: set() for s in stages}
        for u, v in self.edges:
            self._preds[v].add(u)
            self._succs[u].add(v)
        self._topo = self._topo_sort()  # raises on cycles
        # per-stage encoded-X column layout (declaration order)
        self.slices, off = {}, 0
        for s in stages:
            d = SpaceEncoder(s.task.knobs).dim
            self.slices[s.name] = slice(off, off + d)
            off += d
        self.dim = off

    # -- structure ---------------------------------------------------------
    @property
    def stage_names(self) -> tuple:
        """Stage names in declaration order."""
        return tuple(s.name for s in self.stages)

    def stage(self, name: str) -> StageSpec:
        """The stage called ``name``."""
        return self._by_name[name]

    def _topo_sort(self) -> tuple:
        indeg = {n: len(p) for n, p in self._preds.items()}
        ready = [s.name for s in self.stages if indeg[s.name] == 0]
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in sorted(self._succs[n]):
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.stages):
            stuck = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(f"JobDAG has a cycle through {stuck}")
        return tuple(order)

    def topo_order(self) -> tuple:
        """Stage names in a topological order of the precedence edges."""
        return self._topo

    def signature(self) -> str:
        """Content-derived job identity: per-stage signatures (content-
        addressed), the precedence structure, and the composition
        operators.  Recurring jobs re-submitted with fresh stage closures
        hash equal."""
        payload = "||".join([
            ",".join(f"{s.name}:{s.signature()}" for s in self.stages),
            ",".join(f"{u}->{v}" for u, v in sorted(self.edges)),
            ",".join(self.compose),
        ])
        return hashlib.sha256(payload.encode()).hexdigest()

    # -- composition semantics --------------------------------------------
    def evaluate(self, stage_vals: dict, xp=np):
        """Compose per-stage objective values into job-level objectives.

        ``stage_vals`` maps stage name -> ``(..., k)`` arrays (leading
        dims broadcast together).  Critical-path objectives use the
        completion-time recursion ``C_v = f_v + max_{u->v} C_u`` (exact
        longest path on any DAG); ``sum``/``max`` accumulate over all
        stages.  Works with numpy or torch (``xp``)."""
        missing = set(self.stage_names) - set(stage_vals)
        if missing:
            raise ValueError(f"missing stage values for {sorted(missing)}")
        outs = []
        for o, op in enumerate(self.compose):
            vs = {n: stage_vals[n][..., o] for n in self.stage_names}
            if op == "sum":
                outs.append(functools.reduce(lambda a, b: a + b,
                                             vs.values()))
            elif op == "max":
                outs.append(functools.reduce(xp.maximum, vs.values()))
            else:  # critical_path
                comp = {}
                for n in self._topo:
                    if self._preds[n]:
                        ready = functools.reduce(
                            xp.maximum,
                            [comp[p] for p in sorted(self._preds[n])])
                        comp[n] = vs[n] + ready
                    else:
                        comp[n] = vs[n]
                outs.append(functools.reduce(
                    xp.maximum, [comp[n] for n in self.stage_names]))
        if xp is torch:
            return torch.stack(outs, dim=-1)
        return xp.stack(outs, axis=-1)

    # -- flattening (the single-space baseline) ---------------------------
    def flatten(self, preference: Preference = UtopiaNearest()) -> TaskSpec:
        """The job as ONE flat TaskSpec over the concatenated stage knob
        spaces — the baseline the paper-era reproduction used, kept for
        comparison.  Its model evaluates every stage on its slice of the
        joint vector and composes with :meth:`evaluate`; it lives on the
        first stage's device."""
        knobs = []
        for s in self.stages:
            for spec in s.task.knobs:
                knobs.append(dataclasses.replace(
                    spec, name=f"{s.name}.{spec.name}"))
        models = {s.name: s.task.model for s in self.stages}
        slices = dict(self.slices)
        dag = self

        def model(x):
            vals = {n: models[n](x[slices[n]]) for n in dag.stage_names}
            return dag.evaluate(vals, xp=torch)

        return TaskSpec(
            knobs=tuple(knobs),
            objectives=tuple(Objective(n) for n in self.objective_names),
            model=model,
            preference=preference,
            model_id=("flatten", self.signature()),
            name=f"{self.name}:flat",
            device=self.stages[0].task.device,
        )

    # -- frontier composition ---------------------------------------------
    def _pair_masks(self, relation: str) -> np.ndarray:
        """Per-objective add-vs-max mask for one pairwise composition."""
        if relation == "series":
            return np.array([op != "max" for op in self.compose])
        return np.array([op == "sum" for op in self.compose])

    def _compose_pair(self, a, b, relation: str, use_kernel: bool,
                      chunk: int, device: torch.device):
        """Compose two partial frontiers ``(F, X_full)`` and Pareto
        re-filter through the FrontierStore incremental dominance pass.

        Both composition paths take float32 inputs on ``device`` and
        compose in float32, as the reference does; the composed rows come
        back as float64 for the store."""
        (Fa, Xa), (Fb, Xb) = a, b
        add_mask = self._pair_masks(relation)
        store = FrontierStore(self.k, self.dim,
                              capacity=max(256, len(Fa) + len(Fb)),
                              use_kernel=use_kernel, device=device)
        Fb_t = torch.as_tensor(Fb, dtype=torch.float32, device=device)
        compose = pairwise_compose_blocked if use_kernel else pairwise_compose
        rows_a = max(1, chunk // max(1, len(Fb)))
        for i0 in range(0, len(Fa), rows_a):
            Fa_blk = torch.as_tensor(Fa[i0: i0 + rows_a], dtype=torch.float32,
                                     device=device)
            Fc = compose(Fa_blk, Fb_t, add_mask).cpu().numpy().astype(
                np.float64)
            ia, jb = np.divmod(np.arange(len(Fc)), len(Fb))
            # stage column sets are disjoint; non-member columns are zero
            Xc = Xa[i0 + ia] + Xb[jb]
            store.add(Fc, Xc)
        return store.frontier()

    def compose_frontiers(self, frontiers: dict, use_kernel: bool = False,
                          chunk: int = 4096,
                          max_combos: int = 200_000,
                          device=None) -> ComposedFrontier:
        """Combine per-stage Pareto frontiers into the job frontier.

        ``frontiers`` maps stage name -> ``(F: (N, k), X: (N, d_stage))``.
        Series-parallel DAGs reduce exactly by pairwise series/parallel
        composition with Pareto re-filtering after every step (the
        intermediate frontiers stay small, so an S-stage job costs a few
        pairwise products instead of the ``prod(N_s)`` cross product).
        Non-SP DAGs fall back to the exact cross-product sweep, guarded by
        ``max_combos``.  ``use_kernel`` routes the pairwise compose and the
        re-filter through the kernels; ``device`` (``None`` means ``cuda``)
        is where both run.
        """
        dev = resolve_device(device)
        missing = set(self.stage_names) - set(frontiers)
        if missing:
            raise ValueError(f"missing frontiers for stages "
                             f"{sorted(missing)}")
        nodes = {}
        for s in self.stages:
            F, X = frontiers[s.name]
            F = np.atleast_2d(np.asarray(F, dtype=np.float64))
            X = np.atleast_2d(np.asarray(X, dtype=np.float64))
            if len(F) == 0:
                raise ValueError(f"stage {s.name!r} has an empty frontier")
            Xf = np.zeros((len(F), self.dim))
            Xf[:, self.slices[s.name]] = X
            nodes[s.name] = (F, Xf)
        preds = {n: set(p) for n, p in self._preds.items()}
        succs = {n: set(p) for n, p in self._succs.items()}

        def merge(u, v, fused):
            """Replace nodes u, v by one fused node named u."""
            nodes[u] = fused
            nodes.pop(v)
            for n in preds.pop(v):
                succs[n].discard(v)
                if n != u:
                    succs[n].add(u)
                    preds[u].add(n)
            for n in succs.pop(v):
                preds[n].discard(v)
                if n != u:
                    preds[n].add(u)
                    succs[u].add(n)
            succs[u].discard(u)
            preds[u].discard(u)

        def compose_pair(u, v, relation):
            return self._compose_pair(nodes[u], nodes[v], relation,
                                      use_kernel, chunk, dev)

        while len(nodes) > 1:
            # series: u -> v where v is u's only successor and u is v's
            # only predecessor
            reduced = False
            for u in list(nodes):
                if len(succs[u]) != 1:
                    continue
                (v,) = succs[u]
                if len(preds[v]) != 1:
                    continue
                merge(u, v, compose_pair(u, v, "series"))
                reduced = True
                break
            if reduced:
                continue
            # parallel: two nodes with identical predecessor and successor
            # sets (covers disconnected components: both sets empty)
            ids = sorted(nodes)
            for i, u in enumerate(ids):
                for v in ids[i + 1:]:
                    if preds[u] == preds[v] and succs[u] == succs[v]:
                        merge(u, v, compose_pair(u, v, "parallel"))
                        reduced = True
                        break
                if reduced:
                    break
            if not reduced:
                # not series-parallel: exact cross-product fallback
                F, X = self._cross_product(frontiers, use_kernel, chunk,
                                           max_combos, dev)
                return ComposedFrontier(F, X, dict(self.slices),
                                        self.objective_names)
        (F, X), = nodes.values()
        return ComposedFrontier(F, X, dict(self.slices),
                                self.objective_names)

    def _cross_product(self, frontiers, use_kernel, chunk, max_combos,
                       device):
        """Exact composition of a general DAG by sweeping the full
        cross-product of per-stage frontier points (guarded)."""
        sizes = [len(frontiers[n][0]) for n in self.stage_names]
        combos = int(np.prod(sizes))
        if combos > max_combos:
            raise ValueError(
                f"non-series-parallel DAG with {combos} frontier "
                f"combinations exceeds max_combos={max_combos}")
        idx = np.stack(np.meshgrid(
            *[np.arange(n) for n in sizes], indexing="ij")).reshape(
            len(sizes), -1)  # (S, C)
        stage_vals = {
            n: np.asarray(frontiers[n][0], dtype=np.float64)[idx[i]]
            for i, n in enumerate(self.stage_names)
        }
        Fc = self.evaluate(stage_vals)  # (C, k)
        Xc = np.zeros((combos, self.dim))
        for i, n in enumerate(self.stage_names):
            Xc[:, self.slices[n]] = np.asarray(frontiers[n][1])[idx[i]]
        store = FrontierStore(self.k, self.dim,
                              capacity=max(256, min(combos, 4096)),
                              use_kernel=use_kernel, device=device)
        for i0 in range(0, combos, chunk):
            store.add(Fc[i0: i0 + chunk], Xc[i0: i0 + chunk])
        return store.frontier()

    def decode(self, x_row: np.ndarray) -> dict:
        """One composed-frontier row -> per-stage raw config dicts."""
        x_row = np.asarray(x_row)
        return {s.name: SpaceEncoder(s.task.knobs).decode(
                    x_row[self.slices[s.name]])
                for s in self.stages}


# ---------------------------------------------------------------------------
# Batched per-stage solve
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DAGResult:
    """Result of :func:`solve_dag`."""

    frontier: ComposedFrontier
    stage_frontiers: dict  # stage name -> (F, X) actually solved
    probes: int  # total probes spent (deduped stages counted once)
    unique_stages: int  # distinct stage signatures solved
    dispatches: int  # coalesced probe dispatches
    elapsed_s: float


def solve_dag(
    dag: JobDAG,
    n_probes_per_stage: int = 24,
    mogd: MOGDConfig = MOGDConfig(),
    grid_l: int = 2,
    batch_rects: int = 4,
    use_kernel: bool = False,
    max_rounds: int = 10_000,
    deadline_s: float | None = None,
    device=None,
) -> DAGResult:
    """Solve every stage's frontier with cross-stage batched probes, then
    compose along the DAG.

    Stages are deduped by content signature (a job whose stages repeat a
    recurring sub-task solves it once).  Each probing round coalesces the
    pending probe cells of *all* stages sharing a solver into one MOGD
    dispatch (``coalesce_step``); stages built from one
    :class:`StageFamily` share a single :class:`FamilySolver`, so the
    whole job probes in one batched dispatch per round.  ``device``
    (``None`` means ``cuda``) must be the stages' device.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    # -- dedupe stages by signature ------------------------------------
    entries: dict[str, dict] = {}  # signature -> solve entry
    stage_of: dict[str, str] = {}  # stage name -> signature
    for s in dag.stages:
        sig = s.signature()
        stage_of[s.name] = sig
        if sig in entries:
            entries[sig]["stages"].append(s.name)
            continue
        problem = as_problem(s.task)
        family = s.family
        if family is not None and problem.value_constraints is not None:
            family = None  # bounds need the per-stage MOGD penalty path
        entries[sig] = {
            "problem": problem, "stages": [s.name],
            "family": family, "theta": s.theta,
        }
    # -- solvers: one FamilySolver per family, else per-problem MOGD ----
    fam_solvers: dict[int, FamilySolver] = {}
    dispatches = 0
    for e in entries.values():
        fam = e["family"]
        if fam is not None:
            if id(fam) not in fam_solvers:
                fam_solvers[id(fam)] = FamilySolver(fam, mogd, device=dev)
            solver = _StageBoundSolver(fam_solvers[id(fam)], e["theta"])
        else:
            solver = e["problem"].solver_for(mogd, device=dev)
        e["engine"] = ProgressiveFrontier(
            e["problem"], mode="AP", mogd=mogd, grid_l=grid_l,
            batch_rects=batch_rects, solver=solver,
            use_kernel=use_kernel, device=dev)
        e["state"] = e["engine"].initialize()
    # -- probing rounds: one dispatch per solver group ------------------
    for _ in range(max_rounds):
        if deadline_s is not None and time.perf_counter() - t0 > deadline_s:
            break
        pending = [
            e for e in entries.values()
            if e["state"].probes < n_probes_per_stage
            and len(e["state"].queue)
        ]
        if not pending:
            break
        groups: dict[object, list] = {}
        for e in pending:
            fam = e["family"]
            key = id(fam) if fam is not None else id(e["engine"].solver)
            groups.setdefault(key, []).append(e)
        progressed = 0
        for group in groups.values():
            fam = group[0]["family"]
            if fam is not None:
                fs = fam_solvers[id(fam)]
                thetas = {id(e["engine"]): np.asarray(e["theta"])
                          for e in group}

                def fam_solve(all_boxes, prepared, _fs=fs, _th=thetas):
                    ths = np.concatenate([
                        np.broadcast_to(_th[id(engine)],
                                        (boxes.shape[0],
                                         len(_th[id(engine)])))
                        for engine, _, _, boxes in prepared])
                    return _fs.solve(all_boxes, ths, target=0)

                solve = fam_solve
            else:
                engine = group[0]["engine"]
                solve = (lambda boxes, _prepared, _e=engine:
                         _e.solver.solve(boxes, target=_e.target))
            n = coalesce_step([(e["engine"], e["state"]) for e in group],
                              solve)
            if n:
                dispatches += 1
                progressed += n
        if not progressed:
            break
    # -- compose --------------------------------------------------------
    stage_frontiers = {
        name: entries[sig]["state"].store.frontier()
        for name, sig in stage_of.items()
    }
    composed = dag.compose_frontiers(stage_frontiers, use_kernel=use_kernel,
                                     device=dev)
    probes = sum(e["state"].probes for e in entries.values())
    return DAGResult(
        frontier=composed,
        stage_frontiers=stage_frontiers,
        probes=probes,
        unique_stages=len(entries),
        dispatches=dispatches,
        elapsed_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Synthetic DAG construction (benchmarks / tests)
# ---------------------------------------------------------------------------


def random_series_parallel_edges(names: Sequence[str], rng) -> tuple:
    """Random series-parallel precedence structure over ``names``.

    Builds an SP graph bottom-up by repeatedly combining two random
    components in series (every sink of A precedes every source of B) or
    in parallel (no new edges).  ``rng`` is a numpy ``Generator``.
    Returns the edge tuple.
    """
    comps = [{"members": [n], "sources": [n], "sinks": [n]}
             for n in names]
    edges = []
    while len(comps) > 1:
        i, j = rng.choice(len(comps), size=2, replace=False)
        a, b = comps[int(i)], comps[int(j)]
        comps = [c for ci, c in enumerate(comps) if ci not in (int(i),
                                                               int(j))]
        if rng.random() < 0.5:  # series: a before b
            edges += [(u, v) for u in a["sinks"] for v in b["sources"]]
            comps.append({"members": a["members"] + b["members"],
                          "sources": a["sources"], "sinks": b["sinks"]})
        else:  # parallel
            comps.append({
                "members": a["members"] + b["members"],
                "sources": a["sources"] + b["sources"],
                "sinks": a["sinks"] + b["sinks"],
            })
    return tuple(edges)


def _analytics_model(theta, x):
    """Latency and cost of one analytics stage (see
    :func:`make_analytics_family`)."""
    work, base, mem_sens, price = theta[0], theta[1], theta[2], theta[3]
    par = x[0]
    mem = 0.1 + 0.8 * x[1]
    latency = work / (0.5 + 7.5 * par) + base + mem_sens * (1.0 - mem)
    cost = price * (0.5 + 7.5 * par) * (0.6 + mem) + 0.05 * work
    return torch.stack([latency, cost])


def make_analytics_family(name: str = "analytics-stage",
                          device=None) -> StageFamily:
    """A Spark-like analytic stage family (benchmarks/examples).

    Two knobs per stage — ``parallelism`` (fraction of the max executor
    count) and ``mem_frac`` — and a 4-parameter theta
    ``(work, base_s, mem_sensitivity, price)``: latency falls with
    parallelism and memory, cost grows with both (the paper's classic
    latency/cost tension, per stage).  ``device=None`` means ``cuda``.
    """
    knobs = (
        VariableSpec("parallelism", "continuous", 0.0, 1.0),
        VariableSpec("mem_frac", "continuous", 0.1, 0.9),
    )
    return StageFamily(knobs, ("latency", "cost"), _analytics_model,
                       name=name, device=device)
