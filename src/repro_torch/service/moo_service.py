"""MOOService: many concurrent, resumable tuning sessions (DESIGN.md §5).

The paper's deployment setting is a cloud optimizer answering MOO queries
for a stream of recurring analytics jobs.  Three properties matter there
and are implemented here:

* **Sessions** — each tuning job holds one resumable ``PFState`` (rectangle
  queue + incremental frontier store).  More probes extend the same
  frontier; the session survives across requests.
* **Solver amortization** — MOGD solvers are cached by *task signature*:
  :meth:`MOOService.create_session` takes a declarative
  :class:`~repro_torch.core.task.TaskSpec` whose content-derived
  ``signature()`` identifies the task, so a recurring job re-submitted with
  fresh closures (same knobs, same objectives, same model content) attaches
  to the already-compiled problem and solver.  No ``id()`` identity
  anywhere.
* **Probe coalescing** — ``step_all`` gathers the pending probe cells of
  every active session sharing a program structure and solves them in one
  MOGD batch: one device dispatch serves many tenants (the multi-tenant
  generalization of PF-AP's cross-rectangle batch).

The service is thread-safe at the granularity of its public methods (one
re-entrant lock), and the coalesced stepping path releases that lock
around the actual device dispatch: ``step_all``/``step_sessions`` pop
probe cells under the lock, solve them with the lock *released*, then
re-acquire to absorb results — so ``recommend`` and ``stats`` stay
responsive while a MOGD batch is in flight (DESIGN.md §12).

All of a service's work runs on one device (``device=None`` means
``cuda``): its executor's dispatches, its sessions' frontier stores and
its DAG compositions.  Multi-stage jobs (:meth:`create_dag_session`)
compose their stages' frontiers through the pairwise-compose kernel when
``use_kernel`` is set.  Sessions over a model registry's workloads
(:meth:`create_workload_session`, or a DAG's ``workloads``) follow the
registry: a model version bump or a drift event invalidates them, and the
next probe pass warm re-solves them under the new model (DESIGN.md §9).
A service with a ``vault`` (:class:`repro_torch.persist.FrontierVault`)
snapshots its sessions' states there and restores them on a restart
(DESIGN.md §13); :class:`repro_torch.frontdesk.FrontDesk` is the admission
plane in front of it (DESIGN.md §12).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings

import numpy as np

from ..alloc import Candidate
from ..core import MOGDConfig, MOOProblem, ProgressiveFrontier
from ..core.dag import ComposedFrontier, JobDAG
from ..core.mogd import MOGDSolver, solve_grouped
from ..core.progressive_frontier import (
    PFResult,
    PFState,
    export_pf_state,
    live_seed_points,
)
from ..core.task import Preference, TaskSpec, preference_from_legacy
from ..exec import ProbeExecutor
from ..kernels.platform import resolve_device
from ..obs import Observability

_svc_ids = itertools.count()  # per-instance metric label suffix

ROUND_PHASES = ("prepare_s", "solve_s", "absorb_s", "persist_s")


@dataclasses.dataclass
class Recommendation:
    """One configuration picked from a session's live frontier (§5)."""

    session_id: str
    index: int
    objectives: np.ndarray  # (k,)
    x: np.ndarray  # (D,) encoded
    config: dict  # decoded knob values
    frontier_size: int


@dataclasses.dataclass
class SessionInfo:
    """Read-only session snapshot for dashboards / tests."""

    session_id: str
    signature: tuple
    mode: str
    probes: int
    frontier_size: int
    uncertain_fraction: float
    exhausted: bool  # queue empty — frontier is final
    elapsed_s: float
    workload: str | None = None  # registry workload sig being watched
    stale: bool = False  # invalidated; warm re-solve pending


@dataclasses.dataclass
class DagRecommendation:
    """One per-stage configuration set picked from a DAG session's
    composed frontier."""

    dag_id: str
    index: int
    objectives: np.ndarray  # (k,) composed job-level values
    stage_configs: dict  # stage name -> decoded knob dict
    frontier_size: int


@dataclasses.dataclass
class _DagSession:
    """A multi-stage job session: the DAG plus its per-stage child
    sessions (deduped by stage signature)."""

    dag_id: str
    dag: JobDAG
    stage_sids: dict  # stage name -> child session id
    created_s: float = dataclasses.field(default_factory=time.perf_counter)


@dataclasses.dataclass
class _Session:
    session_id: str
    problem: MOOProblem
    signature: tuple
    engine: ProgressiveFrontier
    solver_key: tuple  # (signature, mogd) entry in the service solver cache
    spec: TaskSpec
    state: PFState | None = None
    # model-server subscription (None for plain sessions): on a version
    # bump or drift event for ``workload`` the session is marked stale and
    # warm re-solved from ``registry.task_spec(workload)`` at the next
    # probe/step — never on the recommend path.
    registry: object | None = None
    workload: str | None = None
    stale: bool = False
    # durable-vault bookkeeping (DESIGN.md §13): the probe count at the
    # last vault snapshot — persistence triggers fire only on progress
    probes_at_snapshot: int = 0
    # budget-plane telemetry (DESIGN.md §15): EMA of hypervolume delta
    # per probe across absorbs, and rounds since the policy last gave
    # this session a non-zero allocation (the staleness feature)
    gain_ema: float = 0.0
    rounds_idle: int = 0
    created_s: float = dataclasses.field(default_factory=time.perf_counter)


class MOOService:
    """A long-lived, multi-tenant Progressive Frontier optimizer on one
    device (``device=None`` means ``cuda``)."""

    def __init__(
        self,
        mogd: MOGDConfig = MOGDConfig(steps=80, multistart=8),
        mode: str = "AP",
        grid_l: int = 2,
        batch_rects: int = 4,
        max_sessions: int = 256,
        max_cached_tasks: int = 512,
        use_kernel: bool = False,
        executor: ProbeExecutor | None = None,
        structure_coalescing: bool = True,
        vault=None,
        vault_autosave_probes: int = 64,
        obs: Observability | None = None,
        budget_policy=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.default_mogd = mogd
        self.default_mode = mode
        self.default_grid_l = grid_l
        self.default_batch_rects = batch_rects
        self.max_sessions = max_sessions
        self.max_cached_tasks = max_cached_tasks
        self.use_kernel = use_kernel
        # one observability bundle for the whole request path (DESIGN.md
        # §14): an executor the service constructs shares it, so metrics
        # land in one registry and spans in one tracer
        self.obs = obs if obs is not None else Observability()
        # The service's dispatch plane (DESIGN.md §10): ALL MOGD work of
        # every session goes through this one executor, so built programs
        # — and their build-count telemetry — are shared service-wide.
        self.executor = (executor if executor is not None
                         else ProbeExecutor(obs=self.obs, device=self.device))
        if self.executor.device != self.device:
            raise ValueError(f"executor runs on {self.executor.device}, "
                             f"service on {self.device}")
        # structure_coalescing=False restores the legacy per-tenant
        # dispatch (group by exact solver identity, opaque closures) —
        # kept as the benchmark baseline.
        self.structure_coalescing = structure_coalescing
        self._sessions: dict[str, _Session] = {}
        self._dags: dict[str, _DagSession] = {}
        # (signature, mogd) -> solver; keeps the problem that built it alive
        self._solvers: dict[tuple, tuple[MOGDSolver, MOOProblem]] = {}
        # TaskSpec.signature() -> compiled MOOProblem: structurally-equal
        # specs share one problem and hence one MOGD solver —
        # content-addressed, never id()-keyed.
        self._problems: dict[tuple, MOOProblem] = {}
        self._ids = itertools.count()
        self._lock = threading.RLock()
        # sessions whose init phase runs now, with the lock released; a
        # round that holds one of them waits on ``_init_done`` for it
        self._initializing: set[str] = set()
        self._init_done = threading.Condition(self._lock)
        # model-server subscriptions: workload sig -> watching session ids
        self._watch: dict[str, set[str]] = {}
        self._registries: list = []
        # typed service counters (DESIGN.md §14) — stats() is a view
        # over the shared registry; the int properties below keep the
        # attribute surface working
        m = self.obs.metrics
        self._labels = {"service": f"svc{next(_svc_ids)}"}
        self._c_solver_cache_hits = m.counter(
            "service.solver_cache_hits", self._labels)
        self._c_problem_cache_hits = m.counter(
            "service.problem_cache_hits", self._labels)
        self._c_coalesced_batches = m.counter(
            "service.coalesced_batches", self._labels)
        self._c_coalesced_probes = m.counter(
            "service.coalesced_probes", self._labels)
        self._c_frontier_invalidations = m.counter(
            "service.frontier_invalidations", self._labels)
        self._c_warm_resolves = m.counter(
            "service.warm_resolves", self._labels)
        # in-flight telemetry (DESIGN.md §12): probe rows currently being
        # solved with the service lock RELEASED — a concurrent stats()
        # call observes them directly.
        self._g_in_flight_probes = m.gauge(
            "service.in_flight_probes", self._labels,
            help="probe rows solving with the service lock released")
        self._g_in_flight_dispatches = m.gauge(
            "service.in_flight_dispatches", self._labels)
        # durable frontier plane (repro_torch.persist.FrontierVault,
        # DESIGN.md §13): session states snapshot to the vault on
        # convergence, on close, and every ``vault_autosave_probes``
        # probes; a cold restart restores exact-signature entries (zero
        # probes to first recommend) or seeds PF from an older version's
        # frontier.
        self.vault = vault
        self.vault_autosave_probes = max(1, int(vault_autosave_probes))
        self._c_vault_restores = m.counter(
            "service.vault_restores", self._labels)
        self._c_vault_seeds = m.counter(
            "service.vault_seeds", self._labels)
        self._c_vault_snapshots = m.counter(
            "service.vault_snapshots", self._labels)
        self._c_vault_tombstones = m.counter(
            "service.vault_tombstones", self._labels)
        # per-phase round timing (perf_counter seconds; always measured,
        # tracing on or off — a front desk's latency attribution divides
        # each ticket's round wall by these proportions)
        self._h_round = {
            p: m.histogram(f"service.round_{p}", self._labels)
            for p in ROUND_PHASES}
        # probe-budget allocation plane (repro_torch.alloc, DESIGN.md
        # §15): None keeps the legacy uniform schedule with zero policy
        # calls on the hot path; the counters make the policy's spending
        # auditable — rects it granted vs rects the legacy schedule would
        # have spent
        self.budget_policy = budget_policy
        self._c_budget_rounds = m.counter(
            "service.budget_rounds", self._labels)
        self._c_budget_rects_granted = m.counter(
            "service.budget_rects_granted", self._labels)
        self._c_budget_rects_legacy = m.counter(
            "service.budget_rects_legacy", self._labels)
        self._h_hv_gain = m.histogram(
            "service.hv_gain", self._labels,
            help="normalized hypervolume delta per absorbed batch")

    # -- int counter surface (views over the registry) ------------------
    @property
    def solver_cache_hits(self) -> int:
        """Sessions that reused a cached MOGD solver."""
        return int(self._c_solver_cache_hits.value)

    @property
    def problem_cache_hits(self) -> int:
        """Sessions that reused a compiled problem."""
        return int(self._c_problem_cache_hits.value)

    @property
    def coalesced_batches(self) -> int:
        """Coalesced probe dispatches solved by the stepping path."""
        return int(self._c_coalesced_batches.value)

    @property
    def coalesced_probes(self) -> int:
        """Probe rows solved by coalesced dispatches."""
        return int(self._c_coalesced_probes.value)

    @property
    def frontier_invalidations(self) -> int:
        """Sessions invalidated by registry events (or a missed one)."""
        return int(self._c_frontier_invalidations.value)

    @property
    def warm_resolves(self) -> int:
        """Stale sessions rebuilt under a newer model version."""
        return int(self._c_warm_resolves.value)

    @property
    def in_flight_probes(self) -> int:
        """Probe rows solving now, with the service lock released."""
        return int(self._g_in_flight_probes.value)

    @property
    def in_flight_dispatches(self) -> int:
        """Dispatches solving now, with the service lock released."""
        return int(self._g_in_flight_dispatches.value)

    @property
    def vault_restores(self) -> int:
        """Sessions restored whole from an exact-signature vault entry."""
        return int(self._c_vault_restores.value)

    @property
    def vault_seeds(self) -> int:
        """Workload sessions seeded from an older version's entry."""
        return int(self._c_vault_seeds.value)

    @property
    def vault_snapshots(self) -> int:
        """Session states handed to the vault."""
        return int(self._c_vault_snapshots.value)

    @property
    def vault_tombstones(self) -> int:
        """Vault entries killed by drift events."""
        return int(self._c_vault_tombstones.value)

    # ------------------------------------------------------------------
    def _solver_for(self, problem: MOOProblem, signature: tuple,
                    mogd: MOGDConfig) -> MOGDSolver:
        key = (signature, mogd)
        if key in self._solvers:
            self._c_solver_cache_hits.inc()
            return self._solvers[key][0]
        # solvers are thin frontends over the service executor: a new
        # solver whose problem shares a program structure with earlier
        # work reuses the already-built executor program
        solver = MOGDSolver(problem, mogd, executor=self.executor,
                            split_params=self.structure_coalescing,
                            device=self.device)
        self._solvers[key] = (solver, problem)
        return solver

    def create_session(
        self,
        spec: TaskSpec,
        mode: str | None = None,
        mogd: MOGDConfig | None = None,
        grid_l: int | None = None,
        batch_rects: int | None = None,
        target: int = 0,
    ) -> str:
        """The declarative front door: register a tuning session for a
        :class:`TaskSpec` on the service's device.  Compilation is
        content-addressed — a spec whose ``signature()`` matches an earlier
        submission (a recurring job re-submitted with fresh closures)
        reuses the already-compiled problem and MOGD solver.  Lazy: no
        solve work happens until the first ``probe``/``step_all``."""
        if not isinstance(spec, TaskSpec):
            raise TypeError(
                f"create_session expects a TaskSpec, got "
                f"{type(spec).__name__}; wrap raw problems with "
                f"TaskSpec.from_problem()")
        with self._lock:
            sig = (spec.signature(),)
            problem = self._compile_cached(spec, sig)
            sid = self._open(problem, sig, spec=spec,
                             mode=mode, mogd=mogd, grid_l=grid_l,
                             batch_rects=batch_rects, target=target)
            # durable warm restart (DESIGN.md §13): an exact-signature
            # vault entry restores the full PF state — frontier, pareto
            # mask, rectangle queue — so recommend serves with ZERO new
            # probe dispatches
            self._try_restore_locked(self._sessions[sid])
            self._evict_cold_tasks()  # after _open: new session counts live
            return sid

    def _try_restore_locked(self, sess: _Session) -> bool:
        """Exact-signature restore from the vault (lock held).  The store
        is rebuilt on the service's device with its kernel routing
        (``FrontierStore.from_state``), its rows, mask and counters as
        they were written."""
        if self.vault is None or sess.state is not None:
            return False
        try:
            got = self.vault.get_frontier(sess.signature[0])
            if got is None:
                return False
            arrays, meta = got
            state = sess.engine.import_state(arrays, meta)
        except Exception as e:  # corrupt/incompatible entry: a restart
            # must still work — fall through to the cold-solve path
            warnings.warn(f"vault restore failed for {sess.session_id}: "
                          f"{e}", RuntimeWarning, stacklevel=2)
            return False
        sess.state = state
        sess.probes_at_snapshot = state.probes
        self._c_vault_restores.inc()
        return True

    def _vault_identity(self, sess: _Session) -> tuple:
        """The ``(workload, version)`` components a vault entry's manifest
        carries for invalidation / seed-donor scans (None for plain
        sessions)."""
        mid = sess.spec.model_id if sess.spec is not None else None
        if (sess.workload is not None and isinstance(mid, tuple)
                and len(mid) == 3 and mid[0] == "modelserver"):
            return sess.workload, int(mid[2])
        return sess.workload, None

    def _persist_session_locked(self, sess: _Session, reason: str) -> bool:
        """Export a session's PF state and enqueue a write-behind vault
        put (lock held; the export copies host arrays, the disk write
        happens on the vault's writer thread).  Stale sessions and empty
        frontiers are never persisted."""
        if (self.vault is None or sess.state is None or sess.stale
                or sess.state.store.n_points == 0):
            return False
        arrays, meta = export_pf_state(sess.state)
        meta["reason"] = reason
        workload, version = self._vault_identity(sess)
        ok = self.vault.put_frontier(
            sess.signature[0], arrays, meta,
            workload=workload, version=version)
        if ok:
            sess.probes_at_snapshot = sess.state.probes
            self._c_vault_snapshots.inc()
        return ok

    def _compile_cached(self, spec: TaskSpec, sig: tuple) -> MOOProblem:
        """Signature-keyed compile-or-reuse (LRU re-insertion on hit)."""
        problem = self._problems.pop(sig, None)  # re-insert as newest
        if problem is None:
            problem = spec.compile()
        else:
            self._c_problem_cache_hits.inc()
        self._problems[sig] = problem
        return problem

    def _evict_cold_tasks(self) -> None:
        """Keep at most ``max_cached_tasks`` warm problems: recurring jobs
        stay compiled across close/re-open, but a stream of *distinct*
        specs cannot grow the cache (and its model closures) without
        bound.  Oldest-unreferenced entries — and their solvers — go
        first; signatures with open sessions are never evicted."""
        if len(self._problems) <= self.max_cached_tasks:
            return
        live = {s.signature for s in self._sessions.values()}
        for sig in list(self._problems):  # insertion order = LRU order
            if len(self._problems) <= self.max_cached_tasks:
                break
            if sig in live:
                continue
            self._problems.pop(sig, None)
            for key in [k for k in self._solvers if k[0] == sig]:
                self._solvers.pop(key, None)

    # ------------------------------------------------------------------
    def create_dag_session(
        self,
        dag: JobDAG,
        mode: str | None = None,
        mogd: MOGDConfig | None = None,
        grid_l: int | None = None,
        batch_rects: int | None = None,
        target: int = 0,
        registry=None,
        workloads: dict | None = None,
    ) -> str:
        """Register a multi-stage job: one child session per *distinct*
        stage signature (a job repeating a recurring sub-task tunes it
        once).  Child sessions enter the normal coalescing machinery, so
        ``step_all``/``run_until`` batch a DAG's stage probes — and any
        other tenant's equal-structure probes — into shared MOGD
        dispatches.  Compose/recommend with :meth:`dag_frontier` /
        :meth:`recommend_dag`.

        ``workloads`` maps stage names to ModelRegistry workload
        signatures: those stages' child sessions subscribe to ``registry``
        and are invalidated (then warm re-solved) on model version bumps
        or drift, exactly like :meth:`create_workload_session` sessions —
        a model update to one recurring sub-task refreshes every DAG that
        contains it."""
        if not isinstance(dag, JobDAG):
            raise TypeError(
                f"create_dag_session expects a JobDAG, got "
                f"{type(dag).__name__}")
        workloads = workloads or {}
        if workloads and registry is None:
            raise ValueError("stage workloads require a registry")
        unknown = set(workloads) - set(dag.stage_names)
        if unknown:
            raise ValueError(
                f"workloads name unknown stages {sorted(unknown)}")
        with self._lock:
            by_sig: dict[str, str] = {}
            stage_sids: dict[str, str] = {}
            try:
                for stage in dag.stages:
                    sig = stage.signature()
                    if sig not in by_sig:
                        by_sig[sig] = self.create_session(
                            stage.task, mode=mode, mogd=mogd,
                            grid_l=grid_l, batch_rects=batch_rects,
                            target=target)
                    stage_sids[stage.name] = by_sig[sig]
                for name, wsig in workloads.items():
                    self.watch_workload(stage_sids[name], registry, wsig)
            except Exception:
                # a failing stage must not leak the siblings already
                # registered — the caller has no dag_id to close them with
                for sid in by_sig.values():
                    self.close_session(sid)
                raise
            dag_id = f"dag-{next(self._ids)}"
            self._dags[dag_id] = _DagSession(dag_id, dag, stage_sids)
            return dag_id

    def close_dag_session(self, dag_id: str) -> None:
        """Close a DAG session and its stage sessions (unknown ids are
        ignored)."""
        with self._lock:
            ds = self._dags.pop(dag_id, None)
            if ds is None:
                return
            for sid in set(ds.stage_sids.values()):
                self.close_session(sid)

    def _get_dag(self, dag_id: str) -> _DagSession:
        try:
            return self._dags[dag_id]
        except KeyError:
            raise KeyError(f"unknown DAG session {dag_id!r}") from None

    def _dag_snapshot(self, dag_id: str):
        """Under the lock: the DAG plus copies of its stages' frontiers."""
        with self._lock:
            ds = self._get_dag(dag_id)
            frontiers = {
                name: self.frontier(sid)
                for name, sid in ds.stage_sids.items()
            }
        empty = sorted(n for n, (F, _) in frontiers.items() if len(F) == 0)
        if empty:
            raise RuntimeError(
                f"DAG session {dag_id!r}: stages {empty} have no "
                f"frontier yet — probe first (run_until/step_all)")
        return ds.dag, frontiers

    def dag_frontier(self, dag_id: str) -> ComposedFrontier:
        """Compose the job-level frontier from the stages' live frontiers
        (critical-path / summed objectives per the DAG's operators), with
        Pareto re-filtering through the FrontierStore (the compose and
        dominance kernels when ``use_kernel``).

        Only the per-stage frontier *snapshot* happens under the service
        lock (``frontier()`` already copies); the composition itself runs
        outside it, so a large compose never stalls other tenants'
        ``step_all``/``run_until``."""
        dag, frontiers = self._dag_snapshot(dag_id)
        return dag.compose_frontiers(frontiers, use_kernel=self.use_kernel,
                                     device=self.device)

    def recommend_dag(
        self,
        dag_id: str,
        preference: Preference | None = None,
    ) -> DagRecommendation:
        """Pick one composed point and return the per-stage configurations
        realizing it.  ``preference`` defaults to UN on the composed
        frontier.  Composes once, outside the service lock."""
        comp = self.dag_frontier(dag_id)
        with self._lock:
            dag = self._get_dag(dag_id).dag
        pref = preference if preference is not None else (
            preference_from_legacy("un"))
        i = pref.pick(comp.F, comp.utopia, comp.nadir)
        return DagRecommendation(
            dag_id=dag_id,
            index=i,
            objectives=comp.F[i],
            stage_configs=dag.decode(comp.X[i]),
            frontier_size=len(comp),
        )

    # ------------------------------------------------------------------
    def _open(self, problem: MOOProblem, sig: tuple, spec: TaskSpec,
              mode, mogd, grid_l, batch_rects, target: int) -> str:
        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError(
                    f"session limit reached ({self.max_sessions})")
            mogd = mogd if mogd is not None else self.default_mogd
            engine = self._build_engine(
                problem, sig, mogd,
                mode=mode if mode is not None else self.default_mode,
                grid_l=grid_l if grid_l is not None else self.default_grid_l,
                batch_rects=(batch_rects if batch_rects is not None
                             else self.default_batch_rects),
                target=target)
            sid = f"sess-{next(self._ids)}"
            self._sessions[sid] = _Session(sid, problem, sig, engine,
                                           solver_key=(sig, mogd),
                                           spec=spec)
            return sid

    def _build_engine(self, problem: MOOProblem, sig: tuple,
                      mogd: MOGDConfig, mode: str, grid_l: int,
                      batch_rects: int, target: int) -> ProgressiveFrontier:
        return ProgressiveFrontier(
            problem,
            mode=mode,
            mogd=mogd,
            grid_l=grid_l,
            batch_rects=batch_rects,
            target=target,
            solver=self._solver_for(problem, sig, mogd),
            use_kernel=self.use_kernel,
            device=self.device,
        )

    def close_session(self, session_id: str) -> None:
        """Close a session (unknown ids are ignored)."""
        with self._lock:
            sess = self._sessions.pop(session_id, None)
            if sess is None:
                return
            # last-chance durability: closing a session with probes spent
            # since its last snapshot persists the frontier so the next
            # process can warm-start it
            if (sess.state is not None and not sess.stale
                    and sess.state.probes > sess.probes_at_snapshot):
                self._persist_session_locked(sess, "close")
            # content signatures are recurring jobs: compiled problems and
            # solvers stay warm for the next submission (bounded by
            # _evict_cold_tasks)
            self._unwatch(sess)

    def _unwatch(self, sess: _Session) -> None:
        """Drop a session from its workload's watch set (lock held)."""
        if sess.workload is None:
            return
        watchers = self._watch.get(sess.workload)
        if watchers is not None:
            watchers.discard(sess.session_id)
            if not watchers:
                self._watch.pop(sess.workload, None)

    # ------------------------------------------------------------------
    # Model-server integration (DESIGN.md §9): sessions subscribe to a
    # ModelRegistry; a version bump or drift event invalidates the
    # signature-keyed caches of every watching session and schedules a
    # warm re-solve (seeded from the prior frontier) at the next probe —
    # never on the recommend path, which keeps serving the last frontier.
    # ------------------------------------------------------------------
    def attach_registry(self, registry) -> None:
        """Subscribe this service to a ModelRegistry's invalidation
        events (idempotent).  The registry must serve its models on the
        service's device."""
        if registry.device != self.device:
            raise ValueError(f"registry serves on {registry.device}, "
                             f"service runs on {self.device}")
        with self._lock:
            if registry in self._registries:
                return
            self._registries.append(registry)
        registry.subscribe(self._on_model_event)

    def create_workload_session(
        self,
        registry,
        workload: str,
        preference: Preference | None = None,
        mode: str | None = None,
        mogd: MOGDConfig | None = None,
        grid_l: int | None = None,
        batch_rects: int | None = None,
        target: int = 0,
    ) -> str:
        """Register a tuning session whose objective model is served by a
        :class:`~repro_torch.modelserver.ModelRegistry` workload.  The session
        tracks the registry: model version bumps and drift events
        invalidate its frontier and trigger a warm incremental re-solve."""
        self.attach_registry(registry)
        spec = registry.task_spec(workload, preference=preference)
        with self._lock:
            sid = self.create_session(spec, mode=mode, mogd=mogd,
                                      grid_l=grid_l, batch_rects=batch_rects,
                                      target=target)
            sess = self._sessions[sid]
            sess.registry = registry
            sess.workload = workload
            self._watch.setdefault(workload, set()).add(sid)
            self._recheck_watched(sess)
            # vault warm-start tier 2 (DESIGN.md §13): no exact-signature
            # entry (create_session already tried), but a surviving entry
            # for the SAME workload under an OLDER model version donates
            # its pareto X as the initial rectangle set — k reference
            # solves instead of a cold full solve
            if (self.vault is not None and sess.state is None
                    and not sess.stale):
                donor = self.vault.latest_for_workload(workload)
                if donor is not None:
                    arrays, _meta = donor
                    X_old = live_seed_points(arrays)
                    if len(X_old):
                        sess.state = sess.engine.seed(X_old)
                        sess.probes_at_snapshot = sess.state.probes
                        self._c_vault_seeds.inc()
            return sid

    def watch_workload(self, session_id: str, registry,
                       workload: str) -> None:
        """Subscribe an existing session (e.g. a DAG stage child) to a
        registry workload's invalidation events."""
        self.attach_registry(registry)
        with self._lock:
            sess = self._get(session_id)
            if sess.workload != workload:
                self._unwatch(sess)  # rebinding must not leave the old
                # workload's events able to poison this session
            sess.registry = registry
            sess.workload = workload
            self._watch.setdefault(workload, set()).add(session_id)
            self._recheck_watched(sess)

    def _recheck_watched(self, sess: _Session) -> None:
        """Close the subscribe->watch race: a version promoted between
        fetching the spec and registering the watch set emitted its event
        before this session was listening — compare against the
        registry's CURRENT spec and invalidate if we already missed one.
        Under the service lock."""
        current = (self._registry_spec_for(sess).signature(),)
        if current != sess.signature and not sess.stale:
            sess.stale = True
            self._c_frontier_invalidations.inc()
            self._problems.pop(sess.signature, None)
            self._solvers.pop(sess.solver_key, None)

    def _registry_spec_for(self, sess: _Session) -> TaskSpec:
        """The spec a watched session would rebuild against right now:
        the registry's active snapshot, with the session's own objective
        declarations (bounds/alphas) and preference preserved."""
        spec = sess.registry.task_spec(
            sess.workload, preference=sess.spec.preference)
        if spec.objectives != sess.spec.objectives:
            # the session's author may have declared tighter bounds /
            # alphas than the registry record (e.g. a DAG stage with a
            # latency cap): a model refresh must not drop them
            try:
                spec = dataclasses.replace(
                    spec, objectives=sess.spec.objectives)
            except ValueError:
                # the new backend can't honor the alphas (no predictive
                # stds): keep the alpha-independent declarations — the
                # author's HARD bounds must survive a model refresh
                warnings.warn(
                    f"session {sess.session_id}: model refresh dropped "
                    f"uncertainty alphas (new snapshot has no predictive "
                    f"stds); hard bounds preserved", RuntimeWarning,
                    stacklevel=2)
                stripped = tuple(
                    dataclasses.replace(o, alpha=0.0)
                    for o in sess.spec.objectives)
                spec = dataclasses.replace(spec, objectives=stripped)
        return spec

    def _on_model_event(self, event) -> None:
        """Registry callback: invalidate every watching session."""
        with self._lock:
            for sid in self._watch.get(event.workload, ()):
                sess = self._sessions.get(sid)
                if sess is None or sess.stale:
                    continue
                sess.stale = True
                self._c_frontier_invalidations.inc()
                # drop the signature-keyed caches for the outdated model:
                # the next compile under this signature must not resurrect
                # a frontier/solver built against stale predictions
                self._problems.pop(sess.signature, None)
                self._solvers.pop(sess.solver_key, None)
            # drift invalidation extends to the DURABLE plane: frontiers
            # persisted under the drifted regime must never warm-start a
            # post-restart session (DESIGN.md §13) — tombstone every vault
            # entry at or below the drifted version, synchronously
            if event.kind == "drift" and self.vault is not None:
                killed = self.vault.tombstone_workload(
                    event.workload, version=event.version, reason="drift")
                self._c_vault_tombstones.inc(killed)

    def _refresh_stale_locked(self) -> None:
        """Warm re-solve every stale session whose registry now serves a
        different model version.  Runs on the probe/step path (under the
        service lock), so recommend() latency never pays for it; the old
        frontier keeps serving until the rebuilt one overtakes it."""
        for sess in self._sessions.values():
            if not sess.stale or sess.registry is None:
                continue
            spec = self._registry_spec_for(sess)
            sig = (spec.signature(),)
            if sig == sess.signature:
                # drift flagged but no promoted retrain yet: nothing newer
                # to rebuild against — stay stale, keep serving
                continue
            old_X = None
            if sess.state is not None and sess.state.store.n_points:
                _, old_X = sess.state.store.frontier()
            problem = self._compile_cached(spec, sig)
            mogd = sess.solver_key[1]
            engine = self._build_engine(
                problem, sig, mogd, mode=sess.engine.mode,
                grid_l=sess.engine.grid_l,
                batch_rects=sess.engine.batch_rects,
                target=sess.engine.target)
            state = None
            if old_X is not None and len(old_X):
                # incremental re-solve: the prior frontier becomes the
                # initial rectangle set of the new PF state
                state = engine.seed(old_X)
            sess.problem = problem
            sess.signature = sig
            sess.solver_key = (sig, mogd)
            sess.spec = spec
            sess.engine = engine
            sess.state = state
            sess.stale = False
            self._c_warm_resolves.inc()
            self._evict_cold_tasks()

    def __len__(self) -> int:
        """Number of open sessions."""
        return len(self._sessions)

    def _get(self, session_id: str) -> _Session:
        try:
            return self._sessions[session_id]
        except KeyError:
            raise KeyError(f"unknown session {session_id!r}") from None

    # ------------------------------------------------------------------
    def probe(self, session_id: str, n_probes: int = 16,
              deadline_s: float | None = None) -> PFResult:
        """Advance one session by ``n_probes`` additional probes (resuming
        its PFState) and return the refreshed frontier."""
        with self._lock:
            self._refresh_stale_locked()
            sess = self._get(session_id)
            res = sess.engine.run(n_probes=n_probes, state=sess.state,
                                  deadline_s=deadline_s)
            sess.state = res.state
            return res

    def _group_key(self, sess: _Session) -> tuple:
        """The coalescing identity ``step_all``/``step_sessions`` group
        by: the executor structure key, so sessions over DIFFERENT
        workloads batch into one dispatch when their programs share a
        structure (params ride as data; target/bounds per box).  Legacy
        mode (``structure_coalescing=False``) groups by the
        content-addressed solver-cache key instead — never ``id()``."""
        if self.structure_coalescing:
            return sess.engine.solver.dispatch_key()
        return (*sess.solver_key, sess.engine.target)

    def session_dispatch_key(self, session_id: str) -> tuple:
        """The hashable coalescing key of one session — a batcher in
        front of the service groups pending probe work by it so each
        micro-batch maps onto ONE executor dispatch (DESIGN.md §12)."""
        with self._lock:
            sess = self._get(session_id)
            if sess.engine.mode != "AP":
                return ("sequential", *sess.solver_key)
            return self._group_key(sess)

    def _budget_allocations(self, groups: dict, context: dict) -> dict:
        """Ask the budget policy for per-session rectangle allowances,
        one candidate set per coalescing group (DESIGN.md §15).

        The bucket-safe cap comes from the executor's own planner: with
        G sessions in the group and the LEGACY per-session row count R,
        ``plan_buckets(G, R)`` names the padded bucket this round would
        build anyway — any allowance whose rows fit inside ``want_r``
        reuses that program (plus the executor's 4x reuse window for
        smaller batches), so learned routing never triggers a fresh
        build.  Called with the service lock held.  Returns
        ``{sid: n_rects}`` (missing sid -> legacy ``batch_rects``)."""
        policy = self.budget_policy
        alloc: dict[str, int] = {}
        granted = legacy = 0
        for key, sess_list in groups.items():
            r_legacy = max(
                s.engine.batch_rects * (s.engine.grid_l ** s.problem.k)
                for s in sess_list)
            _, want_r = self.executor.plan_buckets(len(sess_list), r_legacy)
            candidates, caps = [], {}
            for s in sess_list:
                lk = s.engine.grid_l ** s.problem.k
                cap = max(s.engine.batch_rects, want_r // max(lk, 1))
                caps[s.session_id] = cap
                st = s.state
                ctx = context.get(s.session_id, {})
                top = st.queue.peek()
                candidates.append(Candidate(
                    session_id=s.session_id,
                    group_key=key,
                    batch_rects=s.engine.batch_rects,
                    cap_rects=cap,
                    queue_len=len(st.queue),
                    uncertain_volume=st.queue.total_volume,
                    uncertain_fraction=st.queue.uncertain_fraction,
                    top_rect_volume=(top.volume if top is not None else 0.0),
                    probes=st.probes,
                    frontier_points=st.store.n_points,
                    gain_ema=s.gain_ema,
                    rounds_idle=s.rounds_idle,
                    slo=ctx.get("slo", "standard"),
                    deadline_slack_s=ctx.get("deadline_slack_s",
                                             float("inf")),
                    wall_ema_s=ctx.get("wall_ema_s", 0.0),
                    sheddable=ctx.get("sheddable", True),
                ))
            decided = policy.allocate(candidates)
            for c in candidates:
                want = decided.get(c.session_id, c.batch_rects)
                # defensive clamp: a policy bug must not blow the bucket
                n = max(0, min(int(want), caps[c.session_id]))
                alloc[c.session_id] = n
                granted += n
                legacy += c.batch_rects
        if alloc:
            self._c_budget_rounds.inc()
            self._c_budget_rects_granted.inc(granted)
            self._c_budget_rects_legacy.inc(legacy)
        return alloc

    def step_all(self, rounds: int = 1) -> dict:
        """Coalesced scheduling: for each group of active sessions sharing
        a program structure, pop every session's top rectangles and solve
        *all* their probe cells in one MOGD batch.  The device dispatch
        itself runs with the service lock released (see
        :meth:`_step_round`).

        Returns aggregate stats for the performed rounds."""
        stats = {"rounds": 0, "batches": 0, "probes": 0, "sessions": 0}
        for _ in range(rounds):
            with self._lock:
                sessions = list(self._sessions.values())
            out = self._step_round(sessions)
            if out["probes"] == 0:
                break
            stats["rounds"] += 1
            for k in ("batches", "probes", "sessions"):
                stats[k] += out[k]
        return stats

    def step_sessions(self, session_ids,
                      origin: str | None = "frontdesk",
                      parent_span=None,
                      context: dict | None = None) -> dict:
        """One coalesced probe round over exactly the named sessions — a
        scheduler's dispatch seam (DESIGN.md §12): the caller decides
        *which* sessions' work drains next, this method turns the chosen
        set into (at most one per structure group) executor dispatches.
        Unknown or closed ids are skipped silently — a tenant leaving
        between schedule and dispatch is normal traffic.  ``parent_span``
        (explicit context propagation, DESIGN.md §14) parents this round's
        spans under the caller's dispatch span.

        Returns ``{"batches", "probes", "sessions", "per_session":
        {sid: probes}, "exhausted": [sid, ...], "timing": {...}}`` where
        ``exhausted`` names sessions whose rectangle queue is now empty
        (their frontier is final — a front desk's pending tickets can
        complete immediately) and ``timing`` carries the round's measured
        prepare/solve/absorb/persist seconds (the front desk's per-ticket
        latency attribution divides by these).

        ``context`` (optional) carries per-session serving facts for the
        budget policy — ``{sid: {"slo", "deadline_slack_s", "wall_ema_s",
        "sheddable"}}`` (DESIGN.md §15); it is ignored when no
        ``budget_policy`` is configured."""
        with self._lock:
            sessions = [self._sessions[s] for s in session_ids
                        if s in self._sessions]
        return self._step_round(sessions, origin=origin,
                                parent_span=parent_span, context=context)

    def _step_round(self, sessions: list[_Session],
                    origin: str | None = None,
                    parent_span=None,
                    context: dict | None = None) -> dict:
        """One probe round over ``sessions``: initialize new sessions (the
        k reference solves) with the service lock RELEASED, prepare (pop
        probe cells) under it, solve each structure group's batch with
        the lock released again, re-acquire to absorb results.  ``recommend``
        and ``stats`` therefore never wait on a device dispatch.  A failed
        dispatch restores every popped-but-unsolved cell (no uncertain
        space leaks) before re-raising.

        Must be called WITHOUT the service lock held (the lock is
        re-entrant, so a holder would silently serialize the dispatch)."""
        tr = self.obs.tracer
        timing = {p: 0.0 for p in ROUND_PHASES}
        timing["round_wall_s"] = 0.0
        t_round0 = time.perf_counter()
        round_sp = tr.span("service.step_round", cat="service",
                           parent=parent_span,
                           args={"sessions": len(sessions),
                                 "origin": origin})
        try:
            out = self._step_round_inner(sessions, origin, timing,
                                         round_sp, context)
        finally:
            timing["round_wall_s"] = time.perf_counter() - t_round0
            for p in ROUND_PHASES:
                self._h_round[p].record(timing[p])
            round_sp.end()
        out["timing"] = timing
        return out

    def _step_round_inner(self, sessions: list[_Session], origin,
                          timing: dict, round_sp, context=None) -> dict:
        """The body of :meth:`_step_round` (timing/span scaffolding
        lives in the wrapper)."""
        tr = self.obs.tracer
        out = {"batches": 0, "probes": 0, "sessions": 0,
               "per_session": {}, "exhausted": []}
        t_prep0 = time.perf_counter()
        with self._lock:
            self._refresh_stale_locked()
            fresh = [s for s in sessions
                     if self._sessions.get(s.session_id) is s
                     and s.state is None
                     and s.session_id not in self._initializing]
            self._initializing.update(s.session_id for s in fresh)
        # new sessions' init phase (Alg. 1's k reference solves: device
        # work) runs with the service lock RELEASED, as the probe dispatch
        # below does, so recommend and stats never wait on it.  A state
        # is installed only if the engine that built it still serves the
        # session: a model refresh meanwhile (another thread's round)
        # swaps the engine, and the init runs again on the new one
        try:
            for sess in fresh:
                with self._lock:
                    engine = sess.engine
                while engine is not None:
                    state = engine.initialize()
                    with self._lock:
                        if (self._sessions.get(sess.session_id) is not sess
                                or sess.state is not None):
                            engine = None  # closed, or set by probe()
                        elif sess.engine is engine:
                            sess.state = state
                            engine = None
                        else:
                            engine = sess.engine
        finally:
            with self._lock:
                self._initializing.difference_update(
                    s.session_id for s in fresh)
                self._init_done.notify_all()
        # a session another round is initializing: wait for its state (the
        # reference's round would have waited on the lock for it)
        with self._lock:
            self._init_done.wait_for(lambda: not any(
                s.session_id in self._initializing
                and self._sessions.get(s.session_id) is s
                for s in sessions))
        with self._lock:
            groups: dict[tuple, list[_Session]] = {}
            singles: list[_Session] = []
            for sess in sessions:
                if self._sessions.get(sess.session_id) is not sess:
                    continue  # closed (or warm-replaced) since the snapshot
                if sess.state is None:
                    continue  # its init raised in another round
                if not len(sess.state.queue):
                    out["exhausted"].append(sess.session_id)
                    continue  # exhausted — frontier is final
                if sess.engine.mode == "AP":
                    groups.setdefault(self._group_key(sess), []).append(sess)
                else:
                    singles.append(sess)
            # budget plane (DESIGN.md §15): the policy decides each
            # session's rectangle allowance BEFORE the pop; None (no
            # policy) keeps the legacy uniform schedule with zero
            # policy calls on this path
            alloc = (self._budget_allocations(groups, context or {})
                     if self.budget_policy is not None else None)
            prepared_groups = []
            for sess_list in groups.values():
                prepared = []
                for s in sess_list:
                    budget = (None if alloc is None
                              else alloc.get(s.session_id))
                    if budget is not None and budget <= 0:
                        # skipped this round: idle, NOT exhausted — its
                        # queue is untouched and staleness accrues
                        s.rounds_idle += 1
                        continue
                    cells, boxes, pop = s.engine.prepare_parallel(
                        s.state, max_rects=budget)
                    if boxes is not None:
                        prepared.append((s, cells, boxes, pop))
                    elif not len(s.state.queue):
                        out["exhausted"].append(s.session_id)
                if prepared:
                    prepared_groups.append(prepared)
            n_rows = sum(b.shape[0]
                         for g in prepared_groups for _, _, b, _ in g)
            self._g_in_flight_probes.inc(n_rows)
            self._g_in_flight_dispatches.inc(len(prepared_groups))
        t_prep1 = time.perf_counter()
        timing["prepare_s"] += t_prep1 - t_prep0
        if tr.enabled:
            tr.record_span("service.prepare", t_prep0, t_prep1,
                           cat="service", parent=round_sp,
                           args={"rows": n_rows,
                                 "groups": len(prepared_groups)})
        # -- device dispatches: service lock RELEASED -----------------
        pending = list(prepared_groups)
        try:
            while pending:
                prepared = pending.pop(0)
                total = sum(b.shape[0] for _, _, b, _ in prepared)
                t0 = time.perf_counter()
                solve_sp = tr.span("service.solve", cat="service",
                                   parent=round_sp,
                                   args={"rows": total,
                                         "tenants": len(prepared)})
                try:
                    with solve_sp:
                        res = solve_grouped(
                            [(s.engine.solver, boxes, s.engine.target)
                             for s, _, boxes, _ in prepared], origin=origin,
                            parent_span=(solve_sp if solve_sp.enabled
                                         else None))
                except Exception:
                    pending.insert(0, prepared)  # restore this group too
                    raise
                wall = time.perf_counter() - t0
                timing["solve_s"] += wall
                t_abs0 = time.perf_counter()
                with self._lock:
                    off = 0
                    for s, cells, boxes, pop in prepared:
                        n = boxes.shape[0]
                        sub = dataclasses.replace(
                            res, x=res.x[off: off + n], f=res.f[off: off + n],
                            feasible=res.feasible[off: off + n])
                        s.engine.absorb(s.state, cells, sub, pop=pop)
                        # charge each session its share of the dispatch
                        s.state.elapsed += wall * (n / total)
                        s.state.record()
                        # gain attribution (DESIGN.md §15): the absorb
                        # just logged the hv delta this batch bought —
                        # fold it into the session's per-probe EMA and
                        # feed the policy its realized reward
                        delta = s.state.gain_log[-1][1]
                        self._h_hv_gain.record(delta)
                        s.gain_ema = (0.7 * s.gain_ema
                                      + 0.3 * (delta / max(n, 1)))
                        s.rounds_idle = 0
                        if self.budget_policy is not None:
                            self.budget_policy.observe(
                                s.session_id, probes=n, hv_delta=delta,
                                wall_s=wall * (n / total))
                        out["per_session"][s.session_id] = (
                            out["per_session"].get(s.session_id, 0) + n)
                        if not len(s.state.queue):
                            out["exhausted"].append(s.session_id)
                        off += n
                    self._g_in_flight_probes.dec(total)
                    self._g_in_flight_dispatches.dec()
                    self._c_coalesced_batches.inc()
                    self._c_coalesced_probes.inc(total)
                    out["batches"] += 1
                    out["probes"] += total
                    out["sessions"] += len(prepared)
                t_abs1 = time.perf_counter()
                timing["absorb_s"] += t_abs1 - t_abs0
                if tr.enabled:
                    tr.record_span("service.absorb", t_abs0, t_abs1,
                                   cat="service", parent=round_sp,
                                   args={"rows": total})
        except Exception:
            # a failed shared dispatch must not leak any tenant's popped
            # uncertain space — return every unsolved cell to its queue
            with self._lock:
                for prepared in pending:
                    for s, cells, boxes, _ in prepared:
                        s.engine.restore(s.state, cells)
                    self._g_in_flight_probes.dec(sum(
                        b.shape[0] for _, _, b, _ in prepared))
                    self._g_in_flight_dispatches.dec()
            raise
        # -- sequential (PF-S / PF-AS) sessions stay under the lock ----
        if singles:
            with self._lock:
                for sess in singles:
                    if (self._sessions.get(sess.session_id) is not sess
                            or sess.state is None
                            or not len(sess.state.queue)):
                        continue
                    t0 = time.perf_counter()
                    before = sess.state.probes
                    sess.engine._step_sequential(sess.state)
                    sess.state.elapsed += time.perf_counter() - t0
                    sess.state.record()
                    n = sess.state.probes - before
                    delta = sess.state.gain_log[-1][1]
                    sess.gain_ema = (0.7 * sess.gain_ema
                                     + 0.3 * (delta / max(n, 1)))
                    out["probes"] += n
                    out["sessions"] += 1
                    out["per_session"][sess.session_id] = (
                        out["per_session"].get(sess.session_id, 0) + n)
        # -- write-behind durability sweep (DESIGN.md §13) -------------
        # snapshot sessions that just converged (queue drained — their
        # frontier is final) or crossed the autosave probe budget; the
        # disk write happens on the vault's writer thread, so this only
        # pays for the host export under the lock
        if self.vault is not None:
            t_per0 = time.perf_counter()
            persisted = 0
            with self._lock:
                for sess in sessions:
                    if self._sessions.get(sess.session_id) is not sess:
                        continue
                    st = sess.state
                    if st is None or sess.stale:
                        continue
                    done = not len(st.queue)
                    due = (st.probes - sess.probes_at_snapshot
                           >= self.vault_autosave_probes)
                    if st.probes > sess.probes_at_snapshot and (done or due):
                        if self._persist_session_locked(
                                sess, "converged" if done else "autosave"):
                            persisted += 1
            t_per1 = time.perf_counter()
            timing["persist_s"] += t_per1 - t_per0
            if tr.enabled and persisted:
                tr.record_span("service.persist", t_per0, t_per1,
                               cat="service", parent=round_sp,
                               args={"snapshots": persisted})
        return out

    def run_until(self, min_probes: int, max_rounds: int = 10_000) -> dict:
        """Drive ``step_all`` until every active session has spent at least
        ``min_probes`` probes (or its queue is exhausted)."""
        out = {"rounds": 0, "batches": 0, "probes": 0}
        with self._lock:
            # rebuild invalidated sessions first: a freshly re-solved state
            # restarts its probe budget, so it must count as pending below
            self._refresh_stale_locked()
        for _ in range(max_rounds):
            with self._lock:
                pending = [
                    s for s in self._sessions.values()
                    if s.state is None
                    or (s.state.probes < min_probes and len(s.state.queue))
                ]
            if not pending:
                break
            st = self.step_all(rounds=1)
            if st["rounds"] == 0:
                break
            for k in out:
                out[k] += st.get(k, 0)
        return out

    # ------------------------------------------------------------------
    def frontier(self, session_id: str) -> tuple[np.ndarray, np.ndarray]:
        """Live Pareto frontier ``(F, X)`` of a session (no re-filtering)."""
        with self._lock:
            sess = self._get(session_id)
            if sess.state is None:
                k, d = sess.problem.k, sess.problem.dim
                return np.empty((0, k)), np.empty((0, d))
            return sess.state.store.frontier()

    def recommend(
        self,
        session_id: str,
        preference: Preference | str | None = None,
        weights=None,
        default_latency_s: float | None = None,
        strategy: str | None = None,
    ) -> Recommendation:
        """Pick one configuration from the session's live frontier.

        ``preference`` is a typed §5 policy (UtopiaNearest /
        WeightedUtopiaNearest / WorkloadAware).  When omitted, the
        session's TaskSpec preference applies.  The old string protocol —
        ``strategy=`` or a string passed as ``preference`` — still works
        through a deprecation shim."""
        if strategy is not None or isinstance(preference, str):
            warnings.warn(
                "string recommendation strategies are deprecated; pass a "
                "Preference policy (see repro_torch.core.task)",
                DeprecationWarning, stacklevel=2)
            preference = preference_from_legacy(
                strategy if strategy is not None else preference,
                weights=weights, default_latency_s=default_latency_s)
        with self._lock:
            sess = self._get(session_id)
            if preference is None:
                preference = sess.spec.preference
            if sess.state is None or sess.state.store.n_points == 0:
                raise RuntimeError(
                    f"session {session_id!r} has no frontier yet — probe first")
            F, X = sess.state.store.frontier()
            i = preference.pick(F, sess.state.utopia, sess.state.nadir)
            return Recommendation(
                session_id=session_id,
                index=i,
                objectives=F[i],
                x=X[i],
                config=sess.problem.encoder.decode(X[i]),
                frontier_size=len(F),
            )

    def session_exhausted(self, session_id: str) -> bool:
        """True when a session has a finalized frontier (state exists and
        its rectangle queue is empty) — a vault-restored session reports
        True before any probe is dispatched, which lets a front desk
        complete its ticket at submit time (the warm-restart fast path).
        Unknown ids return False."""
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is None or sess.state is None:
                return False
            return not len(sess.state.queue)

    # ------------------------------------------------------------------
    def session_info(self, session_id: str) -> SessionInfo:
        """A read-only snapshot of one session."""
        with self._lock:
            sess = self._get(session_id)
            st = sess.state
            return SessionInfo(
                session_id=session_id,
                signature=sess.signature,
                mode=sess.engine.mode,
                probes=0 if st is None else st.probes,
                frontier_size=0 if st is None else st.store.n_points,
                uncertain_fraction=(
                    1.0 if st is None else st.queue.uncertain_fraction),
                exhausted=st is not None and not len(st.queue),
                elapsed_s=0.0 if st is None else st.elapsed,
                workload=sess.workload,
                stale=sess.stale,
            )

    def stats(self) -> dict:
        """One consistent snapshot of service counters, taken atomically
        under the service lock — every value describes the same instant."""
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "dag_sessions": len(self._dags),
                "compiled_solvers": len(self._solvers),
                "compiled_problems": len(self._problems),
                "solver_cache_hits": self.solver_cache_hits,
                "problem_cache_hits": self.problem_cache_hits,
                "coalesced_batches": self.coalesced_batches,
                "coalesced_probes": self.coalesced_probes,
                # executor plane telemetry (DESIGN.md §10): distinct
                # structures, total program builds, dispatches
                "executor_structures": self.executor.structures_compiled,
                "executor_compiles": self.executor.total_compiles,
                "executor_dispatches": self.executor.dispatches,
                "watched_workloads": len(self._watch),
                "stale_sessions": sum(
                    1 for s in self._sessions.values() if s.stale),
                "frontier_invalidations": self.frontier_invalidations,
                "warm_resolves": self.warm_resolves,
                "total_probes": sum(
                    s.state.probes for s in self._sessions.values()
                    if s.state is not None),
                # serving-plane telemetry (DESIGN.md §12): rectangles
                # still queued across sessions, sessions with pending
                # work, and probe rows currently solving with the
                # service lock released
                "queue_depth": sum(
                    len(s.state.queue) for s in self._sessions.values()
                    if s.state is not None),
                "active_sessions": sum(
                    1 for s in self._sessions.values()
                    if s.state is None or len(s.state.queue)),
                "in_flight_probes": self.in_flight_probes,
                "in_flight_dispatches": self.in_flight_dispatches,
                # durable frontier plane telemetry (DESIGN.md §13)
                "vault_restores": self.vault_restores,
                "vault_seeds": self.vault_seeds,
                "vault_snapshots": self.vault_snapshots,
                "vault_tombstones": self.vault_tombstones,
                # probe-budget plane telemetry (DESIGN.md §15): what the
                # policy granted vs what the legacy uniform schedule
                # would have spent, over the same rounds
                "budget": {
                    "policy": (getattr(self.budget_policy, "name",
                                       type(self.budget_policy).__name__)
                               if self.budget_policy is not None else None),
                    "rounds": int(self._c_budget_rounds.value),
                    "rects_granted": int(
                        self._c_budget_rects_granted.value),
                    "rects_legacy": int(self._c_budget_rects_legacy.value),
                },
            }
