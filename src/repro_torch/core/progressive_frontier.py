"""Progressive Frontier algorithms — paper §3.3 + §4 (Algorithm 1, §4.3).

Three variants share one incremental engine:

* **PF-S**  — deterministic sequential: middle-point probes solved by the
  dense reference solver (Knitro stand-in).  Slow, used as ground truth.
* **PF-AS** — approximate sequential: probes solved by MOGD (§4.2).
* **PF-AP** — approximate parallel: the top-``batch_rects`` hyperrectangles
  are popped together, each split into an ``l^k`` grid, and *all* cells' CO
  problems across all rectangles are solved simultaneously in one
  vmap-batched MOGD call — one device dispatch per PF iteration instead of
  one per rectangle (the paper's thread pool becomes a SIMD batch —
  DESIGN.md §2, §4).

All variants are *incremental* (state carries the rectangle queue and an
array-native frontier store, so more probes extend the same frontier) and
*uncertainty-aware* (the queue is prioritized by uncertain-space volume;
the live uncertain fraction per Def. 3.7 is traced after every probe,
which is the y-axis of Fig. 4(a)).

Frontier candidates live in a
:class:`~repro_torch.core.frontier_store.FrontierStore` whose Pareto mask is
maintained incrementally per probe batch (DESIGN.md §3); ``finalize`` is a
plain read of the live frontier.

Every engine runs on one device (``device=None`` means ``cuda``): its MOGD
dispatches and its store's dominance passes run there.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .frontier_store import FrontierStore
from .hyperrectangle import (
    Rectangle,
    RectangleQueue,
    compute_bounds,
    grid_cells,
    make_rectangle,
    split_rectangle,
)
from ..kernels.platform import resolve_device
from .mogd import (
    COResult,
    MOGDConfig,
    MOGDSolver,
    estimate_objective_bounds,
    grid_reference_solve,
)
from .problem import MOOProblem, to_numpy
from .task import as_problem


@dataclasses.dataclass
class PopInfo:
    """Metadata of one ``prepare_parallel`` pop: what uncertain volume was
    taken off the queue and how many probe cells each rectangle turned
    into — the raw material of gain attribution (DESIGN.md §15), surfaced
    instead of discarded so the budget plane never re-derives it."""

    rect_volumes: list  # per popped rectangle, in pop (max-volume) order
    cells_per_rect: list  # aligned with ``rect_volumes``

    @property
    def n_rects(self) -> int:
        """Rectangles popped."""
        return len(self.rect_volumes)

    @property
    def popped_volume(self) -> float:
        """Total uncertain volume popped."""
        return float(sum(self.rect_volumes))


@dataclasses.dataclass
class PFState:
    """Resumable solver state (the paper's incrementality requirement)."""

    queue: RectangleQueue
    store: FrontierStore  # live Pareto set (incremental mask per probe)
    utopia: np.ndarray
    nadir: np.ndarray
    bounds: np.ndarray  # (2, k) global objective bounds used for probes
    probes: int = 0
    elapsed: float = 0.0
    trace: list = dataclasses.field(default_factory=list)  # (t, unc, npts)
    # gain-attribution telemetry (DESIGN.md §15): the normalized dominated
    # hypervolume of the live frontier within the [utopia, nadir] box, and
    # one log row per absorbed probe batch — (probes_after, hv_delta,
    # popped_volume, n_cells) — i.e. what each batch of probes *bought*.
    hv: float = 0.0
    gain_log: list = dataclasses.field(default_factory=list)

    def record(self) -> None:
        """Append ``(elapsed, uncertain fraction, live points)`` to the
        trace."""
        self.trace.append(
            (self.elapsed, self.queue.uncertain_fraction, self.store.n_points)
        )

    def record_gain(self, popped_volume: float, n_cells: int) -> float:
        """Refresh ``hv`` after an absorb and log the delta the batch
        bought; returns the (possibly zero) hypervolume delta."""
        hv = frontier_hypervolume(self)
        delta = hv - self.hv
        self.hv = hv
        self.gain_log.append(
            (float(self.probes), float(delta), float(popped_volume),
             float(n_cells)))
        return delta


def frontier_hypervolume(state: PFState) -> float:
    """Dominated hypervolume of the live frontier w.r.t. the global Nadir,
    normalized by the [utopia, nadir] box volume so gains are comparable
    across tenants (DESIGN.md §15).

    Exact for k<=3 (``pareto.hypervolume``); for k>3 the decided-space
    fraction ``1 - uncertain_fraction`` stands in — a volume proxy with
    the same "more probes decided more space" monotonicity, not a true
    hypervolume."""
    span = np.maximum(state.nadir - state.utopia, 1e-12)
    box = float(np.prod(span))
    if state.store.n_points == 0 or box <= 0.0:
        return 0.0
    if len(state.utopia) <= 3:
        from .pareto import hypervolume

        F, _ = state.store.frontier()
        return float(hypervolume(F, state.nadir)) / box
    return 1.0 - state.queue.uncertain_fraction


def export_pf_state(state: PFState) -> tuple[dict, dict]:
    """Flatten a :class:`PFState` into ``(arrays, meta)`` numpy arrays and
    plain values (the reference's durable-vault layout, DESIGN.md §13).

    Everything a warm restart needs rides along: the frontier store's
    full row history (see ``FrontierStore.state_dict``), the stacked
    uncertain-rectangle corners plus the queue's original initial volume
    (so the Def-3.7 uncertain fraction resumes, not resets), the global
    utopia/nadir/objective-bounds, and the probe/elapsed/trace telemetry.
    """
    s_arrays, s_meta = state.store.state_dict()
    arrays = {f"store/{k}": v for k, v in s_arrays.items()}
    rects = state.queue.rects()
    k = len(state.utopia)
    arrays["queue_utopia"] = (
        np.stack([r.utopia for r in rects]) if rects
        else np.zeros((0, k), dtype=np.float64))
    arrays["queue_nadir"] = (
        np.stack([r.nadir for r in rects]) if rects
        else np.zeros((0, k), dtype=np.float64))
    arrays["utopia"] = np.asarray(state.utopia, dtype=np.float64)
    arrays["nadir"] = np.asarray(state.nadir, dtype=np.float64)
    arrays["bounds"] = np.asarray(state.bounds, dtype=np.float64)
    arrays["trace"] = np.asarray(state.trace, dtype=np.float64).reshape(-1, 3)
    arrays["gain_log"] = np.asarray(
        state.gain_log, dtype=np.float64).reshape(-1, 4)
    meta = {
        "store": s_meta,
        "probes": state.probes,
        "elapsed": state.elapsed,
        "initial_volume": state.queue.initial_volume,
        "hv": float(state.hv),
    }
    return arrays, meta


def import_pf_state(arrays: dict, meta: dict, use_kernel: bool = False,
                    device=None) -> PFState:
    """Inverse of :func:`export_pf_state` — rebuild a resumable state.

    Kernel routing and device follow the restoring engine's configuration
    (see ``FrontierStore.from_state``); everything else round-trips
    exactly.
    """
    store = FrontierStore.from_state(
        {k[len("store/"):]: v for k, v in arrays.items()
         if k.startswith("store/")},
        meta["store"], use_kernel=use_kernel, device=device)
    rects = [make_rectangle(u, n)
             for u, n in zip(arrays["queue_utopia"], arrays["queue_nadir"])]
    queue = RectangleQueue.from_rects(
        rects, initial_volume=float(meta["initial_volume"]))
    state = PFState(
        queue=queue,
        store=store,
        utopia=np.asarray(arrays["utopia"], dtype=np.float64),
        nadir=np.asarray(arrays["nadir"], dtype=np.float64),
        bounds=np.asarray(arrays["bounds"], dtype=np.float64),
        probes=int(meta["probes"]),
        elapsed=float(meta["elapsed"]),
        trace=[tuple(row) for row in np.asarray(arrays["trace"])],
        # entries written before the gain telemetry lack these fields: an
        # absent log resumes empty and hv is recomputed from the restored
        # frontier so the first post-restore delta stays honest
        gain_log=[tuple(row) for row in
                  np.asarray(arrays.get("gain_log",
                                        np.zeros((0, 4)))).reshape(-1, 4)],
    )
    state.hv = (float(meta["hv"]) if "hv" in meta
                else frontier_hypervolume(state))
    return state


def live_seed_points(arrays: dict) -> np.ndarray:
    """The live (pareto-mask) configurations of an exported state — the
    ``X`` rows a version-mismatched restart feeds to
    :meth:`ProgressiveFrontier.seed` as warm-start seeds."""
    alive = np.asarray(arrays["store/alive"], dtype=bool)
    return np.asarray(arrays["store/X"], dtype=np.float64)[alive]


def _overlay_bounds(est: np.ndarray, user: np.ndarray) -> np.ndarray:
    """The sampled objective box ``est (2, k)`` with the user's finite
    value bounds ``user (2, k)`` in place of its edges.

    Where a cap lies past the sampled box's other edge (a sampled lower
    edge above a declared upper bound, or the reverse), the overlay alone
    would invert that axis and leave every probe infeasible: the sampled
    edge then moves to 5 % of the sampled span beyond the cap.  The
    reference overlays without this guard, and inverts the f2 axis of
    ``zdt1_task(f2_cap=0.6)`` for a sample whose f2 minimum is above the
    cap."""
    out = np.where(np.isfinite(user), user, est)
    margin = 0.05 * np.maximum(est[1] - est[0], 1e-12)
    lo, hi = out[0].copy(), out[1].copy()
    inverted = lo >= hi
    cap_hi = inverted & np.isfinite(user[1]) & ~np.isfinite(user[0])
    cap_lo = inverted & np.isfinite(user[0]) & ~np.isfinite(user[1])
    lo = np.where(cap_hi, hi - margin, lo)
    hi = np.where(cap_lo, lo + margin, hi)
    return np.stack([lo, hi])


@dataclasses.dataclass
class PFResult:
    """Frontier, bounds, telemetry and the resume handle of one run."""

    F: np.ndarray  # (N, k) Pareto objective values (live frontier)
    X: np.ndarray  # (N, D) encoded configurations
    utopia: np.ndarray
    nadir: np.ndarray
    trace: list
    probes: int
    elapsed: float
    state: PFState  # resume handle
    infeasible_excluded: int = 0  # offers rejected by value constraints


class ProgressiveFrontier:
    """The Progressive Frontier engine (PF-S, PF-AS, PF-AP) over one
    problem or TaskSpec, on one device (``None`` means ``cuda``; it must be
    the problem's).  ``use_kernel`` routes the frontier store's dominance
    passes through the dominator-count kernel."""

    def __init__(
        self,
        problem: MOOProblem,
        mode: str = "AP",
        mogd: MOGDConfig = MOGDConfig(),
        grid_l: int = 2,
        batch_rects: int = 1,
        target: int = 0,
        solver: MOGDSolver | None = None,
        use_kernel: bool = False,
        device=None,
    ):
        if mode not in ("S", "AS", "AP"):
            raise ValueError(f"unknown PF mode {mode!r}")
        if batch_rects < 1:
            raise ValueError("batch_rects must be >= 1")
        self.device = resolve_device(device)
        problem = as_problem(problem)  # accept a TaskSpec front door too
        if problem.device != self.device:
            raise ValueError(f"problem lives on {problem.device}, engine "
                             f"asked for {self.device}")
        self.problem = problem
        self.mode = mode
        self.grid_l = grid_l
        self.batch_rects = batch_rects
        self.target = target
        # route the store's dominance pass through the dominator-count
        # kernel; default is the dense torch pass
        self.use_kernel = use_kernel
        # An injected solver lets the service layer share one MOGD solver
        # across sessions with the same problem signature (DESIGN.md §5).
        self.solver = (solver if solver is not None
                       else problem.solver_for(mogd, device=self.device))
        self._k = problem.k

    # ------------------------------------------------------------------
    def _probe(self, boxes: np.ndarray) -> COResult:
        """Solve a batch of CO problems (one per box, (B,2,k))."""
        if self.mode == "S":
            rs = [
                grid_reference_solve(self.problem, b, target=self.target)
                for b in boxes
            ]
            return COResult(
                np.concatenate([r.x for r in rs]),
                np.concatenate([r.f for r in rs]),
                np.concatenate([r.feasible for r in rs]),
            )
        return self.solver.solve(boxes, target=self.target)

    # ------------------------------------------------------------------
    def initialize(self) -> PFState:
        """Init phase of Alg. 1: k single-objective solves -> reference
        points -> global Utopia/Nadir -> first rectangle."""
        t0 = time.perf_counter()
        vc = self.problem.value_constraints
        if vc is not None and np.all(np.isfinite(vc)):
            # fully-bounded task: the declared box IS the objective box
            bounds = np.asarray(vc, dtype=np.float64).reshape(self._k, 2).T
        else:
            bounds = estimate_objective_bounds(self.problem)
            if vc is not None:
                # Overlay the user's hard value constraints [F^L, F^U]
                # where declared (±inf edges keep the sampled estimate):
                # the initial objective box — and hence every probe —
                # honors the caps.
                user = np.asarray(vc, dtype=np.float64).reshape(self._k, 2).T
                bounds = _overlay_bounds(bounds, user)
        refs, xs = [], []
        for i in range(self._k):
            r = (
                grid_reference_solve(self.problem, bounds, target=i)
                if self.mode == "S"
                else self.solver.solve_single_objective(i, bounds)
            )
            refs.append(r.f[0])
            xs.append(r.x[0])
        refs = np.stack(refs)
        utopia, nadir = compute_bounds(refs)
        # Reference-point Nadirs can be degenerate in k>=3: every reference
        # solve may drive some objective j to (near) its minimum (the MOGD
        # tie-break explicitly encourages this), collapsing the initial
        # hyperrectangle to a sliver along j and hiding most of the front.
        # Widen any axis whose ref-span is <1% of the sampled global span up
        # to the sampled upper bound (safe: overestimating Nadir only adds
        # uncertain space, never loses Pareto points — Prop. 3.2).
        global_span = np.maximum(bounds[1] - bounds[0], 1e-12)
        degenerate = (nadir - utopia) < 0.01 * global_span
        nadir = np.where(degenerate, np.maximum(bounds[1], utopia + 1e-9), nadir)
        span = np.maximum(nadir - utopia, 1e-9)
        nadir = utopia + span
        store = FrontierStore(k=self._k, dim=self.problem.dim,
                              use_kernel=self.use_kernel, bounds=vc,
                              device=self.device)
        store.add(refs, np.stack(xs))
        state = PFState(
            queue=RectangleQueue(make_rectangle(utopia, nadir)),
            store=store,
            utopia=utopia,
            nadir=nadir,
            bounds=bounds,
            probes=self._k,
        )
        state.hv = frontier_hypervolume(state)
        state.elapsed = time.perf_counter() - t0
        state.record()
        return state

    # ------------------------------------------------------------------
    def _step_sequential(self, state: PFState) -> None:
        """One middle-point probe (PF-S / PF-AS; Alg. 1 lines 9-23)."""
        rect = state.queue.pop()
        popped_volume = float(rect.volume)
        u, n = rect.utopia, rect.nadir
        mid = (u + n) / 2.0
        box = np.stack([u, mid])  # probe the lower half-box (Def. 3.6)
        res = self._probe(box[None])
        state.probes += 1
        if bool(res.feasible[0]):
            fm = np.clip(res.f[0], u, n)
            state.store.add(fm[None], res.x[0][None])
            for sub in split_rectangle(u, fm, n):
                state.queue.push(sub)
        else:
            # Prop. 3.4: no Pareto point in the probed half-box; the rest of
            # the rectangle stays uncertain (all mid-split blocks except the
            # all-lower corner).
            for sub in split_rectangle(u, mid, n):
                state.queue.push(sub)
            upper = make_rectangle(mid, n)
            state.queue.push(upper)
        state.record_gain(popped_volume, 1)

    # ------------------------------------------------------------------
    # PF-AP is split into prepare/absorb so the service layer can coalesce
    # probe work from many sessions into one shared MOGD batch (§4.3,
    # DESIGN.md §5).  ``_step_parallel`` is simply prepare -> solve -> absorb.
    def prepare_parallel(
        self, state: PFState, max_rects: int | None = None
    ) -> tuple[list[Rectangle], np.ndarray | None, PopInfo]:
        """Pop the top-B rectangles and grid them into probe cells.

        Returns ``(cells, boxes, info)`` with ``boxes: (B·l^k, 2, k)``
        aligned to ``cells`` and ``info`` the per-rectangle pop metadata
        (volumes and cell counts, no longer discarded), or
        ``([], None, info)`` when the queue is exhausted."""
        budget = self.batch_rects if max_rects is None else max_rects
        rects: list[Rectangle] = []
        while len(rects) < budget and len(state.queue):
            rects.append(state.queue.pop())
        cells: list[Rectangle] = []
        info = PopInfo(rect_volumes=[], cells_per_rect=[])
        for r in rects:
            rc = grid_cells(r.utopia, r.nadir, self.grid_l)
            cells.extend(rc)
            info.rect_volumes.append(float(r.volume))
            info.cells_per_rect.append(len(rc))
        if not cells:
            return [], None, info
        boxes = np.stack([np.stack([c.utopia, c.nadir]) for c in cells])
        return cells, boxes, info

    def absorb(self, state: PFState, cells: list[Rectangle], res: COResult,
               pop: PopInfo | None = None) -> None:
        """Fold one batched probe result back into the state: push the
        uncertain sub-rectangles and offer all feasible points to the
        frontier store in a single incremental dominance pass.  ``pop``
        (the matching ``prepare_parallel`` metadata, when available)
        attributes the popped volume to the gain-log row."""
        state.probes += len(cells)
        fs, xs = [], []
        for c, ok, f, x in zip(cells, res.feasible, res.f, res.x):
            if not bool(ok):
                continue  # cell has no Pareto candidate -> omitted (§4.3)
            fm = np.clip(f, c.utopia, c.nadir)
            fs.append(fm)
            xs.append(x)
            for sub in split_rectangle(c.utopia, fm, c.nadir):
                state.queue.push(sub)
        if fs:
            state.store.add(np.stack(fs), np.stack(xs))
        state.record_gain(pop.popped_volume if pop is not None else 0.0,
                          len(cells))

    def restore(self, state: PFState, cells: list[Rectangle]) -> None:
        """Return prepared-but-unsolved cells to the queue (a failed probe
        dispatch must not leak uncertain space: the cells exactly partition
        the popped rectangles, so pushing them back preserves volume)."""
        for c in cells:
            state.queue.push(c)

    def _step_parallel(self, state: PFState) -> None:
        """One PF-AP iteration (§4.3): grid the popped rectangles, solve all
        cell CO problems in a single batched MOGD call."""
        cells, boxes, pop = self.prepare_parallel(state)
        if boxes is None:
            return
        try:
            res = self._probe(boxes)
        except Exception:
            self.restore(state, cells)
            raise
        self.absorb(state, cells, res, pop=pop)

    # ------------------------------------------------------------------
    def run(
        self,
        n_probes: int = 32,
        state: PFState | None = None,
        deadline_s: float | None = None,
    ) -> PFResult:
        """Run (or resume) until ``n_probes`` additional probes, an empty
        queue, or the wall-clock deadline.  ``deadline_s`` bounds *this
        call* — a resumed session gets a fresh deadline budget, while
        ``state.elapsed`` keeps accumulating lifetime solve time."""
        if state is None:
            state = self.initialize()
        base_elapsed = state.elapsed
        t0 = time.perf_counter()
        budget = state.probes + n_probes
        while state.probes < budget and len(state.queue):
            if deadline_s is not None and time.perf_counter() - t0 > deadline_s:
                break
            if self.mode == "AP":
                self._step_parallel(state)
            else:
                self._step_sequential(state)
            state.elapsed = base_elapsed + time.perf_counter() - t0
            state.record()
        return self.finalize(state)

    def seed(self, X_seed: np.ndarray,
             state: PFState | None = None) -> PFState:
        """Warm-start a (fresh) state from known-good configurations —
        the incremental re-solve path after a model update (DESIGN.md §9).

        The seeds (typically the *previous* model's Pareto frontier) are
        re-evaluated under the current objectives, offered to the frontier
        store, and used to carve the initial rectangle set: each seed
        point interior to an uncertain rectangle splits it around the
        achieved point.  A seed is *achievable but not probe-optimal*, so
        unlike a middle-point probe only the dominated corner ``[f, n]``
        is discarded (sound for ANY achievable point — everything there
        is dominated by the seed itself); the dominating corner
        ``[u, f]``, where a better new-model frontier may live, is kept
        uncertain (Prop. 3.4 would discard it only for an optimal probe).
        The queue thus starts refined around the old frontier — minus
        only provably-decided space — instead of as one maximal box, and
        a seed that the new model maps outside the objective box (or that
        its constraints reject) degrades gracefully to a plain store
        offer.
        """
        if state is None:
            state = self.initialize()
        X_seed = np.asarray(X_seed, dtype=np.float64)
        if X_seed.size == 0:
            return state
        t0 = time.perf_counter()
        F = to_numpy(self.problem.evaluate_batch(X_seed), np.float64)
        lo, hi = state.utopia, state.nadir
        inside = np.all((F > lo) & (F < hi), axis=1)
        # Offer the seeds at their TRUE re-evaluated values: clamping into
        # the box would fabricate objective values and let a point that
        # violates a declared value cap slip past the store's feasibility
        # check.  Out-of-box seeds just participate in (and usually lose)
        # the dominance pass; only verified-interior seeds carve the queue.
        state.store.add(F, X_seed)
        # Carve: utopia-nearest seeds first (they discard the most volume).
        span = np.maximum(hi - lo, 1e-12)
        order = np.argsort(((F - lo) / span).sum(axis=1))
        rects: list[Rectangle] = []
        while len(state.queue):
            rects.append(state.queue.pop())
        for f in F[order][inside[order]]:
            for i, r in enumerate(rects):
                if np.all(f > r.utopia) and np.all(f < r.nadir):
                    rects.pop(i)
                    rects.extend(split_rectangle(r.utopia, f, r.nadir))
                    # keep the dominating corner: the seed is not an
                    # optimal probe, so [u, f] may still hold the front
                    dom = make_rectangle(r.utopia, f)
                    if dom.volume > 0.0:
                        rects.append(dom)
                    break
        for r in rects:
            state.queue.push(r)
        # seeds move the frontier without spending probes: refresh hv so
        # the next absorb's gain-log delta credits only what probes bought
        state.hv = frontier_hypervolume(state)
        state.elapsed += time.perf_counter() - t0
        state.record()
        return state

    def import_state(self, arrays: dict, meta: dict) -> PFState:
        """Rebuild a persisted :class:`PFState` under THIS engine's kernel
        configuration — the exact-signature warm-restart path: the
        restored state resumes (or finalizes) with zero new probes."""
        return import_pf_state(arrays, meta, use_kernel=self.use_kernel,
                               device=self.device)

    def finalize(self, state: PFState) -> PFResult:
        """Alg. 1 line 25 is already maintained incrementally per probe —
        reading the live frontier replaces the seed's O(N²) re-filter."""
        F, X = state.store.frontier()
        return PFResult(
            F=F,
            X=X,
            utopia=state.utopia,
            nadir=state.nadir,
            trace=list(state.trace),
            probes=state.probes,
            elapsed=state.elapsed,
            state=state,
            infeasible_excluded=state.store.total_infeasible,
        )


def coalesce_step(entries, solve) -> int:
    """One shared probe dispatch over many PF sessions' pending cells.

    ``entries`` is a list of ``(engine, state)`` pairs; ``solve`` maps
    ``(all_boxes: (B, 2, k), prepared)`` to a :class:`COResult` over the
    concatenated boxes, where ``prepared`` is the aligned list of
    ``(engine, state, cells, boxes)`` spans (callers that need per-span
    metadata — e.g. per-stage family parameters — read it from there).
    Results are split back per session, absorbed, and each state is
    charged its share of the shared wall time.  A failed dispatch restores
    every popped cell (no uncertain space leaks).  Returns the number of
    probes performed.

    This is the single coalescing primitive behind the multi-tenant
    service and the multi-stage DAG solver (DESIGN.md §5/§8).
    """
    prepared = []
    pops = {}
    for engine, state in entries:
        cells, boxes, pop = engine.prepare_parallel(state)
        if boxes is not None:
            prepared.append((engine, state, cells, boxes))
            pops[id(state)] = pop
    if not prepared:
        return 0
    all_boxes = np.concatenate([b for *_, b in prepared], axis=0)
    t0 = time.perf_counter()
    try:
        res = solve(all_boxes, prepared)
    except Exception:
        # a failed shared dispatch must not leak any tenant's popped
        # uncertain space — return every prepared cell to its queue
        for engine, state, cells, _ in prepared:
            engine.restore(state, cells)
        raise
    wall = time.perf_counter() - t0
    off = 0
    total = all_boxes.shape[0]
    for engine, state, cells, boxes in prepared:
        n = boxes.shape[0]
        sub = dataclasses.replace(
            res,
            x=res.x[off: off + n],
            f=res.f[off: off + n],
            feasible=res.feasible[off: off + n],
        )
        engine.absorb(state, cells, sub, pop=pops[id(state)])
        # charge each session its share of the shared dispatch
        state.elapsed += wall * (n / total)
        state.record()
        off += n
    return total


def solve_pf(
    problem,  # MOOProblem or TaskSpec
    mode: str = "AP",
    n_probes: int = 32,
    mogd: MOGDConfig = MOGDConfig(),
    grid_l: int = 2,
    batch_rects: int = 1,
    deadline_s: float | None = None,
    device=None,
) -> PFResult:
    """One-call convenience wrapper (``device=None`` means ``cuda``)."""
    pf = ProgressiveFrontier(problem, mode=mode, mogd=mogd, grid_l=grid_l,
                             batch_rects=batch_rects, device=device)
    return pf.run(n_probes=n_probes, deadline_s=deadline_s)
