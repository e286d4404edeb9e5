"""The online model server: a trace-ingesting workload model registry.

The paper's architecture (§2.3) decouples the *modeling engine* from the
optimizer: per-workload predictive models are (re)trained asynchronously
from observed traces, and the MOO layer only ever consumes frozen model
snapshots.  This module is that online half:

* **Registry** — per-workload records keyed by *content-addressed
  workload signatures* (the same ``_fingerprint`` machinery behind
  ``TaskSpec.signature()``), each holding versioned snapshots of an
  objective-vector surrogate Ψ (MLP or GP per-objective regressors)
  plus training-set provenance.
* **Ingest** — :meth:`ModelRegistry.observe` appends
  ``(knobs, measured objectives)`` traces as encoded-X / objective-Y rows.
* **Trainer** — :meth:`ModelRegistry.retrain` warm-starts from the
  previous snapshot (or the *nearest registered workload* for a cold
  one) and bumps the version only when held-out validation error
  improves (``modelserver.trainer``).
* **Drift** — every observation scores the active snapshot's prediction;
  a rolling-error watermark crossing marks the model stale and emits an
  invalidation event (``modelserver.drift``).

Consumers subscribe with :meth:`ModelRegistry.subscribe`; the
``MOOService`` uses the events to invalidate signature-keyed frontier
caches and warm-restart Progressive Frontier sessions (DESIGN.md §9).

Thread-safety: public methods take one re-entrant lock; events are
emitted *outside* it so a subscriber may call back into the registry.

A registry holds its models on one device (``device=None`` means ``cuda``):
fits, drift scoring and the task specs it serves all run there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.problem import SpaceEncoder, VariableSpec
from ..core.task import Objective, Preference, TaskSpec, UtopiaNearest, _fingerprint
from ..kernels.platform import resolve_device
from .drift import DriftConfig, DriftDetector
from .trainer import (
    TrainerConfig,
    TrainOutcome,
    nearest_embedding,
    predict,
    trace_embedding,
    train_candidate,
)


def workload_signature(key, knobs: Sequence[VariableSpec],
                       objectives: Sequence[Objective]) -> str:
    """Content-addressed workload identity: the user key plus the knob
    space and objective declarations, hashed with the TaskSpec
    fingerprint machinery (never ``id()`` — re-registering the same
    workload from fresh objects yields the same signature)."""
    payload = "||".join([
        _fingerprint(key),
        _fingerprint(tuple(knobs)),
        _fingerprint(tuple(objectives)),
    ])
    return hashlib.sha256(payload.encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class ModelEvent:
    """Registry -> subscriber notification.

    ``kind`` is ``"version"`` (a retrain improved validation error and
    promoted a new snapshot) or ``"drift"`` (the rolling prediction-error
    watermark was crossed; the active snapshot is stale until a retrain
    promotes).  Both invalidate cached frontiers downstream."""

    workload: str  # workload signature
    kind: str  # "version" | "drift"
    version: int  # active snapshot version at emit time
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModelSnapshot:
    """One frozen, versioned surrogate Ψ for a workload.

    ``models`` holds k per-objective regressors (natural orientation —
    direction handling stays in ``TaskSpec.compile``).  The snapshot is
    what the MOO layer consumes; it never changes after creation."""

    version: int
    models: tuple
    val_error: float  # gate-split mean relative error at promotion
    n_traces: int  # training-set provenance
    backend: str
    warm_started_from: str | None  # "self" | neighbor workload sig | None
    created_s: float = dataclasses.field(default_factory=time.perf_counter)

    def psi(self) -> Callable:
        """Ψ: encoded x (..., D) -> (k,) objective vector (torch callable,
        on the models' device)."""
        models = self.models

        def _psi(x):
            return torch.stack([m(x) for m in models])

        return _psi

    def psi_std(self) -> Callable | None:
        """Per-objective predictive stds, or None when a model has none."""
        models = self.models
        if not all(hasattr(m, "predict_std") for m in models):
            return None

        def _std(x):
            return torch.stack([m.predict_std(x) for m in models])

        return _std

    def mlp_params(self) -> tuple | None:
        """Per-objective MLP parameter lists (the warm-start handle)."""
        if self.backend != "mlp":
            return None
        return tuple(m.params for m in self.models)

    def program(self):
        """The snapshot's ``(structure_key, params)`` split for the probe
        executor (DESIGN.md §10): one stacked
        :class:`~repro_torch.exec.ParamProgram` whose params pytree is this
        version's weights/factors.  Promoting a new version of the same
        architecture is a pure params swap — downstream solvers reuse the
        already-compiled executor program (warm re-solve, zero
        recompilation).  None when any per-objective regressor lacks a
        split (exotic backends fall back to the closure path)."""
        cached = getattr(self, "_program", None)
        if cached is not None:
            return cached
        from ..exec import stack_programs

        progs = []
        for m in self.models:
            as_program = getattr(m, "as_program", None)
            if as_program is None:
                return None
            progs.append(as_program())
        prog = stack_programs(progs)
        self._program = prog
        return prog


@dataclasses.dataclass
class WorkloadRecord:
    """Everything the registry knows about one workload."""

    sig: str
    key: object
    knobs: tuple
    objectives: tuple
    name: str
    encoder: SpaceEncoder
    X: list = dataclasses.field(default_factory=list)  # encoded rows
    Y: list = dataclasses.field(default_factory=list)  # (k,) natural units
    snapshots: list = dataclasses.field(default_factory=list)
    active: ModelSnapshot | None = None
    drift: DriftDetector | None = None
    stale: bool = False  # drift crossed since the last promotion
    observed: int = 0
    observed_at_train: int = 0
    train_attempts: int = 0

    @property
    def k(self) -> int:
        return len(self.objectives)


class ModelRegistry:
    """Per-workload model registry with drift-triggered invalidation.

    ``max_traces`` bounds the per-workload trace buffer (oldest rows
    roll off) — after a drift the stale regime's rows wash out, which is
    what lets retraining actually track the new cost surface.

    ``retrain_every`` / ``retrain_on_drift`` make ingest self-driving:
    ``observe`` triggers :meth:`retrain` inline once enough new traces
    accumulate (or immediately on a drift crossing).  Training therefore
    rides the *ingest* path, never the recommend path — exactly the
    paper's asynchronous modeling engine.

    ``vault`` (a :class:`repro_torch.persist.FrontierVault`) makes the
    registry durable: every promotion write-behind persists the workload
    record (snapshot lineage + traces), and :meth:`rehydrate` loads
    persisted workloads on a cold start so ``task_spec`` serves the
    pre-restart model version immediately — with the exact pre-restart
    ``TaskSpec.signature()``, which is what lets the service's frontier
    restore hit (DESIGN.md §13).

    ``device`` (``None`` means ``cuda``) is where every model is fit,
    scored and served, rehydrated ones included.
    """

    def __init__(
        self,
        trainer: TrainerConfig = TrainerConfig(),
        drift: DriftConfig = DriftConfig(),
        max_traces: int = 4096,
        max_snapshots: int = 8,
        retrain_every: int | None = None,
        retrain_on_drift: bool = False,
        trim_on_drift: int | None = None,
        vault=None,
        device=None,
    ):
        if max_traces < 8:
            raise ValueError("max_traces must be >= 8")
        if trim_on_drift is not None and trim_on_drift < 8:
            raise ValueError("trim_on_drift must be >= 8 (or None)")
        self.trainer = trainer
        self.drift_config = drift
        self.max_traces = max_traces
        self.max_snapshots = max_snapshots
        self.retrain_every = retrain_every
        self.retrain_on_drift = retrain_on_drift
        self.trim_on_drift = trim_on_drift
        self.device = resolve_device(device)
        self.vault = vault
        self.workloads_persisted = 0
        self.workloads_rehydrated = 0
        self._records: dict[str, WorkloadRecord] = {}
        self._subscribers: list[Callable[[ModelEvent], None]] = []
        self._lock = threading.RLock()
        self.events_emitted = 0

    # -- registration ------------------------------------------------------
    def register_workload(
        self,
        key,
        knobs: Sequence[VariableSpec],
        objectives: Sequence,
        name: str | None = None,
    ) -> str:
        """Register (or re-find) a workload; returns its signature.

        Idempotent: re-registering an identical (key, knobs, objectives)
        triple — fresh objects included — returns the existing record's
        signature and keeps its traces and snapshots."""
        knobs = tuple(knobs)
        if not knobs or not all(isinstance(s, VariableSpec) for s in knobs):
            raise ValueError("knobs must be a non-empty VariableSpec tuple")
        objs = tuple(Objective(o) if isinstance(o, str) else o
                     for o in objectives)
        if not objs:
            raise ValueError("workload needs at least one Objective")
        sig = workload_signature(key, knobs, objs)
        with self._lock:
            if sig not in self._records:
                self._records[sig] = WorkloadRecord(
                    sig=sig, key=key, knobs=knobs, objectives=objs,
                    name=name if name is not None else str(key),
                    encoder=SpaceEncoder(knobs),
                    drift=DriftDetector(self.drift_config),
                )
            return sig

    def workloads(self) -> tuple:
        with self._lock:
            return tuple(self._records)

    def _get(self, sig: str) -> WorkloadRecord:
        try:
            return self._records[sig]
        except KeyError:
            raise KeyError(f"unknown workload {sig!r}") from None

    # -- ingest ------------------------------------------------------------
    def observe(self, sig: str, config, measured) -> list[ModelEvent]:
        """Ingest one trace: ``config`` is a raw knob dict (encoded via
        the workload's SpaceEncoder) or an already-encoded ``(D,)`` row;
        ``measured`` is the ``(k,)`` observed objective vector in natural
        units.  Returns the events this observation triggered."""
        rec = self._get(sig)
        x = (rec.encoder.encode(config) if isinstance(config, dict)
             else np.asarray(config, dtype=np.float64).reshape(-1))
        y = np.asarray(measured, dtype=np.float64).reshape(-1)
        return self.observe_batch(sig, x[None, :], y[None, :])

    def observe_batch(self, sig: str, X, Y) -> list[ModelEvent]:
        """Bulk ingest of encoded rows: ``X (n, D)`` encoded configurations
        and ``Y (n, k)`` measured objectives in natural units."""
        events: list[ModelEvent] = []
        retrain_after = False
        with self._lock:
            rec = self._get(sig)
            X = np.asarray(X, dtype=np.float64).reshape(-1, rec.encoder.dim)
            Y = np.asarray(Y, dtype=np.float64).reshape(len(X), -1)
            if Y.shape[1] != rec.k:
                raise ValueError(
                    f"workload {rec.name!r}: expected {rec.k} objectives "
                    f"per trace, got {Y.shape[1]}")
            if not np.isfinite(X).all() or not np.isfinite(Y).all():
                raise ValueError("traces must be finite")
            rec.X.extend(X)
            rec.Y.extend(Y)
            rec.observed += len(X)
            drop = len(rec.X) - self.max_traces
            if drop > 0:
                del rec.X[:drop], rec.Y[:drop]
            if rec.active is not None:
                crossed = self._update_drift(rec, X, Y)
                if crossed and not rec.stale:
                    rec.stale = True
                    if self.trim_on_drift is not None:
                        # the pre-drift regime's rows describe a surface
                        # that no longer exists — keep only the recent
                        # window so retraining tracks the new one
                        del rec.X[:-self.trim_on_drift]
                        del rec.Y[:-self.trim_on_drift]
                    events.append(ModelEvent(
                        sig, "drift", rec.active.version,
                        {"rolling_error": rec.drift.rolling_error(),
                         "watermark": rec.drift.watermark(
                             rec.active.val_error)}))
                    retrain_after = self.retrain_on_drift
            if (self.retrain_every is not None
                    and rec.observed - rec.observed_at_train
                    >= self.retrain_every):
                retrain_after = True
            # an auto-retrain below the trainer's minimum would raise out
            # of the ingest call — wait for more traces instead
            retrain_after = retrain_after and len(rec.X) >= 4
        for ev in events:
            self._emit(ev)
        if retrain_after:
            events += self.retrain(sig).events
        return events

    def _update_drift(self, rec: WorkloadRecord, X: np.ndarray,
                      Y: np.ndarray) -> bool:
        """Score the active snapshot on the fresh rows; True iff the
        rolling watermark is crossed after folding them in."""
        pred = predict(rec.active.models, X).reshape(len(X), rec.k)
        rel = np.abs(pred - Y) / np.maximum(np.abs(Y), 1e-9)
        crossed = False
        for row_err in rel.mean(axis=1):
            crossed = rec.drift.update(float(row_err),
                                       rec.active.val_error) or crossed
        return crossed

    # -- training ----------------------------------------------------------
    def retrain(self, sig: str, trainer: TrainerConfig | None = None):
        """Gated retrain of one workload (see ``modelserver.trainer``):
        warm-start from the previous snapshot — or the nearest registered
        workload for a cold one — and promote (version bump + event) only
        on held-out validation improvement.  Returns a
        :class:`TrainReport`; the candidate is discarded on no-improve."""
        cfg = trainer if trainer is not None else self.trainer
        with self._lock:
            rec = self._get(sig)
            X = np.asarray(rec.X, dtype=np.float64)
            Y = np.asarray(rec.Y, dtype=np.float64)
            active = rec.active
            neighbor_params, neighbor_sig = None, None
            if active is None and cfg.backend == "mlp":
                neighbor_sig = self._nearest(rec)
                if neighbor_sig is not None:
                    neighbor_params = (
                        self._records[neighbor_sig].active.mlp_params())
            active_models = None if active is None else active.models
            active_params = None if active is None else active.mlp_params()
        # The multi-second fit runs OUTSIDE the registry lock: ingest
        # threads — and the service's task_spec()/recommend path, which
        # takes this lock while holding the service lock — must never
        # wait on training.  The snapshot above freezes the training set
        # and the gate baseline for this attempt.
        outcome = train_candidate(
            X, Y, cfg,
            active_models=active_models,
            active_params=active_params,
            neighbor_params=neighbor_params,
            neighbor_sig=neighbor_sig,
            device=self.device,
        )
        with self._lock:
            rec.train_attempts += 1
            rec.observed_at_train = rec.observed
            events: list[ModelEvent] = []
            if outcome.improved and rec.active is not active:
                # a concurrent retrain promoted while we were fitting: our
                # gate comparison is against a superseded baseline —
                # discard rather than clobber the newer snapshot
                outcome.improved = False
            if outcome.improved:
                snap = ModelSnapshot(
                    version=(1 if rec.active is None
                             else rec.active.version + 1),
                    models=outcome.models,
                    val_error=outcome.candidate_error,
                    n_traces=outcome.n_traces,
                    backend=cfg.backend,
                    warm_started_from=outcome.warm_started_from,
                )
                rec.snapshots.append(snap)
                del rec.snapshots[:-self.max_snapshots]
                rec.active = snap
                rec.stale = False
                rec.drift.reset()
                events.append(ModelEvent(
                    sig, "version", snap.version,
                    {"val_error": snap.val_error,
                     "previous_error": outcome.previous_error,
                     "warm_started_from": snap.warm_started_from}))
            report = TrainReport(workload=sig, outcome=outcome,
                                 version=(0 if rec.active is None
                                          else rec.active.version),
                                 events=events)
        for ev in events:
            self._emit(ev)
        if events and self.vault is not None:
            # write-behind durability: a promotion persists the record
            # (lineage + traces) so a restarted replica rehydrates at
            # this version.  Outside the lock: encode copies under it.
            self.persist_workload(sig)
        return report

    # -- durability (repro_torch.persist, DESIGN.md §13) -------------------
    def persist_workload(self, sig: str) -> bool:
        """Write-behind persist one workload record to the vault.

        Returns False when no vault is attached or the workload has no
        promoted snapshot yet (nothing a restart could serve)."""
        from ..persist import codecs

        if self.vault is None:
            return False
        with self._lock:
            rec = self._get(sig)
            if rec.active is None:
                return False
            arrays, meta = codecs.encode_workload(rec)
        self.vault.put_model(sig, arrays, meta)
        self.workloads_persisted += 1
        return True

    def rehydrate(self, vault=None) -> list[str]:
        """Load every persisted workload record from the vault (cold
        start), its models on this registry's device.  Returns the
        rehydrated signatures.

        Records already registered in this process are skipped (live
        state wins over disk).  Rehydrated records resume at their
        persisted snapshot lineage — ``task_spec`` serves the persisted
        model version immediately, with the exact pre-restart task
        signature — and start drift scoring fresh (see
        ``repro_torch.persist.codecs.encode_workload``).  No events are
        emitted: a restart is not a model change.
        """
        from ..persist import codecs

        vault = vault if vault is not None else self.vault
        if vault is None:
            return []
        loaded = []
        for wsig in vault.model_workloads():
            with self._lock:
                if wsig in self._records:
                    continue
            got = vault.get_model(wsig)
            if got is None:
                continue
            arrays, meta = got
            rec = codecs.decode_workload(arrays, meta,
                                         drift_config=self.drift_config,
                                         device=self.device)
            with self._lock:
                if rec.sig not in self._records:
                    self._records[rec.sig] = rec
                    self.workloads_rehydrated += 1
                    loaded.append(rec.sig)
        return loaded

    def nearest_workload(self, sig: str) -> str | None:
        """The workload whose trace embedding is nearest to ``sig``'s —
        the warm-start donor a cold retrain would use (None when no
        compatible candidate is registered)."""
        with self._lock:
            return self._nearest(self._get(sig))

    def _nearest(self, rec: WorkloadRecord) -> str | None:
        """Nearest registered workload by trace embedding, among those
        with an active snapshot of compatible shape (same encoded dim,
        same objective count, same MLP architecture)."""
        if not rec.X:
            return None
        query = trace_embedding(np.asarray(rec.X), np.asarray(rec.Y))
        candidates = {}
        for other in self._records.values():
            if other.sig == rec.sig or other.active is None or not other.X:
                continue
            if (other.encoder.dim != rec.encoder.dim or other.k != rec.k
                    or other.active.backend != "mlp"):
                continue
            candidates[other.sig] = trace_embedding(
                np.asarray(other.X), np.asarray(other.Y))
        return nearest_embedding(query, candidates)

    # -- the MOO-facing surface -------------------------------------------
    def task_spec(self, sig: str, preference: Preference | None = None,
                  alphas: Sequence[float] | None = None) -> TaskSpec:
        """The frozen-snapshot TaskSpec for a workload's tuning task.

        The spec's ``model_id`` carries ``(workload sig, version)``, so a
        version bump changes ``TaskSpec.signature()`` — downstream
        signature-keyed caches (compiled problems, MOGD solvers,
        frontiers) miss exactly when the model actually changed, and hit
        across re-submissions of the same version."""
        with self._lock:
            rec = self._get(sig)
            snap = rec.active
            if snap is None:
                raise RuntimeError(
                    f"workload {rec.name!r} has no trained model yet — "
                    f"observe traces and retrain first")
            psi_std = snap.psi_std()
            objectives = rec.objectives
            if alphas is not None:
                if psi_std is None:
                    raise ValueError(
                        "alphas need a predictive-std backend")
                objectives = tuple(
                    dataclasses.replace(o, alpha=float(a))
                    for o, a in zip(objectives, alphas))
            return TaskSpec(
                knobs=rec.knobs,
                objectives=objectives,
                model=snap.psi(),
                model_stds=psi_std,
                preference=(preference if preference is not None
                            else UtopiaNearest()),
                model_id=("modelserver", sig, snap.version),
                name=rec.name,
                # params-as-data split: sessions over different workloads
                # sharing this snapshot's architecture coalesce into one
                # executor dispatch, and a version bump reuses the
                # compiled program with the new weights as data
                program=snap.program(),
                device=self.device,
            )

    def snapshot(self, sig: str) -> ModelSnapshot | None:
        with self._lock:
            return self._get(sig).active

    def info(self, sig: str) -> dict:
        """Read-only workload status for dashboards / tests."""
        with self._lock:
            rec = self._get(sig)
            return {
                "name": rec.name,
                "traces": len(rec.X),
                "observed": rec.observed,
                "version": 0 if rec.active is None else rec.active.version,
                "val_error": (float("nan") if rec.active is None
                              else rec.active.val_error),
                "stale": rec.stale,
                "rolling_error": rec.drift.rolling_error(),
                "train_attempts": rec.train_attempts,
                "snapshots": len(rec.snapshots),
            }

    # -- eventing ----------------------------------------------------------
    def subscribe(self, callback: Callable[[ModelEvent], None]) -> None:
        with self._lock:
            if callback not in self._subscribers:
                self._subscribers.append(callback)

    def _emit(self, event: ModelEvent) -> None:
        with self._lock:
            subs = tuple(self._subscribers)
            self.events_emitted += 1
        for cb in subs:
            cb(event)


@dataclasses.dataclass
class TrainReport:
    """What one :meth:`ModelRegistry.retrain` call did."""

    workload: str
    outcome: TrainOutcome
    version: int  # active version after the attempt
    events: list  # [] when the candidate did not promote

    @property
    def improved(self) -> bool:
        return self.outcome.improved
