"""Online trainer for per-workload objective surrogates.

The modeling engine half of the paper's architecture: (re)train per-
workload regressors asynchronously from observed traces, and hand the MOO
layer only *frozen* snapshots.  Three properties live here:

* **Warm starts** — retraining resumes from the previous snapshot's MLP
  parameters (``models.train.fit_mlp(init_params=...)``); a brand-new
  workload instead warm-starts from the *nearest registered workload* by
  trace embedding (the paper's answer to OtterTune-style workload
  mapping: map the unseen workload onto the closest known one, then
  specialize).
* **Validation-gated promotion** — a candidate only replaces the active
  snapshot when its error on a held-out validation split beats the active
  snapshot's error *on the same split*.  A retrain that learned nothing
  (or regressed) never bumps the version, so downstream frontier caches
  are never invalidated for noise.
* **One Ψ protocol** — both backends (MLP and exact GP) produce per-
  objective regressors that are differentiable torch callables
  ``x -> scalar`` with optional ``predict_std``, exactly what
  ``MOOProblem``/``TaskSpec`` already consume.

Everything is fit on one device (``device=None`` means ``cuda``); on the
card an MLP's gate and validation forwards run the fused-forward kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import TrainConfig, fit_gp, fit_mlp

Backend = ("mlp", "gp")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """How workload surrogates are (re)fit.

    ``val_frac`` is the *gate* split held out before fitting (fit_mlp's
    internal early-stopping split is separate and never sees it).
    ``min_improve`` demands a relative improvement margin before a
    version bump (0 = any strict improvement promotes).
    """

    backend: str = "mlp"
    hidden: tuple = (64, 64)
    max_epochs: int = 60
    lr: float = 3e-3
    dropout: float = 0.05
    val_frac: float = 0.2
    min_improve: float = 0.0
    log_target: bool = False
    gp_noise: float = 1e-2
    gp_max_points: int = 1024
    seed: int = 0

    def __post_init__(self):
        if self.backend not in Backend:
            raise ValueError(f"backend must be one of {Backend}, "
                             f"got {self.backend!r}")
        if not 0.0 < self.val_frac < 0.5:
            raise ValueError("val_frac must be in (0, 0.5)")
        if self.min_improve < 0.0:
            raise ValueError("min_improve must be >= 0")


@dataclasses.dataclass
class TrainOutcome:
    """Result of one (re)train attempt — whether or not it promoted."""

    improved: bool
    models: tuple  # (k,) per-objective regressors (candidate)
    candidate_error: float  # gate-split mean relative error
    previous_error: float  # active snapshot on the SAME split (inf if none)
    n_traces: int
    warm_started_from: str | None  # "self" | neighbor workload sig | None


def gate_split(n: int, val_frac: float, seed: int):
    """Deterministic held-out split for promotion gating.  Seeded by the
    trace count so a retrain on the *same* data reproduces the same split
    (candidate vs. active compare on identical rows)."""
    rng = np.random.default_rng(seed * 1_000_003 + n)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    return perm[n_val:], perm[:n_val]


def predict(models, X: np.ndarray) -> np.ndarray:
    """``(n, k)`` float64 predictions of a per-objective model tuple at the
    encoded rows ``X``: each forward on its model's device, the result on
    the host."""
    cols = []
    with torch.no_grad():
        for m in models:
            x = torch.as_tensor(np.asarray(X), dtype=torch.float32,
                                device=m.device)
            cols.append(m(x).reshape(-1).cpu().numpy().astype(np.float64))
    return np.stack(cols, axis=1)


def relative_error(models, X: np.ndarray, Y: np.ndarray) -> float:
    """Mean relative error of a per-objective model tuple on (X, Y),
    compared in float64 on the host after the forward."""
    pred = predict(models, X)
    errs = []
    for j in range(pred.shape[1]):
        y = np.asarray(Y[:, j], dtype=np.float64).reshape(-1)
        errs.append(np.abs(pred[:, j] - y) / np.maximum(np.abs(y), 1e-9))
    return float(np.mean(np.concatenate(errs)))


def fit_objective_models(
    X: np.ndarray,
    Y: np.ndarray,
    config: TrainerConfig,
    init_params: tuple | None = None,
    device=None,
) -> tuple:
    """Fit one regressor per objective column on ``device``;
    ``init_params`` is the warm-start handle (per-objective MLP parameter
    lists; ignored by the GP backend, whose 'warm start' is its data)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    k = Y.shape[1]
    models = []
    for j in range(k):
        if config.backend == "gp":
            models.append(fit_gp(
                X, Y[:, j], noise=config.gp_noise,
                max_points=config.gp_max_points, seed=config.seed,
                log_target=config.log_target, device=device))
        else:
            init = None if init_params is None else init_params[j]
            models.append(fit_mlp(
                X, Y[:, j], hidden=config.hidden,
                config=TrainConfig(lr=config.lr,
                                   max_epochs=config.max_epochs,
                                   dropout=config.dropout,
                                   seed=config.seed),
                log_target=config.log_target,
                init_params=init, device=device))
    return tuple(models)


def _init_compatible(params_per_obj, in_dim: int, hidden: tuple) -> bool:
    """True iff every per-objective parameter list matches the
    ``(in_dim, *hidden, 1)`` layer shapes this fit will use."""
    if params_per_obj is None:
        return False
    dims = (in_dim, *hidden, 1)
    expect = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    try:
        return all(
            [tuple(np.shape(layer["w"])) for layer in params] == expect
            for params in params_per_obj)
    except (KeyError, TypeError):
        return False


def train_candidate(
    X: np.ndarray,
    Y: np.ndarray,
    config: TrainerConfig,
    active_models: tuple | None = None,
    active_params: tuple | None = None,
    neighbor_params: tuple | None = None,
    neighbor_sig: str | None = None,
    device=None,
) -> TrainOutcome:
    """One gated (re)train: fit a candidate (warm-started when possible),
    score candidate and active snapshot on the same held-out split, and
    report whether the candidate earns a version bump.  Fits run on
    ``device`` (``None`` means ``cuda``)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64).reshape(len(X), -1)
    if len(X) < 4:
        raise ValueError(f"need >= 4 traces to train, have {len(X)}")
    tr, va = gate_split(len(X), config.val_frac, config.seed)
    init, origin = None, None
    if config.backend == "mlp":
        # a donor trained under a different `hidden` cannot seed this fit
        # — fall back to cold rather than crash fit_mlp's shape check
        if _init_compatible(active_params, X.shape[1], config.hidden):
            init, origin = active_params, "self"
        elif _init_compatible(neighbor_params, X.shape[1], config.hidden):
            init, origin = neighbor_params, neighbor_sig
    candidate = fit_objective_models(X[tr], Y[tr], config, init_params=init,
                                     device=device)
    cand_err = relative_error(candidate, X[va], Y[va])
    if init is not None:
        # Warm starts win when the surface moved a little; after a LARGE
        # shift the inherited basin (and mismatched standardization) can
        # trap Adam.  Hedge: also fit from scratch and keep whichever
        # candidate validates better on the same gate split.
        cold = fit_objective_models(X[tr], Y[tr], config, init_params=None,
                                    device=device)
        cold_err = relative_error(cold, X[va], Y[va])
        if cold_err < cand_err:
            candidate, cand_err, origin = cold, cold_err, None
    prev_err = (relative_error(active_models, X[va], Y[va])
                if active_models is not None else float("inf"))
    improved = cand_err < prev_err * (1.0 - config.min_improve) - 1e-12
    return TrainOutcome(
        improved=bool(improved),
        models=candidate,
        candidate_error=cand_err,
        previous_error=prev_err,
        n_traces=len(X),
        warm_started_from=origin,
    )


# ---------------------------------------------------------------------------
# Workload embedding (OtterTune-style workload mapping)
# ---------------------------------------------------------------------------


def trace_embedding(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Normalized trace summary used as the workload embedding.

    Per-objective log-scale location/spread plus the configuration-space
    occupancy moments: workloads whose traces describe similar cost
    surfaces land near each other, so a cold workload can warm-start from
    its nearest neighbor (paper §2.2 / OtterTune workload mapping)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64).reshape(len(X), -1)
    logy = np.log1p(np.abs(Y))
    emb = np.concatenate([
        logy.mean(axis=0), logy.std(axis=0),
        X.mean(axis=0), X.std(axis=0),
    ])
    return emb


def nearest_embedding(query: np.ndarray, candidates: dict) -> str | None:
    """Key of the candidate embedding nearest to ``query`` (Euclidean,
    equal-length embeddings only); None when no candidate qualifies."""
    best, best_d = None, float("inf")
    q = np.asarray(query, dtype=np.float64)
    for key, emb in candidates.items():
        e = np.asarray(emb, dtype=np.float64)
        if e.shape != q.shape:
            continue
        d = float(np.linalg.norm(e - q))
        if d < best_d:
            best, best_d = key, d
    return best
