"""Codecs between in-memory model-server objects and vault entries.

Every codec is a pure pair ``encode_* -> (arrays, meta)`` /
``decode_*(arrays, meta) -> object`` where ``arrays`` is a flat
``{name: ndarray}`` dict (what :mod:`repro_torch.persist.store` persists as one
npz) and ``meta`` is JSON-serializable.  The invariant that makes warm
restarts signature-stable: knob and objective declarations round-trip
**exactly** (floats via JSON ``repr`` are bit-exact; tuples are restored
as tuples, which the ``_fingerprint`` machinery distinguishes from
lists), and a rehydrated workload keeps its *stored* signature rather
than recomputing it — so ``ModelRegistry.task_spec`` on a rehydrated
record reproduces the exact ``TaskSpec.signature()`` the pre-restart
process used, and vault lookups hit.

Regressor weights are stored as raw arrays in the reference's layout (the
same names, shapes and dtypes), so a workload one package writes the other
reads: tensors are copied to host numpy on encode, and rebuilt as torch
tensors on an explicit ``device`` on decode.
"""

from __future__ import annotations

import ast

import numpy as np
import torch


def pack(dst: dict, prefix: str, arrays: dict) -> None:
    """Merge ``arrays`` into ``dst`` under ``<prefix>/`` keys."""
    for k, v in arrays.items():
        dst[f"{prefix}/{k}"] = v


def unpack(arrays: dict, prefix: str) -> dict:
    """Inverse of :func:`pack`: the sub-dict stored under ``<prefix>/``."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


# -- knob / objective declarations (JSON side) ---------------------------


def knob_to_json(spec) -> dict:
    """One ``VariableSpec`` as a JSON-safe dict."""
    return {"name": spec.name, "kind": spec.kind, "low": spec.low,
            "high": spec.high, "choices": list(spec.choices)}


def knob_from_json(d: dict):
    """Rebuild a ``VariableSpec`` (choices restored as a tuple — the
    fingerprint distinguishes tuple from list)."""
    from ..core.problem import VariableSpec

    return VariableSpec(d["name"], d["kind"], low=d["low"], high=d["high"],
                        choices=tuple(d["choices"]))


def objective_to_json(obj) -> dict:
    """One ``Objective`` as a JSON-safe dict."""
    return {"name": obj.name, "direction": obj.direction,
            "bound": None if obj.bound is None else list(obj.bound),
            "alpha": obj.alpha}


def objective_from_json(d: dict):
    """Rebuild an ``Objective`` (bound restored as a tuple)."""
    from ..core.task import Objective

    bound = d["bound"]
    return Objective(d["name"], direction=d["direction"],
                     bound=None if bound is None else tuple(bound),
                     alpha=d["alpha"])


def key_to_json(key) -> str:
    """A workload's user key via ``repr`` (tuples/strings round-trip)."""
    return repr(key)


def key_from_json(s: str):
    """Inverse of :func:`key_to_json`; falls back to the raw string for
    keys whose repr is not a literal."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


# -- regressors ----------------------------------------------------------


def _host(t) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def encode_regressor(model) -> tuple[dict, dict]:
    """Serialize one per-objective surrogate (MLP or GP regressor)."""
    from ..models.gp import GPRegressor
    from ..models.mlp import MLPRegressor

    arrays: dict = {}
    if isinstance(model, MLPRegressor):
        meta = {"type": "mlp",
                "spec": {"in_dim": model.spec.in_dim,
                         "hidden": list(model.spec.hidden),
                         "out_dim": model.spec.out_dim,
                         "dropout": model.spec.dropout},
                "dropout": model.dropout,
                "log_target": bool(model.log_target),
                "n_layers": len(model.params)}
        for i, layer in enumerate(model.params):
            arrays[f"w{i}"] = _host(layer["w"])
            arrays[f"b{i}"] = _host(layer["b"])
    elif isinstance(model, GPRegressor):
        meta = {"type": "gp", "log_target": bool(model.log_target)}
        for name in ("x_train", "alpha", "chol", "lengthscale", "variance"):
            arrays[name] = _host(getattr(model, name))
    else:
        raise TypeError(
            f"cannot persist regressor of type {type(model).__name__}")
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        arrays[name] = _host(getattr(model, name))
    return arrays, meta


def decode_regressor(arrays: dict, meta: dict, device=None):
    """Inverse of :func:`encode_regressor`: the regressor's tensors on
    ``device`` (``None`` means ``cuda``), in the stored dtypes."""
    from ..kernels.platform import resolve_device

    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    moments = {name: t(arrays[name])
               for name in ("x_mean", "x_std", "y_mean", "y_std")}
    if meta["type"] == "mlp":
        from ..models.mlp import MLPRegressor, MLPSpec

        spec = MLPSpec(in_dim=meta["spec"]["in_dim"],
                       hidden=tuple(meta["spec"]["hidden"]),
                       out_dim=meta["spec"]["out_dim"],
                       dropout=meta["spec"]["dropout"])
        params = [{"w": t(arrays[f"w{i}"]), "b": t(arrays[f"b{i}"])}
                  for i in range(meta["n_layers"])]
        return MLPRegressor(spec=spec, params=params, dropout=meta["dropout"],
                            log_target=meta["log_target"], **moments)
    if meta["type"] == "gp":
        from ..models.gp import GPRegressor

        factors = {name: t(arrays[name])
                   for name in ("x_train", "alpha", "chol",
                                "lengthscale", "variance")}
        return GPRegressor(log_target=meta["log_target"],
                           **factors, **moments)
    raise ValueError(f"unknown regressor type {meta['type']!r}")


# -- model snapshots -----------------------------------------------------


def encode_snapshot(snap) -> tuple[dict, dict]:
    """Serialize one frozen ``ModelSnapshot`` (all k regressors)."""
    arrays: dict = {}
    models_meta = []
    for i, m in enumerate(snap.models):
        m_arrays, m_meta = encode_regressor(m)
        pack(arrays, f"m{i}", m_arrays)
        models_meta.append(m_meta)
    meta = {"version": snap.version,
            "val_error": snap.val_error,
            "n_traces": snap.n_traces,
            "backend": snap.backend,
            "warm_started_from": snap.warm_started_from,
            "models": models_meta}
    return arrays, meta


def decode_snapshot(arrays: dict, meta: dict, device=None):
    """Inverse of :func:`encode_snapshot` (regressors on ``device``)."""
    from ..modelserver.registry import ModelSnapshot

    models = tuple(
        decode_regressor(unpack(arrays, f"m{i}"), m_meta, device=device)
        for i, m_meta in enumerate(meta["models"]))
    return ModelSnapshot(
        version=meta["version"], models=models,
        val_error=meta["val_error"], n_traces=meta["n_traces"],
        backend=meta["backend"],
        warm_started_from=meta["warm_started_from"])


# -- workload records ----------------------------------------------------


def encode_workload(rec) -> tuple[dict, dict]:
    """Serialize one ``WorkloadRecord``: identity, traces, and the full
    retained snapshot lineage (``rec.snapshots``, active last).

    The drift detector's rolling window is deliberately NOT persisted —
    a restarted process starts drift scoring fresh against the restored
    snapshot's validation error (conservative: it can only *delay* the
    next drift signal by one window, never serve a regime the old
    process had already invalidated — invalidation tombstones the vault
    entry synchronously).
    """
    arrays: dict = {
        "X": np.asarray(rec.X, dtype=np.float64).reshape(
            len(rec.X), rec.encoder.dim),
        "Y": np.asarray(rec.Y, dtype=np.float64).reshape(len(rec.Y), rec.k),
    }
    snaps_meta = []
    for j, snap in enumerate(rec.snapshots):
        s_arrays, s_meta = encode_snapshot(snap)
        pack(arrays, f"s{j}", s_arrays)
        snaps_meta.append(s_meta)
    meta = {
        "sig": rec.sig,
        "key": key_to_json(rec.key),
        "name": rec.name,
        "knobs": [knob_to_json(s) for s in rec.knobs],
        "objectives": [objective_to_json(o) for o in rec.objectives],
        "observed": rec.observed,
        "observed_at_train": rec.observed_at_train,
        "train_attempts": rec.train_attempts,
        "snapshots": snaps_meta,
    }
    return arrays, meta


def decode_workload(arrays: dict, meta: dict, drift_config=None,
                    device=None):
    """Inverse of :func:`encode_workload` (regressors on ``device``).

    The record keeps its *stored* ``sig`` (never recomputed), rebuilds
    its encoder from the round-tripped knobs, reinstates the snapshot
    lineage with the last snapshot active, and starts a fresh drift
    detector (see :func:`encode_workload`).
    """
    from ..core.problem import SpaceEncoder
    from ..modelserver.drift import DriftConfig, DriftDetector
    from ..modelserver.registry import WorkloadRecord

    knobs = tuple(knob_from_json(d) for d in meta["knobs"])
    objectives = tuple(objective_from_json(d) for d in meta["objectives"])
    snapshots = [decode_snapshot(unpack(arrays, f"s{j}"), s_meta,
                                 device=device)
                 for j, s_meta in enumerate(meta["snapshots"])]
    encoder = SpaceEncoder(knobs)
    X = np.asarray(arrays["X"], dtype=np.float64).reshape(-1, encoder.dim)
    Y = np.asarray(arrays["Y"], dtype=np.float64).reshape(
        len(X), len(objectives))
    rec = WorkloadRecord(
        sig=meta["sig"], key=key_from_json(meta["key"]), knobs=knobs,
        objectives=objectives, name=meta["name"], encoder=encoder,
        X=list(X), Y=list(Y), snapshots=snapshots,
        active=snapshots[-1] if snapshots else None,
        drift=DriftDetector(
            drift_config if drift_config is not None else DriftConfig()),
        observed=meta["observed"],
        observed_at_train=meta["observed_at_train"],
        train_attempts=meta["train_attempts"],
    )
    return rec
