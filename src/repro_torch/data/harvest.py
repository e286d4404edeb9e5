"""Dry-run trace harvesting: turn results/dryrun/*.json artifacts into
(plan-knob vector -> roofline terms) training rows for the surrogate
models — the paper's modeling engine consuming *systems* traces.

Each artifact records the plan it was compiled with (``rec["plan"]``);
rows encode the plan through the same SpaceEncoder the planner searches,
so a fitted surrogate is directly usable as the Ψ of a plan-space
MOOProblem (``repro_torch.planner``).  With handfuls of artifacts per cell the
surrogates are intentionally low-capacity; the analytic calibrated model
remains the default and the surrogate path demonstrates the decoupling.

The port's dry-run runs a MoE model's experts as the plan shards them
(``nn.moe``: EP, or TP inside the experts), and its artifacts carry a
``"moe"`` record; :func:`harvest` takes them.  An artifact marked
``"expert_parallel": false`` without that record comes from an earlier
dry-run that gathered every expert on every rank, another plan than the
one its ``plan`` names, so :func:`harvest` leaves it out.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from ..core.problem import SpaceEncoder
from ..planner.space import plan_space

# Default artifact root, resolved per call (NOT at import): it is relative
# to the *current* working directory, so callers that need a stable or
# sandboxed location (tests, the model-server ingest path) pass an explicit
# ``directory=`` instead of relying on where the process was launched.
DRYRUN_DIR = pathlib.Path("results/dryrun")


def _resolve_root(directory) -> pathlib.Path:
    """Explicit root argument threading: ``None`` keeps the historical
    cwd-relative default; anything else (str/Path) is used as-is."""
    return DRYRUN_DIR if directory is None else pathlib.Path(directory)

_CANON = {
    "num_chips": {"16x16": 256, "2x16x16": 512},
}


def _plan_to_knobs(rec: dict) -> dict:
    """The plan knobs an artifact was compiled with (defaults where its
    record names none)."""
    p = rec.get("plan", {})
    return {
        "num_chips": _CANON["num_chips"].get(rec.get("mesh"), 256),
        "model_parallel": 1 if p.get("pure_dp") else 16,
        "fsdp": bool(p.get("fsdp", True)),
        "microbatches": int(p.get("microbatches", 1)),
        "remat": p.get("remat", "dots"),
        "param_dtype": p.get("param_dtype", "float32"),
        "state_dtype": p.get("state_dtype", "float32"),
        "grad_compress": False,
        "moe_impl": p.get("moe_impl", "einsum"),
        "attn_chunk": int(p.get("attn_chunk", 1024)),
        "seq_shard_all": bool(p.get("seq_shard_all", False)),
        "collective_dtype": p.get("grad_reduce_dtype", "float32"),
    }


def harvest(arch: str, shape: str, directory=None):
    """Rows for one (arch, shape): (X encoded (n, D), Y (n, 3) seconds
    [compute, memory, collective], tags).  ``directory`` overrides the
    cwd-relative artifact root (``None`` -> ``DRYRUN_DIR``).  Artifacts
    marked ``"expert_parallel": false`` without a ``"moe"`` record (an
    earlier dry-run's, every expert gathered) are left out."""
    directory = _resolve_root(directory)
    enc = SpaceEncoder(plan_space())
    X, Y, tags = [], [], []
    for p in sorted(directory.glob(f"{arch}__{shape}__*.json")):
        rec = json.loads(p.read_text())
        if rec.get("expert_parallel") is False and "moe" not in rec:
            continue
        r = rec["roofline"]
        X.append(enc.encode(_plan_to_knobs(rec)))
        Y.append([r["compute_s"], r["memory_s"], r["collective_s"]])
        parts = p.stem.split("__")
        tags.append(parts[3] if len(parts) > 3 else "baseline")
    return np.asarray(X), np.asarray(Y), tags


def harvest_all(directory=None):
    """All artifacts as one table keyed by (arch, shape); ``directory``
    as in :func:`harvest`."""
    directory = _resolve_root(directory)
    out = {}
    for p in sorted(directory.glob("*.json")):
        arch, shape = p.stem.split("__")[:2]
        out.setdefault((arch, shape), None)
    return {k: harvest(k[0], k[1], directory) for k in out}
