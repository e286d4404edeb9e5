"""Bridge from harvested systems traces to the model registry.

``data/harvest.py`` turns dry-run artifacts into ``(X encoded, Y, tags)``
rows over the planner's knob space; :func:`ingest_dryrun` registers the
corresponding workload (keyed by ``(arch, shape)``) and feeds those rows
into the registry — the systems-side instantiation of the paper's
trace-ingesting modeling engine.  ``root`` points the harvest at any
artifact directory (temp dirs in tests, a mounted results volume in
deployment); the repo-relative default is preserved.
"""

from __future__ import annotations

from .registry import ModelRegistry

DRYRUN_OBJECTIVES = ("compute_s", "memory_s", "collective_s")


def ingest_dryrun(registry: ModelRegistry, arch: str, shape: str,
                  root=None) -> tuple[str, int]:
    """Harvest one (arch, shape) cell into the registry.

    Returns ``(workload signature, rows ingested)``.  Idempotent
    registration: repeated calls append newly harvested rows to the same
    workload record."""
    from ..data.harvest import harvest
    from ..planner.space import plan_space

    sig = registry.register_workload(
        ("dryrun", arch, shape), plan_space(), DRYRUN_OBJECTIVES,
        name=f"dryrun:{arch}:{shape}")
    X, Y, _tags = harvest(arch, shape, directory=root)
    if len(X):
        registry.observe_batch(sig, X, Y)
    return sig, len(X)
