"""Logical-axis sharding rules with divisibility fallbacks.

Every parameter and key activation is annotated with a tuple of *logical*
axis names (e.g. ``("layers", "d_model", "heads")``).  A
:class:`ShardingRules` table maps logical names to physical mesh axes
(``"data"``, ``"model"``, ``"pod"`` or ``None``).  :func:`logical_spec`
resolves a logical annotation + concrete shape into a partition spec,
dropping any mapping whose dimension is not divisible by the product of
the target mesh axes (the fallback is to replicate that dimension — never
to fail).

This is the rule half of the reference's ``distributed/sharding.py``:
the execution planner's plans (``launch/plans.py``) are built from it.
A mesh is any object with ``axis_names`` and a ``shape`` mapping from axis
name to size.  The spec is a plain tuple with one entry per dimension:
``None`` (replicated), one axis name, or a tuple of names — the entries of
the reference's ``PartitionSpec``, in order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

# Default logical -> physical mapping (single- or multi-pod production mesh).
# "batch" spans the pure-data axes; "fsdp" is an *extra* axis applied to one
# weight dimension when ZeRO-3-style parameter sharding is enabled.
LOGICAL_DEFAULTS: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    # attention-local batch: defaults to "batch"; when the head count can't
    # shard the model axis (e.g. musicgen's 24 heads on 16), the plan
    # re-points this at (pod, data, model) so attention runs batch-parallel
    # across the model axis instead of replicated (DESIGN.md §5)
    "attn_batch": ("pod", "data"),
    "seq": (),                # sequence replicated in train (sharded via "seq_shard")
    "seq_shard": ("model",),  # sequence-parallel regions (decode KV cache)
    "heads": ("model",),
    "kv_heads": ("model",),
    "embed": (),
    "act_ff": ("model",),
    # weights
    "layers": (),
    "vocab": ("model",),
    "d_model": (),
    "d_model_out": (),
    "kv_fused": ("model",),
    "d_ff": ("model",),
    "expert": ("model",),        # EP when divisible, else fallback chain
    "expert_ff": (),             # secondary: expert-internal d_ff
    "fsdp": ("data",),
    # rwkv / mamba inner dims
    "d_inner": ("model",),
    "d_state": (),
    "rwkv_heads": ("model",),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical->physical table + the mesh it applies to."""

    mesh: Any  # axis_names and shape {axis name: size}
    table: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(LOGICAL_DEFAULTS)
    )

    def with_overrides(self, **over: tuple[str, ...]) -> "ShardingRules":
        """A copy with some logical names re-pointed."""
        t = dict(self.table)
        t.update(over)
        return dataclasses.replace(self, table=t)

    def physical(self, logical: str) -> tuple[str, ...]:
        """The mesh axes a logical name maps to on this mesh."""
        axes = self.table.get(logical, ())
        # drop axes absent from this mesh (e.g. "pod" on the single-pod mesh)
        return tuple(a for a in axes if a in self.mesh.axis_names)


def axis_size(mesh, axes: Sequence[str]) -> int:
    """The product of the sizes of ``axes`` on ``mesh``."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def logical_spec(
    rules: ShardingRules,
    logical_axes: Sequence[str | None],
    shape: Sequence[int],
) -> tuple:
    """Resolve logical axis names for a concrete shape into a partition
    spec: a tuple of ``None``, an axis name or a tuple of axis names per
    dimension (the reference's ``PartitionSpec`` entries).

    Divisibility fallback: a dimension whose size is not divisible by the
    product of its mapped mesh axes falls back to the largest *prefix* of
    the axis tuple that does divide it (e.g. batch=256 on
    (pod=2, data=16, model=16) shards over (pod, data) and leaves model
    replicated), or full replication if none does.  A physical mesh axis is
    used at most once per spec (first logical dim wins).
    """
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    used: set[str] = set()
    parts = []
    for name, dim in zip(logical_axes, shape):
        if name is None:
            parts.append(None)
            continue
        phys = tuple(
            a for a in rules.physical(name) if a not in used
        )
        while phys and dim % axis_size(rules.mesh, phys) != 0:
            phys = phys[:-1]  # largest divisible prefix
        if phys:
            used.update(phys)
            parts.append(phys if len(phys) > 1 else phys[0])
        else:
            parts.append(None)  # fallback: replicate this dim
    return tuple(parts)
