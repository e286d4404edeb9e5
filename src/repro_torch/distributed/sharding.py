"""Logical-axis sharding rules with divisibility fallbacks.

Every parameter and key activation is annotated with a tuple of *logical*
axis names (e.g. ``("layers", "d_model", "heads")``).  A
:class:`ShardingRules` table maps logical names to physical mesh axes
(``"data"``, ``"model"``, ``"pod"`` or ``None``).  :func:`logical_spec`
resolves a logical annotation + concrete shape into a partition spec,
dropping any mapping whose dimension is not divisible by the product of
the target mesh axes (the fallback is to replicate that dimension — never
to fail).

The execution planner's plans (``launch/plans.py``) are built from the
rules.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` name the axes) or any object with ``axis_names`` and a
``shape`` mapping from axis name to size (a plain description, as the
planner and :class:`ProbeMesh` use).  The spec is a plain tuple with one
entry per dimension: ``None`` (replicated), one axis name, or a tuple of
names — the entries of the reference's ``PartitionSpec``, in order.

The tree half maps parameter trees onto a ``DeviceMesh``:
:func:`named_sharding_tree` gives each leaf its DTensor placements
(:func:`named_sharding` one leaf's ``(mesh, placements)`` pair, the
counterpart of the reference's ``NamedSharding``), :func:`shard_tree`
distributes the leaves (:func:`distribute_whole` one tensor), and
:func:`constrain` is the reference's ``with_sharding_constraint`` as a
``DTensor.redistribute``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping, Sequence

import torch


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
        names = mesh_axis_names(self.mesh)
        return tuple(a for a in axes if a in names)


def mesh_axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a plain mesh description."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a plain mesh
    description."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, axes: Sequence[str]) -> int:
    """The product of the sizes of ``axes`` on ``mesh``."""
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
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

    A dimension of size 1 has nothing to split and stays replicated, on
    mesh axes of size 1 too (DTensor cannot merge a sharded singleton dim
    into another, as a served slot's batch of one would ask on a one-rank
    mesh); but it resolves its axes as the reference does and takes them
    as used.  So on every dimension of size above 1 the spec equals the
    reference's ``tuple(logical_spec(...))``, and on a size-1 dimension
    the placement is the same: the only axes the reference can name there
    have size 1.
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
        used.update(phys)
        if phys and dim != 1:
            parts.append(phys if len(phys) > 1 else phys[0])
        else:
            parts.append(None)  # fallback, or a singleton: replicate
    return tuple(parts)


# ---------------------------------------------------------------------------
# Tree helpers: the port's parameters are dict/list trees of tensors, and
# ``nn.param_axes`` / ``nn.cache_axes`` build the mirrored trees of logical
# axes (a tuple per leaf, or None for a leaf left replicated).
# ---------------------------------------------------------------------------


def _map_leaves(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over ``tree``'s leaves, walking the dict/list
    structure of ``tree``; ``axes_tree``'s entry at a leaf is its axes."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, axes_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, a)
                          for v, a in zip(tree, axes_tree))
    return fn(tree, axes_tree)


def spec_tree(rules: ShardingRules, params, axes_tree):
    """Map a params tree + a mirrored logical-axes tree to partition specs
    (``()`` for a leaf whose axes are None, as the reference's ``P()``)."""

    def one(leaf, axes):
        if axes is None:
            return ()
        return logical_spec(rules, axes, tuple(leaf.shape))

    return _map_leaves(one, params, axes_tree)


def placements(mesh, spec: Sequence) -> list:
    """A partition spec as DTensor placements on ``mesh`` (a
    ``DeviceMesh``): each mesh dimension gets ``Shard(d)`` where entry
    ``d`` of the spec names that mesh axis, else ``Replicate()``.  An entry
    naming a tuple of axes shards its dimension over those mesh dimensions
    in order (major to minor, as the reference's ``PartitionSpec``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[names.index(a)] = Shard(d)
    return out


def named_sharding_tree(rules: ShardingRules, params, axes_tree):
    """Per leaf, its DTensor placement list on ``rules.mesh``."""
    def one(leaf, axes):
        spec = () if axes is None else logical_spec(
            rules, axes, tuple(leaf.shape))
        return placements(rules.mesh, spec)

    return _map_leaves(one, params, axes_tree)


def named_sharding(rules: ShardingRules, logical_axes, shape) -> tuple:
    """The counterpart of the reference's ``NamedSharding`` for one leaf
    of ``shape`` with ``logical_axes``: a ``(mesh, placements)`` pair."""
    spec = logical_spec(rules, logical_axes, tuple(shape))
    return rules.mesh, placements(rules.mesh, spec)


def distribute_whole(t: torch.Tensor, mesh, pl):
    """``t``, which holds the same values on every rank, as a DTensor on
    ``mesh`` with placements ``pl``: each rank keeps its own shard of it
    (nothing is sent)."""
    from torch.distributed.tensor import DTensor

    rep = DTensor.from_local(t, mesh, placements(mesh, ()), run_check=False)
    return rep.redistribute(mesh, pl)


def shard_tree(rules: ShardingRules, params, axes_tree):
    """``params`` distributed over ``rules.mesh`` by their logical axes:
    each leaf becomes a DTensor with :func:`named_sharding_tree`'s
    placements.  A leaf is taken to hold the same values on every rank
    (:func:`distribute_whole`)."""
    places = named_sharding_tree(rules, params, axes_tree)
    return _map_leaves(lambda leaf, pl: distribute_whole(leaf, rules.mesh,
                                                         pl),
                       params, places)


class _Constrain(torch.autograd.Function):
    """Redistribute forward, and the gradient to the same placements
    backward: the transpose of a sharding constraint is the same
    constraint on the cotangent (a partial gradient is reduced there, as
    the reference's GSPMD reduces it, rather than carried on)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pl), None


def constrain(x, rules: ShardingRules | None, *logical_axes):
    """``with_sharding_constraint`` by logical names: ``x`` redistributed
    to the placements the rules give its shape, and its gradient likewise
    (a no-op without rules or on a plain tensor)."""
    if rules is None or not is_dtensor(x):
        return x
    spec = logical_spec(rules, logical_axes, tuple(x.shape))
    return pin(x, placements(x.device_mesh, spec))


def pin(x, pl):
    """The DTensor ``x`` redistributed to placements ``pl``, and its
    gradient likewise (:func:`constrain` by placements)."""
    pl = tuple(pl)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.redistribute(x.device_mesh, pl)
    return _Constrain.apply(x, pl)


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (without importing
    the distributed package where it is not loaded yet)."""
    return type(x).__name__ == "DTensor"


# ---------------------------------------------------------------------------
# The probe executor's mesh
# ---------------------------------------------------------------------------


class ProbeMesh:
    """A 1-D mesh for the probe executor's batch axis: ``axis_names``,
    ``shape`` (``{axis: n}``) and the ``devices`` the ``n`` shards run on.

    A device may be listed more than once: shards on the same device run
    one after the other.  This stands in for the reference's forced host
    devices (``--xla_force_host_platform_device_count``), on the host and
    for a multi-shard run on one card."""

    def __init__(self, devices, axis: str = "probe"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a probe mesh needs at least one device")
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    def __repr__(self) -> str:
        return f"ProbeMesh({[str(d) for d in self.devices]}, " \
               f"axis={self.axis_names[0]!r})"


def probe_mesh(n_devices: int | None = None, axis: str = "probe",
               device=None) -> ProbeMesh:
    """A 1-D mesh over the CUDA devices for the probe executor's batch axis
    (``ProbeExecutor(mesh=probe_mesh())`` splits each padded probe batch
    across them; rows are independent descents, no collectives).  On one
    device the executor's fallback makes this a no-op.  Raises when asked
    for more devices than exist, and on a host without CUDA.

    ``device="cpu"`` (or another device) builds the mesh over that one
    device listed ``n_devices`` times (default 1): the host's stand-in."""
    if device is not None:
        return ProbeMesh([device] * (n_devices or 1), axis)
    from ..kernels.platform import resolve_device

    resolve_device(None)  # raises on a host without CUDA
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"asked for {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return ProbeMesh(devices, axis)


def choose_probe_partition(n_devices: int, G: int, R: int) -> tuple:
    """Partitioning policy for the probe-executor batch (DESIGN.md §11).

    Given the tenant mix's wanted ``(G groups, R rows-per-group)`` bucket,
    pick which axis to shard over ``n_devices`` and the device-divisible
    bucket sizes — the executor calls this instead of requiring callers
    to lay out device-friendly batches themselves.  Returns
    ``(axis, Gp, Rp)`` with ``axis`` in ``{"group", "row", None}``.

    The choice minimizes padded batch cells (``Gp * Rp``): a many-tenant
    mix (G >= devices) shards groups, a few-tenants/many-cells mix (a
    single PF session's grid) shards rows.  Ties prefer the group axis —
    sharded groups keep each tenant's surrogate weights device-local,
    while row sharding replicates every group's params on all devices.
    On one device there is nothing to shard (``axis=None``).
    """
    if n_devices <= 1:
        return None, G, R

    def up(x: int) -> int:
        return -(-x // n_devices) * n_devices

    axis, Gp, Rp = min(
        (("group", up(G), R), ("row", G, up(R))),
        key=lambda c: (c[1] * c[2], c[0] != "group"))
    return axis, Gp, Rp


def constrain_tree(rules: ShardingRules | None, tree, axes_tree):
    """:func:`constrain` over a tree's leaves by a mirrored logical-axes
    tree (None axes: replicated)."""
    if rules is None:
        return tree

    def one(leaf, axes):
        if axes is None:
            axes = (None,) * leaf.dim()
        return constrain(leaf, rules, *axes)

    return _map_leaves(one, tree, axes_tree)


_REGION_DEPTH = [0]


@contextlib.contextmanager
def sharded_region(rules: ShardingRules | None):
    """The context a sharded program runs in: with rules, plain tensors
    that meet DTensors (positions, masks, zero states) are taken as
    replicated (``implicit_replication``); without, nothing.  Regions
    nest: only the outermost one switches the setting (``implicit_
    replication`` itself turns it off on every exit)."""
    if rules is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _REGION_DEPTH[0] += 1
    try:
        if _REGION_DEPTH[0] > 1:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _REGION_DEPTH[0] -= 1


def split_last(x, n: int):
    """``x`` (..., n * d) viewed as (..., n, d).  A DTensor sharded on its
    last dim over more ranks than divide ``n`` is first gathered on it
    (DTensor cannot split a dim unevenly sharded), as the reference's
    GQA fallback replicates KV heads that cannot shard."""
    d = x.shape[-1] // n
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = Shard(x.dim() - 1)
        ways = 1
        for i, p in enumerate(x.placements):
            if p == last:
                ways *= x.device_mesh.size(i)
        if n % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == last else p for p in x.placements])
    return x.reshape(*x.shape[:-1], n, d)


def gather_over(x, axes: Sequence[str]):
    """``x`` made whole over the mesh ``axes`` (a DTensor's placements on
    them become ``Replicate``; a plain tensor is returned as it is).  The
    model gathers its FSDP-sharded weights over the batch's axes before
    computing with them, as GSPMD does for the reference; the backward
    reduce-scatters their gradients."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    names = mesh_axis_names(x.device_mesh)
    pl = [Replicate() if names[i] in axes else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def grad_placements(param_pl, act_pl) -> list:
    """The placements of an input's gradient from a ``local_map`` region:
    partial (summed over ranks) on the mesh dims where the activations
    are split and the input is whole, else the input's own."""
    from torch.distributed.tensor import Partial

    return [Partial() if (not p.is_shard() and a.is_shard()) else p
            for p, a in zip(param_pl, act_pl)]
