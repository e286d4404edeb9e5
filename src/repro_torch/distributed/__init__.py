"""Distribution layer: logical sharding rules with divisibility fallbacks,
activation constraints, and collective helpers (compressed all-reduce).

The model substrate annotates parameters with *logical axis names*
(``nn.param_axes``); this package maps them onto physical mesh axes per a
:class:`ShardingRules` table, with automatic fallbacks when a dimension is
not divisible by the mesh axis (e.g. 8 kv-heads on a 16-wide model axis),
and onto DTensor placements on a ``DeviceMesh``.  The execution planner's
plans are built from these rules.
"""

from .sharding import (
    LOGICAL_DEFAULTS,
    ProbeMesh,
    ShardingRules,
    axis_size,
    choose_probe_partition,
    constrain,
    constrain_tree,
    distribute_whole,
    gather_over,
    grad_placements,
    is_dtensor,
    logical_spec,
    mesh_axis_names,
    mesh_sizes,
    named_sharding,
    named_sharding_tree,
    pin,
    placements,
    probe_mesh,
    shard_tree,
    sharded_region,
    spec_tree,
    split_last,
)
from .debug import COLLECTIVE_KINDS, collective_log
from .collectives import (
    compressed_psum,
    dequantize_int8,
    quantize_int8,
)

__all__ = [k for k in dir() if not k.startswith("_")]
