"""Distribution layer: logical sharding rules with divisibility fallbacks.

The model substrate annotates parameters with *logical axis names*; this
package maps them onto physical mesh axes per a :class:`ShardingRules`
table, with automatic fallbacks when a dimension is not divisible by the
mesh axis (e.g. 8 kv-heads on a 16-wide model axis).  The execution
planner's plans are built from these rules.
"""

from .sharding import LOGICAL_DEFAULTS, ShardingRules, axis_size, logical_spec

__all__ = ["LOGICAL_DEFAULTS", "ShardingRules", "axis_size", "logical_spec"]
