"""Data pipeline: synthetic workload families + trace generation for the
modeling engine (paper §6), and dry-run trace harvesting for the
execution planner."""

from .harvest import harvest, harvest_all
from .workloads import (
    BatchWorkload,
    StreamingWorkload,
    batch_cost,
    batch_latency,
    batch_problem,
    batch_suite,
    batch_task,
    default_config,
    generate_traces,
    spark_space,
    streaming_metrics,
    streaming_problem,
    streaming_suite,
)

__all__ = [
    "BatchWorkload",
    "StreamingWorkload",
    "batch_cost",
    "batch_latency",
    "batch_problem",
    "batch_suite",
    "batch_task",
    "default_config",
    "generate_traces",
    "harvest",
    "harvest_all",
    "spark_space",
    "streaming_metrics",
    "streaming_problem",
    "streaming_suite",
]
