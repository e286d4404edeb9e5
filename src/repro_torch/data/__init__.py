"""Synthetic analytics workload families and trace generation for the
modeling engine (paper §6)."""

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
    "spark_space",
    "streaming_metrics",
    "streaming_problem",
    "streaming_suite",
]
