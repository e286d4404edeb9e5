"""Unified probe-executor plane: structure-keyed programs with
params-as-data batching (DESIGN.md §10)."""

from .executor import (
    ParamProgram,
    ProbeExecutor,
    ProbeRequest,
    adam_project_descend,
    bucket,
    closure_program,
    default_executor,
    encoder_structure,
    orient_program,
    pad_rows,
    stack_programs,
    tree_map,
)

__all__ = [
    "ParamProgram",
    "ProbeExecutor",
    "ProbeRequest",
    "adam_project_descend",
    "bucket",
    "closure_program",
    "default_executor",
    "encoder_structure",
    "orient_program",
    "pad_rows",
    "stack_programs",
    "tree_map",
]
