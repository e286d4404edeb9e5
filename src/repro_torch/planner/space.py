"""The execution-plan configuration space (the paper's §4.2 mixed space).

12 knobs — the TPU analogue of the paper's 12 most-important Spark
parameters (parallelism, executors, cores, memory, compression, ...):

    num_chips        categorical {64, 128, 256, 512}   (cluster size)
    model_parallel   categorical {1, 2, 4, 8, 16, 32}  (TP width)
    fsdp             boolean                           (ZeRO-3 span)
    microbatches     categorical {1, 2, 4, 8}
    remat            categorical {none, dots, full}
    param_dtype      categorical {float32, bfloat16}
    state_dtype      categorical {float32, bfloat16}   (Adam moments)
    grad_compress    boolean                           (int8 EF all-reduce)
    moe_impl         categorical {einsum, gather}
    attn_chunk       categorical {512, 1024, 2048, 4096}
    seq_shard_all    boolean                           (decode cache span)
    collective_dtype categorical {float32, bfloat16}   (grad reduce wire)

The one-hot + [0,1] relaxation, snapping, and decoding are inherited from
``repro_torch.core.problem`` — exactly the machinery the paper prescribes.
"""

from __future__ import annotations

from ..core.problem import VariableSpec, boolean, categorical
from ..launch.plans import Plan

PLAN_KNOBS: list[VariableSpec] = [
    categorical("num_chips", (64, 128, 256, 512)),
    categorical("model_parallel", (1, 2, 4, 8, 16, 32)),
    boolean("fsdp"),
    categorical("microbatches", (1, 2, 4, 8)),
    categorical("remat", ("none", "dots", "full")),
    categorical("param_dtype", ("float32", "bfloat16")),
    categorical("state_dtype", ("float32", "bfloat16")),
    boolean("grad_compress"),
    categorical("moe_impl", ("einsum", "gather")),
    categorical("attn_chunk", (512, 1024, 2048, 4096)),
    boolean("seq_shard_all"),
    categorical("collective_dtype", ("float32", "bfloat16")),
]


def plan_space() -> list[VariableSpec]:
    """A fresh list of the 12 plan knobs."""
    return list(PLAN_KNOBS)


def decode_plan(cfg_dict: dict) -> tuple[Plan, int, int]:
    """Raw knob dict -> (Plan, num_chips, model_parallel)."""
    plan = Plan(
        fsdp=bool(cfg_dict["fsdp"]),
        remat=cfg_dict["remat"],
        state_dtype=cfg_dict["state_dtype"],
        param_dtype=cfg_dict["param_dtype"],
        microbatches=int(cfg_dict["microbatches"]),
        seq_shard_all=bool(cfg_dict["seq_shard_all"]),
        moe_impl=cfg_dict["moe_impl"],
        attn_chunk=int(cfg_dict["attn_chunk"]),
    )
    return plan, int(cfg_dict["num_chips"]), int(cfg_dict["model_parallel"])
