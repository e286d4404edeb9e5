"""Execution plans: per-(arch x shape) sharding rules + config adjustments.

This is where the cluster execution plan (the paper's "job configuration")
is materialized for the model substrate: FSDP span, expert sharding mode,
sequence sharding for decode, dtypes, remat.  ``baseline_plan`` is the
hand-written default; ``repro_torch.planner`` searches this space with
the paper's Progressive Frontier and returns overrides.  A mesh is a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` mapping
(see ``repro_torch.distributed.sharding``).
"""

from __future__ import annotations

import dataclasses

from ..distributed import ShardingRules, mesh_sizes
from ..nn import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class Plan:
    """Execution-plan knobs that the planner can override."""

    fsdp: bool = True              # ZeRO-3 param sharding over data axis
    remat: str = "dots"            # none | dots | full
    state_dtype: str = "float32"   # Adam moment dtype
    param_dtype: str = "float32"
    microbatches: int = 1
    seq_shard_all: bool = False    # decode cache seq over (pod,data,model)
    moe_impl: str = "einsum"       # einsum | gather
    pure_dp: bool = False          # no TP: batch over every mesh axis
    fsdp_span: str = "data"        # data | all (ZeRO-3 over every axis)
    moe_group: int = 0             # GShard dispatch group override (0=keep)
    grad_reduce_dtype: str = "float32"  # bf16 halves grad-reduction wire
    attn_chunk: int = 1024
    loss_chunk: int = 0


def baseline_plan(cfg: ArchConfig, shape: ShapeSpec) -> Plan:
    """The hand-written default plan of one (arch, shape) cell."""
    if shape.kind == "train":
        return Plan(fsdp=True, remat="dots")
    # serving: bf16 weights, no optimizer, no remat
    return Plan(
        fsdp=False, remat="none", param_dtype="bfloat16",
        seq_shard_all=(shape.name == "long_500k"),
        # 32k prefill: bigger flash blocks keep the unrolled causal-triangle
        # HLO at ~136 block pairs instead of 528
        attn_chunk=2048 if shape.kind == "prefill" else 1024,
    )


def apply_plan(cfg: ArchConfig, plan: Plan) -> ArchConfig:
    """The config with the plan's knobs threaded into it."""
    cfg = cfg.replace(
        remat=plan.remat, param_dtype=plan.param_dtype,
        state_dtype=plan.state_dtype, attn_chunk=plan.attn_chunk,
        loss_chunk=plan.loss_chunk, moe_impl=plan.moe_impl,
    )
    if plan.moe_group and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, group_size=plan.moe_group))
    return cfg


def rules_for(cfg: ArchConfig, shape: ShapeSpec, mesh,
              plan: Plan) -> ShardingRules:
    """The sharding rules of one (arch, shape, mesh) cell under ``plan``."""
    rules = ShardingRules(mesh)
    model_ways = mesh_sizes(mesh)["model"]
    over: dict[str, tuple] = {}
    if plan.fsdp:
        # fsdp_span="all" (ZeRO-3 over every axis) only composes with
        # pure_dp — under TP the model axis already carries weight dims.
        over["d_model"] = ("data",)
        over["d_model_out"] = ("data",)
    if cfg.moe is not None and cfg.moe.num_experts % model_ways:
        # EP impossible (60 or 8 experts on a 16-wide axis): fall back to
        # TP-inside-expert on the expert d_ff dim.
        over["expert"] = ()
        over["expert_ff"] = ("model",)
    if plan.pure_dp:
        # no-TP training plan: every mesh axis carries batch; weights
        # FSDP-shard over 'data' (fsdp_span=data; replicated over 'model')
        # or over every axis (fsdp_span=all; ZeRO-3 across the pod). Zero
        # per-layer activation collectives — only FSDP gathers + gradient
        # reduction remain on the wire.
        span = (("data", "model") if plan.fsdp_span == "all" else ("data",))
        over.update(
            batch=("pod", "data", "model"),
            attn_batch=("pod", "data", "model"),
            heads=(), kv_heads=(), kv_fused=(), d_ff=(), act_ff=(),
            vocab=(), expert=(), expert_ff=(), d_inner=(),
            d_model=span, d_model_out=span,
        )
        return rules.with_overrides(**over)
    if (not cfg.attn_free and shape.kind != "decode"
            and cfg.n_heads % model_ways):
        # heads can't shard the model axis (e.g. musicgen's 24 on 16):
        # run attention batch-parallel across the model axis instead of
        # replicated (§Perf iteration M1) — requires batch % all axes == 0,
        # otherwise logical_spec falls back to replication anyway.
        over["attn_batch"] = ("pod", "data", "model")
        over["heads"] = ()
        over["kv_heads"] = ()
    if plan.seq_shard_all:
        # tiny-batch long-context decode: the data axes are idle for batch,
        # spend them on the KV-cache sequence dim instead.
        over["seq_shard"] = ("pod", "data", "model")
        over["batch"] = ()
    return rules.with_overrides(**over)
