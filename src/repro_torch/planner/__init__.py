"""Cluster execution planner: the paper's Progressive Frontier MOO applied
to accelerator-fleet execution plans.

The paper chooses Spark job configurations (cores, executors, memory, ...)
under multiple objectives; here the "job configuration" is the cluster
execution plan of a training/serving job (chips, TP width, FSDP, remat,
microbatch, dtypes, ...), the objectives are step latency / $-cost /
energy (with an HBM-fit constraint), and the predictive models Ψ are
(a) a differentiable analytic roofline model calibrated per (arch, shape)
and (b) DNN/GP surrogates trained on dry-run traces — the paper's
decoupled modeling engine.  The fleet's hardware is a
:class:`~repro_torch.launch.roofline.FleetSpec` (the reference's TPU v5e
fleet by default).
"""

from .space import PLAN_KNOBS, decode_plan, plan_space
from .cost_model import CHIP_COST_PER_S, HBM_BYTES, PlanModel
from .planner import (
    JobPlanRecommendation,
    PlanRecommendation,
    plan_dag,
    plan_job,
    replan_elastic,
)

__all__ = [
    "CHIP_COST_PER_S", "HBM_BYTES", "JobPlanRecommendation", "PLAN_KNOBS",
    "PlanModel", "PlanRecommendation", "decode_plan", "plan_dag", "plan_job",
    "plan_space", "replan_elastic",
]
