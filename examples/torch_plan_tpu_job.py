"""Plan a training/serving job of the planned fleet with the paper's
optimizer, on the PyTorch port: PF-AP over the 12-knob execution-plan
space, calibrated against the dry-run artifacts when present, and an
elastic replan event.

The latencies and dollars printed are the predictions of the planner's
cost model for the fleet it plans (``launch.roofline.FleetSpec``, by
default the reference's TPU v5e constants), not measurements of the device
this script runs on.  The optimizer runs on the card unless ``--device
cpu``; the script ends with one JSON line of the kernels' launch counts.

    PYTHONPATH=src python examples/torch_plan_tpu_job.py \
        [--arch grok-1-314b] [--shape train_4k] [--device cpu]
"""

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.kernels import platform
from repro_torch.planner import plan_job, replan_elastic

SURVIVING_CHIPS = 192


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="grok-1-314b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    cfg = get_config(args.arch)
    print(f"planning {args.arch} x {args.shape} "
          f"({cfg.param_count() / 1e9:.0f}B params) on {device}; latencies "
          f"and dollars are the planned fleet's cost-model predictions\n")

    rec = plan_job(cfg, args.shape, weights=(0.5, 0.5), n_probes=24,
                   deadline_s=None, device=device)
    print(f"frontier: {len(rec.frontier_F)} plans in {rec.elapsed_s:.2f}s")
    for f, (plan, chips, tp) in zip(rec.frontier_F[:6],
                                    rec.frontier_plans[:6]):
        print(f"  lat={f[0]:6.2f}s cost=${f[1]:7.4f}  chips={chips:3d} "
              f"tp={tp:2d} remat={plan.remat} pdt={plan.param_dtype[:4]} "
              f"sdt={plan.state_dtype[:4]} mb={plan.microbatches}")

    print(f"\nbalanced recommendation: {rec.num_chips} chips, "
          f"tp={rec.model_parallel}, {rec.plan}")
    print(f"  -> predicted latency {rec.objectives[0]:.2f}s/step, "
          f"${rec.objectives[1] * 3600 / max(rec.objectives[0], 1e-9):,.0f}/h")

    # a node fails: replan for the survivors under the paper's 2.5s deadline
    el = replan_elastic(cfg, args.shape, surviving_chips=SURVIVING_CHIPS,
                        device=device)
    print(f"\nelastic replan ({SURVIVING_CHIPS} chips survive, "
          f"{el.elapsed_s:.2f}s): {el.num_chips} chips, "
          f"tp={el.model_parallel}, predicted lat={el.objectives[0]:.2f}s")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"plan": rec, "elastic": el, **counts}


if __name__ == "__main__":
    main()
