"""Multi-stage job tuning on the PyTorch port: per-stage frontiers composed
along a DAG.

A 5-stage Spark-like analytics job (extract -> two parallel transforms ->
join -> report) where every stage has its own (parallelism, mem_frac)
subspace.  Each stage's Pareto frontier is solved with cross-stage batched
probes (one MOGD dispatch per round: all stages share a StageFamily),
composed along the DAG (latency over the critical path, cost summed over
all stages), and one preference pick returns a configuration per stage.
Runs on the card unless ``--device cpu``; ends with one JSON line of the
kernels' launch counts.

    PYTHONPATH=src python examples/torch_multistage_job.py [--device cpu]
"""

import argparse
import json

import numpy as np

from repro_torch.core import JobDAG, WeightedUtopiaNearest, make_analytics_family
from repro_torch.kernels import platform
from repro_torch.planner import plan_job
from repro_torch.service import MOOService


def build_job(device=None) -> JobDAG:
    fam = make_analytics_family(device=device)
    # theta = (work, base_s, mem_sensitivity, price) per stage
    stages = [
        fam.stage("extract", (3.0, 0.4, 0.3, 0.6)),
        fam.stage("transform_a", (2.0, 0.2, 0.9, 0.8)),
        fam.stage("transform_b", (4.5, 0.3, 0.5, 0.5)),
        fam.stage("join", (2.5, 0.5, 1.2, 1.0)),
        fam.stage("report", (1.0, 0.1, 0.2, 0.4)),
    ]
    edges = [
        ("extract", "transform_a"),
        ("extract", "transform_b"),
        ("transform_a", "join"),
        ("transform_b", "join"),
        ("join", "report"),
    ]
    return JobDAG(stages, edges, name="etl")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    dag = build_job(device)
    print(f"job {dag.name!r}: stages {dag.stage_names} on {device}")
    print(f"topological order: {dag.topo_order()}")
    print(f"compose operators: {dict(zip(dag.objective_names, dag.compose))}")

    # -- one-shot planning: batched per-stage PF + composition ----------
    rec = plan_job(dag, n_probes=24,
                   preference=WeightedUtopiaNearest((0.7, 0.3)),
                   device=device)
    print(f"\ncomposed frontier: {len(rec.frontier_F)} points "
          f"({rec.probes} probes across all stages)")
    lat, cost = rec.objectives
    print(f"picked (latency={lat:.2f}s, cost=${cost:.2f}); per-stage:")
    for name, cfg in rec.stage_configs.items():
        print(f"  {name:12s} parallelism={cfg['parallelism']:.2f} "
              f"mem_frac={cfg['mem_frac']:.2f}")

    # -- the same job as a long-lived service session -------------------
    svc = MOOService(batch_rects=4, device=device)
    did = svc.create_dag_session(dag)
    svc.run_until(min_probes=24)  # stage probes coalesce across sessions
    srec = svc.recommend_dag(did)
    print(f"\nservice DAG session: frontier {srec.frontier_size}, "
          f"objectives {np.round(srec.objectives, 3)}")
    st = svc.stats()
    print(f"child sessions: {st['sessions']} "
          f"(coalesced batches: {st['coalesced_batches']})")

    # a re-submitted recurring job (fresh closures) reuses everything
    did2 = svc.create_dag_session(build_job(device))
    st2 = svc.stats()
    print(f"re-submitted job: problem cache hits {st2['problem_cache_hits']} "
          f"(one per stage: no recompilation)")
    svc.close_dag_session(did2)
    svc.close_dag_session(did)
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"dag": dag, "plan": rec, "service": srec, "stats": st,
            "resubmitted": st2, **counts}


if __name__ == "__main__":
    main()
