"""Multi-tenant MOO service on the PyTorch port, driven by declarative
TaskSpecs.

Eight analytics tenants (recurring Spark-like jobs) submit *task
objectives* to one :class:`repro_torch.service.MOOService`: knobs,
objectives (with an enforced cost cap for a budget-constrained tenant) and
a per-tenant preference policy.  Structurally-equal specs share one
content-addressed compiled solver (every tenant builds fresh closures, and
their content fingerprints still match), and every service round
coalesces the pending probe work of all tenants into shared MOGD batches.
Runs on the card unless ``--device cpu``; ends with one JSON line of the
kernels' launch counts.

    PYTHONPATH=src python examples/torch_moo_service.py [--device cpu]
"""

import argparse
import json

import torch

from repro_torch.core import MOGDConfig, continuous, integer
from repro_torch.core.problem import SpaceEncoder
from repro_torch.kernels import platform
from repro_torch.service import (
    MOOService,
    Objective,
    TaskSpec,
    UtopiaNearest,
    WeightedUtopiaNearest,
)

# one recurring job template: latency vs cost over cluster knobs, with a
# per-tenant dataset scale folded into the objective model
SPECS = [integer("cores", 4, 64), continuous("mem_fraction", 0.2, 0.9)]
ENC = SpaceEncoder(SPECS)


def make_task(scale: float, weights=None, cost_cap=None,
              device=None) -> TaskSpec:
    """A tenant's declarative task: objectives, caps, preference."""

    def objectives(x):
        cfg = ENC.decode_soft(x)
        lat = scale * 120.0 / cfg["cores"] ** 0.9 + 2.0 * (1 - cfg["mem_fraction"])
        cost = cfg["cores"] * 0.02 * (1.0 + 0.1 * cfg["mem_fraction"])
        return torch.stack([lat, cost])

    return TaskSpec(
        knobs=SPECS,
        objectives=(
            Objective("latency_s"),
            Objective("cost_usd",
                      bound=None if cost_cap is None else (None, cost_cap)),
        ),
        model=objectives,
        preference=(WeightedUtopiaNearest(weights) if weights
                    else UtopiaNearest()),
        name="etl",
        device=device,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    svc = MOOService(mogd=MOGDConfig(steps=80, multistart=8), batch_rects=4,
                     device=device)

    # two recurring job classes, four tenants each; tenants re-build their
    # spec from scratch (fresh closures): content signatures still dedupe
    tenants = {}
    for i in range(8):
        scale = 1.0 if i < 4 else 3.5
        w = (0.8, 0.2) if i % 2 == 0 else (0.2, 0.8)
        tenants[f"tenant-{i}"] = svc.create_session(
            make_task(scale, weights=w, device=device))

    # drive all sessions together: probe work is coalesced per signature
    svc.run_until(min_probes=32)
    st = svc.stats()
    print(f"{st['sessions']} sessions | {st['compiled_solvers']} compiled "
          f"solvers ({st['solver_cache_hits']} cache hits) | "
          f"{st['coalesced_probes']} probes in {st['coalesced_batches']} "
          f"shared batches on {device}")

    # per-tenant recommendations: each session's own preference applies
    for name, sid in list(tenants.items())[:4]:
        rec = svc.recommend(sid)
        info = svc.session_info(sid)
        print(f"{name}: {rec.config} -> lat={rec.objectives[0]:.2f}s "
              f"cost=${rec.objectives[1]:.3f} "
              f"(frontier {rec.frontier_size}, probes {info.probes})")

    # a budget-capped tenant: the declared cost cap is *enforced*, the
    # frontier contains no plan above it
    sid_cap = svc.create_session(make_task(3.5, cost_cap=0.6, device=device))
    svc.probe(sid_cap, n_probes=32)
    rec = svc.recommend(sid_cap)
    F, _ = svc.frontier(sid_cap)
    print(f"capped tenant: cost<=0.6 -> max frontier cost "
          f"{F[:, 1].max():.3f}, pick lat={rec.objectives[0]:.2f}s "
          f"cost=${rec.objectives[1]:.3f}")

    # sessions are resumable: a tenant asks for a sharper frontier later
    sid0 = tenants["tenant-0"]
    before = svc.session_info(sid0).frontier_size
    svc.probe(sid0, n_probes=32)
    after = svc.session_info(sid0).frontier_size
    print(f"tenant-0 resumed: frontier {before} -> {after} points")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"stats": st, "capped_max_cost": float(F[:, 1].max()),
            "resumed": (before, after), **counts}


if __name__ == "__main__":
    main()
