"""Quickstart on the PyTorch port: the paper's optimizer in a few lines.

Define a 2-objective problem over a mixed config space, compute its Pareto
frontier with Progressive Frontier (PF-AP) + the MOGD solver, and pick a
configuration with Weighted Utopia Nearest.  Runs on the card unless
``--device cpu``; ends with one JSON line of the kernels' launch counts.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import json

import torch

from repro_torch.core import (
    MOOProblem,
    boolean,
    categorical,
    continuous,
    integer,
    solve_pf,
    weighted_utopia_nearest,
)
from repro_torch.core.problem import SpaceEncoder
from repro_torch.kernels import platform

# 1. a mixed configuration space (the paper's Spark-like knobs)
SPECS = [
    integer("cores", 4, 64),
    continuous("memory_fraction", 0.2, 0.9),
    categorical("serializer", ("java", "kryo")),
    boolean("compress"),
]
ENC = SpaceEncoder(SPECS)
PREFERENCES = (("balanced", (0.5, 0.5)), ("latency-first", (0.9, 0.1)))


# 2. two conflicting objectives (minimize both): latency vs cloud cost
def objectives(x):
    cfg = ENC.decode_soft(x)
    cores = cfg["cores"]
    kryo = cfg["serializer"][..., 1]
    lat = 300.0 / cores ** 0.9 * (1.0 - 0.15 * kryo) \
        + 2.0 * (1.0 - cfg["memory_fraction"]) + 0.5 * cfg["compress"]
    cost = cores * (1.0 + 0.2 * cfg["compress"]) * 0.02
    return torch.stack([lat, cost])


def make_problem(device) -> MOOProblem:
    return MOOProblem(specs=SPECS, objectives=objectives, k=2,
                      names=("latency_s", "cost_usd"), device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    # 3. Pareto frontier via Progressive Frontier (approximate parallel)
    res = solve_pf(make_problem(device), mode="AP", n_probes=24,
                   device=device)
    print(f"frontier: {len(res.F)} points in {res.elapsed:.2f}s "
          f"(uncertain space {res.state.queue.uncertain_fraction:.1%}) "
          f"on {device}")
    for f, x in zip(res.F[:8], res.X[:8]):
        print(f"  lat={f[0]:7.2f}s  cost=${f[1]:6.3f}  <- {ENC.decode(x)}")

    # 4. recommend per application preference
    picks = {}
    for name, w in PREFERENCES:
        i = weighted_utopia_nearest(res.F, res.utopia, res.nadir, w)
        picks[name] = i
        print(f"{name:14s} -> {ENC.decode(res.X[i])}  f={res.F[i]}")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"result": res, "picks": picks, **counts}


if __name__ == "__main__":
    main()
