"""Smoke of the PyTorch port's optimizer: PF-AP on ZDT1 (known Pareto front
f2 = 1 - sqrt(f1) at x2.. = 0) against the WS, NC and NSGA-II baselines,
each scored by its hypervolume at (1.2, 1.2).  Runs on the card unless
``--device cpu``; ends with one JSON line of the kernels' launch counts.

    PYTHONPATH=src python scripts/torch_smoke_core.py [--device cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import (
    MOGDConfig,
    MOOProblem,
    continuous,
    hypervolume_2d,
    normalized_constraints,
    nsga2,
    solve_pf,
    weighted_sum,
)
from repro_torch.kernels import platform

HV_POINT = np.array([1.2, 1.2])


def make_zdt1(d=6, device=None) -> MOOProblem:
    specs = [continuous(f"x{i}", 0.0, 1.0) for i in range(d)]

    def obj(x):
        f1 = x[0]
        g = 1.0 + 9.0 * torch.mean(x[1:])
        f2 = g * (1.0 - torch.sqrt(torch.clamp(f1 / g, min=1e-12)))
        return torch.stack([f1, f2])

    return MOOProblem(specs=specs, objectives=obj, k=2, names=("f1", "f2"),
                      device=device)


def run(device, n_probes: int = 60,
        mogd: MOGDConfig = MOGDConfig(steps=100, multistart=8),
        baseline_probes: int = 10, evo_probes: int = 30,
        pop_size: int = 32) -> dict:
    """PF-AP, WS, NC and NSGA-II on one ZDT1 problem, in the script's
    order; returns each method's frontier, probes (PF-AP), HV and
    seconds, keyed ``pf``, ``ws``, ``nc``, ``evo``."""
    prob = make_zdt1(device=device)
    out = {}
    t0 = time.perf_counter()
    res = solve_pf(prob, mode="AP", n_probes=n_probes, mogd=mogd, grid_l=2,
                   device=device)
    out["pf"] = {"F": res.F, "probes": res.probes,
                 "hv": hypervolume_2d(res.F, HV_POINT),
                 "seconds": time.perf_counter() - t0,
                 "uncertain": res.state.queue.uncertain_fraction}
    for name, fn in (("ws", weighted_sum), ("nc", normalized_constraints)):
        t0 = time.perf_counter()
        r = fn(prob, n_probes=baseline_probes, device=device)
        out[name] = {"F": r.F, "hv": hypervolume_2d(r.F, HV_POINT),
                     "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    r = nsga2(prob, n_probes=evo_probes, pop_size=pop_size, device=device)
    out["evo"] = {"F": r.F, "hv": hypervolume_2d(r.F, HV_POINT),
                  "seconds": time.perf_counter() - t0}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    out = run(device)
    pf = out["pf"]
    print(f"PF-AP: {len(pf['F'])} pts in {pf['seconds']:.2f}s, "
          f"probes={pf['probes']}, unc={pf['uncertain']:.3f} ({device})")
    # true front: f2 = 1 - sqrt(f1); the residual of the points found
    resid = np.abs(pf["F"][:, 1] - (1 - np.sqrt(pf["F"][:, 0])))
    print("front residual: max", resid.max(), "mean", resid.mean())
    print("hv:", pf["hv"])
    for key, name in (("ws", "WS"), ("nc", "NC"), ("evo", "Evo")):
        r = out[key]
        print(f"{name}: {len(r['F'])} pts in {r['seconds']:.2f}s "
              f"hv={r['hv']:.3f}")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {**out, **counts}


if __name__ == "__main__":
    main()
