"""The paper end to end on the PyTorch port: tune a Spark-like analytics job
with learned models (decoupled modeling engine) + Progressive Frontier +
WUN.

Pipeline (the paper's Fig. 1): traces -> DNN surrogates (modeling engine)
-> PF-AP on the surrogates -> WUN recommendation -> evaluate on "the
cluster" (the ground-truth model) -> compare against the default config.
Runs on the card unless ``--device cpu``; ends with one JSON line of the
kernels' launch counts.

    PYTHONPATH=src python examples/torch_tune_spark_analytics.py [--device cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import MOGDConfig, solve_pf, weighted_utopia_nearest
from repro_torch.data import (
    batch_problem,
    batch_suite,
    default_config,
    generate_traces,
)
from repro_torch.kernels import platform
from repro_torch.models import TrainConfig, fit_mlp, regression_report

WORKLOAD = 9  # "job 9", as in the paper's Fig. 4
OBJECTIVES = ("latency", "cost")
PREFERENCES = (("balanced", (0.5, 0.5)), ("latency-first", (0.9, 0.1)))


def fit_surrogates(X, Y, device, init_params=None) -> dict:
    """One (64, 64) MLP an objective, trained on log targets for 60 epochs;
    ``init_params`` (an objective name -> initial layers) replaces the
    He-init.  Returns name -> regressor."""
    models = {}
    for j, name in enumerate(OBJECTIVES):
        models[name] = fit_mlp(
            X, Y[:, j], hidden=(64, 64), config=TrainConfig(max_epochs=60),
            log_target=True,
            init_params=None if init_params is None else init_params[name],
            device=device)
    return models


def true_objectives(truth, x) -> np.ndarray:
    """The ground-truth model at one encoded point."""
    with torch.no_grad():
        f = truth.objectives(torch.as_tensor(np.asarray(x),
                                             dtype=torch.float32,
                                             device=truth.device))
    return f.cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    w = batch_suite()[WORKLOAD]
    truth = batch_problem(w, device=device)

    # --- modeling engine (runs asynchronously in production) -----------
    X, Y = generate_traces(truth, n=600, noise=0.08)
    models = fit_surrogates(X, Y, device)
    for j, name in enumerate(OBJECTIVES):
        rep = regression_report(models[name], X, Y[:, j])
        print(f"surrogate {name}: rel_err={rep['p50']:.1%} "
              f"(paper band: 10-40%)")

    surrogate = batch_problem(w, models=models, device=device)

    # --- MOO path (the on-demand, seconds-scale part) -------------------
    t0 = time.perf_counter()
    res = solve_pf(surrogate, mode="AP", n_probes=24,
                   mogd=MOGDConfig(steps=100, multistart=8), device=device)
    t_moo = time.perf_counter() - t0
    print(f"\nPF-AP: {len(res.F)} Pareto points in {t_moo:.2f}s on {device}")

    # --- recommend + evaluate on ground truth ---------------------------
    f_default = true_objectives(truth, truth.encoder.encode(default_config()))
    print(f"default config: latency={f_default[0]:.1f}s "
          f"cost=${f_default[1]:.3f}")
    picks = {}
    for name, weights in PREFERENCES:
        i = weighted_utopia_nearest(res.F, res.utopia, res.nadir, weights)
        f_true = true_objectives(truth, res.X[i])
        cfg = truth.encoder.decode(res.X[i])
        picks[name] = f_true
        print(f"{name:14s}: latency={f_true[0]:7.1f}s (-"
              f"{100 * (1 - f_true[0] / f_default[0]):.0f}%) "
              f"cost=${f_true[1]:.3f}  cores="
              f"{cfg['num_executors'] * cfg['cores_per_executor']}")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"result": res, "default": f_default, "picks": picks, **counts}


if __name__ == "__main__":
    main()
