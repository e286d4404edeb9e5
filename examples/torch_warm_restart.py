"""Durable frontier plane on the PyTorch port: warm restarts from the vault.

A registry-served workload is tuned, its Progressive Frontier state is
snapshotted into a content-addressed ``FrontierVault``, and the process
"dies".  A brand-new process (fresh registry, fresh service, nothing
shared but the vault directory) rehydrates the trained model, hits the
vault under the *same task signature*, and serves its first recommendation
from the imported frontier with zero probe dispatches.  Then the true
surface drifts: the drift event tombstones the durable frontier, and a
third restart comes up cold instead of serving a frontier from the dead
regime.  Runs on the card unless ``--device cpu``; ends with one JSON line
of the kernels' launch counts.

    PYTHONPATH=src python examples/torch_warm_restart.py [--device cpu]
"""

import argparse
import json
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import MOGDConfig, Objective, continuous
from repro_torch.kernels import platform
from repro_torch.modelserver import DriftConfig, ModelRegistry, TrainerConfig
from repro_torch.persist import FrontierVault
from repro_torch.service import MOOService

KNOBS = (continuous("scale", 0.0, 1.0),
         continuous("locality", 0.0, 1.0),
         continuous("mem_fraction", 0.0, 1.0))
MOGD = MOGDConfig(steps=50, multistart=4)


def measure(X, theta):
    """The 'real system': latency/cost with an efficient point at theta."""
    X = np.atleast_2d(X)
    pen = 2.0 * np.sum((X[:, 1:] - theta) ** 2, axis=1)
    return np.stack([0.3 + X[:, 0] + pen,
                     0.3 + (1.1 - X[:, 0]) + pen], axis=1)


def make_registry(vault, device) -> ModelRegistry:
    return ModelRegistry(
        TrainerConfig(hidden=(32, 32), max_epochs=60, seed=0),
        DriftConfig(window=16, min_obs=8, mult=2.5, floor=0.12),
        trim_on_drift=24,
        retrain_on_drift=True,
        vault=vault,  # promoted snapshots persist automatically
        device=device,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    root = tempfile.mkdtemp(prefix="vault_demo_")
    rng = np.random.default_rng(0)
    theta = np.array([0.2, 0.7])
    out = {}

    # -- generation 1: train, tune, persist, die -----------------------
    print(f"== generation 1: cold solve on {device} ==")
    vault = FrontierVault(root)
    reg = make_registry(vault, device)
    w = reg.register_workload(
        ("demo", "analytics-q7"), KNOBS,
        (Objective("latency_s"), Objective("cost_usd")))
    X = rng.random((320, 3))
    reg.observe_batch(w, X, measure(X, theta))
    reg.retrain(w)

    svc = MOOService(mogd=MOGD, batch_rects=4, grid_l=2, vault=vault,
                     device=device)
    t0 = time.perf_counter()
    sid = svc.create_session(reg.task_spec(w))
    svc.watch_workload(sid, reg, w)
    svc.run_until(min_probes=48)
    rec = svc.recommend(sid)
    print(f"  first recommend after {time.perf_counter() - t0:.2f}s "
          f"({svc.session_info(sid).probes} probes): {rec.objectives}")
    svc.close_session(sid)  # last-chance vault snapshot
    vault.flush()
    out["gen1"] = {"stats": svc.stats(), "objectives": rec.objectives}
    print(f"  vault snapshots: {out['gen1']['stats']['vault_snapshots']}")
    vault.close()

    # -- generation 2: cold process, warm state ------------------------
    print("== generation 2: warm restart ==")
    vault = FrontierVault(root)
    reg2 = make_registry(vault, device)
    rehydrated = reg2.rehydrate()
    print(f"  rehydrated workloads: {rehydrated}")
    svc2 = MOOService(mogd=MOGD, batch_rects=4, grid_l=2, vault=vault,
                      device=device)
    t0 = time.perf_counter()
    sid2 = svc2.create_workload_session(reg2, w)
    rec2 = svc2.recommend(sid2)
    st = svc2.stats()
    out["gen2"] = {"stats": st, "objectives": rec2.objectives,
                   "rehydrated": rehydrated}
    print(f"  first recommend after {time.perf_counter() - t0:.4f}s: "
          f"{rec2.objectives}")
    print(f"  restores={st['vault_restores']} "
          f"executor_dispatches={st['executor_dispatches']} "
          f"(zero: the frontier came from disk)")

    # -- drift: the durable frontier dies with its regime --------------
    print("== drift -> tombstone ==")
    theta_post = np.array([0.9, 0.1])
    Xd = rng.random((80, 3))
    out["drift_after"] = None
    for i in range(len(Xd)):
        evs = reg2.observe(w, Xd[i], measure(Xd[i:i + 1], theta_post)[0])
        if any(e.kind == "drift" for e in evs):
            out["drift_after"] = i + 1
            print(f"  drift detected after {i + 1} shifted traces")
            break
    out["drift"] = {"stats": svc2.stats(),
                    "surviving": vault.latest_for_workload(w)}
    print(f"  tombstones: {out['drift']['stats']['vault_tombstones']}, "
          f"surviving entry: {out['drift']['surviving']}")
    vault.close()

    # -- generation 3: post-drift restart must come up cold ------------
    print("== generation 3: post-drift restart ==")
    vault = FrontierVault(root)
    reg3 = make_registry(vault, device)
    reg3.rehydrate()
    svc3 = MOOService(mogd=MOGD, batch_rects=4, grid_l=2, vault=vault,
                      device=device)
    svc3.create_workload_session(reg3, w)
    st3 = svc3.stats()
    out["gen3"] = {"stats": st3}
    print(f"  restores={st3['vault_restores']} seeds={st3['vault_seeds']} "
          f"(cold: the stale frontier was never served)")
    vault.close()
    shutil.rmtree(root, ignore_errors=True)
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {**out, **counts}


if __name__ == "__main__":
    main()
