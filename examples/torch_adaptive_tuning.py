"""Adaptive tuning with the online model server, on the PyTorch port.

A workload's traces stream into a ModelRegistry; the MOO service session
watches it.  Mid-stream the true cost surface shifts: drift crosses the
rolling watermark, the session's frontier is invalidated, an inline
retrain promotes a new model version, and the next probe pass warm
re-solves Progressive Frontier seeded with the prior frontier, while
``recommend`` keeps answering from the last good frontier throughout.
Runs on the card unless ``--device cpu``; ends with one JSON line of the
kernels' launch counts.

    PYTHONPATH=src python examples/torch_adaptive_tuning.py [--device cpu]
"""

import argparse
import json

import numpy as np

from repro_torch.core import MOGDConfig, Objective, continuous
from repro_torch.kernels import platform
from repro_torch.modelserver import DriftConfig, ModelRegistry, TrainerConfig
from repro_torch.service import MOOService

KNOBS = (continuous("scale", 0.0, 1.0),
         continuous("locality", 0.0, 1.0),
         continuous("mem_fraction", 0.0, 1.0))


def measure(X, theta):
    """The 'real system': latency/cost with an efficient point at theta."""
    X = np.atleast_2d(X)
    pen = 2.0 * np.sum((X[:, 1:] - theta) ** 2, axis=1)
    return np.stack([0.3 + X[:, 0] + pen,
                     0.3 + (1.1 - X[:, 0]) + pen], axis=1)


def make_registry(device) -> ModelRegistry:
    return ModelRegistry(
        TrainerConfig(hidden=(48, 48), max_epochs=80),
        DriftConfig(window=16, min_obs=8, mult=2.5, floor=0.12),
        trim_on_drift=24,
        retrain_every=30,
        retrain_on_drift=True,  # training rides the ingest path
        device=device,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    rng = np.random.default_rng(0)
    registry = make_registry(device)
    events = []

    def on_event(ev):
        events.append((ev.kind, ev.version))
        print(f"  [event] {ev.kind} v{ev.version}")

    registry.subscribe(on_event)

    # 1. register the workload + ingest warmup traces + train v1
    w = registry.register_workload(
        ("demo", "analytics-q7"), KNOBS,
        (Objective("latency_s"), Objective("cost_usd")))
    theta = np.array([0.2, 0.7])
    X = rng.random((320, 3))
    registry.observe_batch(w, X, measure(X, theta))
    report = registry.retrain(w)
    print(f"v1 trained: val_error={report.outcome.candidate_error:.3f} "
          f"on {device}")

    # 2. a session that WATCHES the registry
    svc = MOOService(mogd=MOGDConfig(steps=60, multistart=6), batch_rects=4,
                     device=device)
    sid = svc.create_workload_session(registry, w)
    svc.run_until(min_probes=32)
    rec = svc.recommend(sid)
    print(f"pre-shift pick: "
          f"{dict((k, round(v, 3)) for k, v in rec.config.items())} "
          f"-> believed {np.round(rec.objectives, 3)}")

    # 3. the surface shifts; fresh traces stream in -> drift -> retrain
    theta = np.array([0.9, 0.2])
    print("surface shifted; streaming traces ...")
    stale, drift_batches = [], []
    for batch in range(5):
        Xs = rng.random((16, 3))
        n_before = len(events)
        registry.observe_batch(w, Xs, measure(Xs, theta))
        stale.append(svc.session_info(sid).stale)
        if any(k == "drift" for k, _ in events[n_before:]):
            drift_batches.append(batch)
        print(f"  recommend (never blocks): "
              f"{np.round(svc.recommend(sid).objectives, 3)} "
              f"stale={stale[-1]}")

    # 4. next probe pass rebuilds: warm re-solve seeded from the old
    #    frontier, under the promoted model version
    svc.run_until(min_probes=32)
    rec = svc.recommend(sid)
    true_f = measure(np.asarray(rec.x)[None], theta)[0]
    print(f"re-tuned pick:  "
          f"{dict((k, round(v, 3)) for k, v in rec.config.items())} "
          f"-> true {np.round(true_f, 3)}")
    stats = svc.stats()
    print(f"service stats: "
          f"{ {k: v for k, v in stats.items() if 'warm' in k or 'inval' in k or 'stale' in k} }")
    print(f"registry info: {registry.info(w)}")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"events": events, "drift_batches": drift_batches,
            "stale": stale, "stats": stats,
            "info": registry.info(w), "true_f": true_f, **counts}


if __name__ == "__main__":
    main()
