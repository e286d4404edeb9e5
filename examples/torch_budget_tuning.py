"""Learned probe-budget routing across tenants, on the PyTorch port.

Four tenants share one MOO service.  Two are pre-converged (their frontiers
sit on the hypervolume plateau, so every probe the legacy uniform schedule
spends on them is wasted) and two are fresh.  A ``GainBanditPolicy`` is
installed mid-flight and routes a shrunken round budget by expected
hypervolume gain per probe-second: plateau tenants drop to the
min-rectangle floor, fresh tenants keep their full legacy rate, and a
deadline-squeezed tenant stays protected whatever the learned weights say.
Runs on the card unless ``--device cpu``; ends with one JSON line of the
kernels' launch counts.

    PYTHONPATH=src python examples/torch_budget_tuning.py [--device cpu]
"""

import argparse
import json

import numpy as np

from repro_torch.alloc import GainBanditPolicy
from repro_torch.core import MOGDConfig
from repro_torch.core.synthetic import mlp_surrogate_task
from repro_torch.kernels import platform
from repro_torch.service import MOOService

MOGD = MOGDConfig(steps=16, multistart=2)
ROUNDS = 8
SEEDS = (7, 8, 4, 9)
WARMUP_ROUNDS = 6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    svc = MOOService(mogd=MOGD, grid_l=2, device=device)
    # one compiled structure, four tenants: seeds picked so queues stay
    # deep for the whole demo (an exhausted tenant spends nothing and
    # makes the routing invisible)
    sids = [svc.create_session(
        mlp_surrogate_task(seed=s, arch=(16,), name=f"tenant{i}",
                           device=device),
        batch_rects=3) for i, s in enumerate(SEEDS)]
    plateau, fresh = sids[:2], sids[2:]

    print(f"== phase 1: pre-converge two tenants (policy off) on {device} ==")
    for _ in range(WARMUP_ROUNDS):
        svc.step_sessions(plateau, origin="warmup")
    for sid in plateau:
        st = svc._sessions[sid].state
        print(f"  {sid}: probes={st.probes} "
              f"uncertain={st.queue.uncertain_fraction:.4f}")

    print("\n== phase 2: install the bandit, serve all four ==")
    svc.budget_policy = GainBanditPolicy(budget_fraction=0.6, epsilon=0.05)
    # the serving facts a front desk would attach; tenant3 is one
    # dispatch-wall from its deadline -> the guard protects it
    ctx = {sid: {"slo": "standard", "deadline_slack_s": 30.0,
                 "wall_ema_s": 0.02, "sheddable": True} for sid in sids}
    ctx[sids[3]] = {"slo": "interactive", "deadline_slack_s": 0.03,
                    "wall_ema_s": 0.02, "sheddable": False}
    before = {sid: svc._sessions[sid].state.probes if
              svc._sessions[sid].state is not None else 0 for sid in sids}
    for _ in range(ROUNDS):
        svc.step_sessions(sids, origin="serve", context=ctx)

    legacy = ROUNDS * 3 * svc.default_grid_l ** 2  # uniform per-tenant spend
    spent = {}
    for i, sid in enumerate(sids):
        st = svc._sessions[sid].state
        spent[sid] = st.probes - before[sid]
        kind = "plateau" if sid in plateau else "fresh  "
        tag = "  (deadline-protected)" if i == 3 else ""
        print(f"  tenant{i} [{kind}] probes={spent[sid]:3d} "
              f"(uniform would spend {legacy}) hv={st.hv:.4f}{tag}")

    b = svc.stats()["budget"]
    total = sum(spent.values())
    print(f"\nbudget: policy={b['policy']} rounds={b['rounds']} "
          f"granted={b['rects_granted']} legacy={b['rects_legacy']}")
    print(f"spend vs uniform: {total}/{legacy * len(sids)} probes "
          f"({total / (legacy * len(sids)):.2f}x)")
    assert total < legacy * len(sids)  # the routed schedule spends less
    frac = np.array([spent[s] for s in fresh]).sum() / max(total, 1)
    print(f"share of spend on the two fresh tenants: {frac:.0%}")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"spent": [spent[s] for s in sids], "legacy": legacy,
            "budget": b, "fresh_share": float(frac), **counts}


if __name__ == "__main__":
    main()
