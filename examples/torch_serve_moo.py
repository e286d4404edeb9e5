"""Async serving through the front-desk admission plane, on the PyTorch port.

A deployed optimizer is called by requests that arrive unannounced, with
deadlines, from tenants that do not coordinate.
``repro_torch.frontdesk.FrontDesk`` puts an async serving plane in front of
the service:

* ``submit(...)`` returns a **ticket** (a future) at once; a bounded
  admission queue rejects at submit time when full (backpressure, not
  unbounded queueing);
* per-ticket **SLO classes** (``interactive`` 0.5s / ``standard`` 5s /
  ``batch`` 60s, never shed) feed an earliest-deadline-first scheduler that
  sheds already-missed sheddable work before it wastes a dispatch;
* an **adaptive micro-batching window** holds arrivals just long enough to
  fill the executor's compiled (G, R) bucket, so concurrent tickets
  complete from one coalesced probe round;
* a dispatcher thread owns all stepping, so ``recommend`` stays a
  non-blocking frontier read throughout.

Runs on the card unless ``--device cpu``; ends with one JSON line of the
kernels' launch counts, read after the dispatcher thread has stopped.

    PYTHONPATH=src python examples/torch_serve_moo.py [--device cpu]
"""

import argparse
import json

import torch

from repro_torch.core import MOGDConfig, continuous, integer
from repro_torch.core.problem import SpaceEncoder
from repro_torch.frontdesk import REJECTED, FrontDesk
from repro_torch.kernels import platform
from repro_torch.service import MOOService, Objective, TaskSpec, UtopiaNearest

# the recurring job template of examples/torch_moo_service.py: latency vs
# cost over cluster knobs, per-tenant dataset scale folded into the model
SPECS = [integer("cores", 4, 64), continuous("mem_fraction", 0.2, 0.9)]
ENC = SpaceEncoder(SPECS)


def make_task(scale: float, device=None) -> TaskSpec:
    def objectives(x):
        cfg = ENC.decode_soft(x)
        lat = scale * 120.0 / cfg["cores"] ** 0.9 + 2.0 * (1 - cfg["mem_fraction"])
        cost = cfg["cores"] * 0.02 * (1.0 + 0.1 * cfg["mem_fraction"])
        return torch.stack([lat, cost])

    return TaskSpec(knobs=SPECS,
                    objectives=(Objective("latency_s"), Objective("cost_usd")),
                    model=objectives, preference=UtopiaNearest(), name="etl",
                    device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    svc = MOOService(mogd=MOGDConfig(steps=32, multistart=4), batch_rects=1,
                     device=device)
    desk = FrontDesk(svc, capacity=16)

    with desk:  # starts the dispatcher thread; stop() on exit
        # four tenant classes, three concurrent consumers each.  Submitting
        # by *spec* lets the plane own sessions: structurally-equal specs
        # (recurring jobs) map to ONE session, and concurrent tickets on it
        # are satisfied by the same shared probe round.
        tickets = [desk.submit(spec=make_task(1.0 + s, device=device),
                               slo="standard", n_probes=8)
                   for s in range(4) for _consumer in range(3)]
        for t in tickets:
            t.wait(timeout=60.0)
        st = desk.stats()
        print(f"{st['admitted']} admitted -> {st['completed']} completed "
              f"({st['shed']} shed past deadline) in {st['dispatches']} "
              f"coalesced dispatches "
              f"({st['dispatched_probes']} probes, {st['sessions']} "
              f"sessions) on {device}")
        lat = [t.latency() for t in tickets if t.ok]
        if lat:
            print(f"ticket latency: min {min(lat)*1e3:.0f}ms "
                  f"max {max(lat)*1e3:.0f}ms (includes first-dispatch "
                  f"costs)")
        else:  # every standard ticket missed its deadline and was shed
            shed = [t.latency() for t in tickets]
            print(f"ticket latency: none completed; all {len(tickets)} shed "
                  f"{min(shed)*1e3:.0f}-{max(shed)*1e3:.0f}ms after submit, "
                  f"past their {tickets[0].slo.deadline_s}s SLO "
                  f"(first-dispatch costs)")

        # an interactive consumer with a tight deadline rides the same
        # plane; the recurring session and its compiled program are warm,
        # so a 0.5s SLO is now viable
        vip = desk.submit(spec=make_task(1.0, device=device),
                          slo="interactive", n_probes=4)
        vip.wait(timeout=60.0)
        print(f"vip ({vip.slo.name}, {vip.slo.deadline_s}s SLO): "
              f"{vip.state} in {vip.latency()*1e3:.0f}ms")
        if vip.ok:
            # recommend never blocks behind probe work: it reads the frontier
            rec = svc.recommend(vip.session_id)
            print(f"vip pick: {rec.config} -> lat={rec.objectives[0]:.2f}s "
                  f"cost=${rec.objectives[1]:.3f} "
                  f"(frontier {rec.frontier_size})")

        # backpressure is explicit: a burst past capacity is REJECTED at
        # submit (finished tickets, never queued), not silently buffered
        burst = [desk.submit(spec=make_task(9.0 + s % 2, device=device),
                             slo="standard", n_probes=64) for s in range(40)]
        n_rej = sum(t.state == REJECTED for t in burst)
        print(f"burst of {len(burst)}: {n_rej} rejected at admission "
              f"(queue capacity {desk.stats()['capacity']})")
        desk.drain(timeout=60.0)

    # the dispatcher thread has stopped: the launch counts are settled
    final = desk.stats()
    print(f"final: {final['completed']} completed, "
          f"{final['rejected']} rejected, shed {final['shed']}")
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    print(json.dumps(counts), flush=True)
    return {"tickets": tickets, "vip": vip, "burst": burst,
            "first": st, "final": final, "burst_rejected": n_rej, **counts}


if __name__ == "__main__":
    main()
