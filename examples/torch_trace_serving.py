"""Observability plane end to end on the PyTorch port: trace a serving burst.

One ``Observability`` bundle rides the whole stack (front desk -> service
-> executor -> vault), so a burst of tickets produces (a) a Chrome-trace
JSON to load in chrome://tracing or https://ui.perfetto.dev, showing admit
-> schedule -> dispatch -> step_round -> solve -> absorb nested across the
real threads, (b) a snapshot-consistent Prometheus export of every counter
on the path, and (c) a per-ticket latency breakdown whose phases sum to
the end-to-end latency.  Runs on the card unless ``--device cpu``; ends
with one JSON line of the kernels' launch counts, read after the front
desk's dispatcher thread has stopped.

    PYTHONPATH=src python examples/torch_trace_serving.py [--device cpu]
"""

import argparse
import json
import tempfile

from repro_torch.core import MOGDConfig
from repro_torch.core.synthetic import mlp_surrogate_task
from repro_torch.frontdesk import FrontDesk
from repro_torch.kernels import platform
from repro_torch.obs import Observability
from repro_torch.service import MOOService

PROM_EXCERPT = ("frontdesk_completed", "frontdesk_dispatches",
                "exec_dispatches{", "service_coalesced")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = platform.resolve_device(args.device)  # raises without a card

    platform.reset_launches()
    obs = Observability(trace=True)  # the default is trace=False: ~free
    svc = MOOService(mogd=MOGDConfig(steps=24, multistart=4),
                     batch_rects=2, grid_l=2, obs=obs, device=device)

    print(f"== serving burst (tracing on, {device}) ==")
    with FrontDesk(svc, capacity=32) as desk:  # adopts svc.obs
        # "batch" SLO: the first compile of a program can take seconds,
        # and this demo wants every ticket to finish, not to show load
        # shedding
        tickets = [desk.submit(spec=mlp_surrogate_task(seed=i % 4,
                                                       device=device),
                               n_probes=8, slo="batch")
                   for i in range(12)]
        desk.drain(timeout=60.0)
    # the dispatcher thread has stopped: the launch counts are settled
    counts = {"launches": platform.launch_counts(),
              "plain_on_cuda": platform.plain_on_cuda_counts()}
    done = [t for t in tickets if t.ok]
    print(f"  {len(done)}/{len(tickets)} tickets completed")

    # -- per-ticket latency attribution --------------------------------
    print("== where the latency went (first completed ticket) ==")
    b = done[0].breakdown()
    for k in ("queue_wait_s", "batch_wait_s", "dispatch_s",
              "absorb_s", "persist_s"):
        print(f"  {k:14s} {b[k] * 1e3:8.3f} ms")
    print(f"  {'accounted_s':14s} {b['accounted_s'] * 1e3:8.3f} ms "
          f"(e2e {b['e2e_s'] * 1e3:.3f} ms)")
    assert abs(b["accounted_s"] - b["e2e_s"]) < 1e-6

    # -- one registry for the whole stack ------------------------------
    print("== metrics (Prometheus text, excerpt) ==")
    prom = obs.metrics.to_prometheus()
    for line in prom.splitlines():
        if line.startswith(PROM_EXCERPT):
            print(f"  {line}")

    # -- Chrome trace --------------------------------------------------
    path = tempfile.mktemp(prefix="serving_trace_", suffix=".json")
    obs.tracer.export_chrome(path)
    spans = obs.tracer.spans()
    names = sorted({s.name for s in spans})
    print("== trace ==")
    print(f"  {len(spans)} spans across "
          f"{len({s.thread_id for s in spans})} threads: {names}")
    print(f"  load {path} in chrome://tracing or ui.perfetto.dev")
    assert {"frontdesk.admit", "frontdesk.dispatch",
            "service.step_round", "exec.dispatch"} <= set(names)
    print(json.dumps(counts), flush=True)
    return {"tickets": tickets, "breakdowns": [t.breakdown() for t in done],
            "prometheus": prom, "span_names": names, "trace": path,
            **counts}


if __name__ == "__main__":
    main()
