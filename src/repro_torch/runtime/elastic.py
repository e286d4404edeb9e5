"""Elastic controller: node-failure handling by checkpoint/restart onto a
re-planned mesh.

On real fleets the runtime learns about failures from the resource manager;
here ``simulate_failures`` drives the same code path.  The controller owns
the loop:

    healthy chips change -> PF-AP replan (repro_torch.planner, <2.5 s
    deadline) -> rebuild mesh/shardings -> restore latest checkpoint with the NEW
    shardings -> resume training.

This is the paper's serverless auto-scaling use case (Use Case 2) mapped
onto accelerator training: re-planning must be fast because it sits on
the restart critical path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class FailureEvent:
    """One capacity-change event on the simulated failure timeline."""

    step: int
    kind: str          # "node_loss" | "node_join" | "preemption"
    chips_delta: int


def simulate_failures(n_steps: int, mtbf_steps: float = 200.0,
                      seed: int = 0) -> list[FailureEvent]:
    """Poisson failure injection: each event removes a node (8 chips);
    occasionally capacity returns."""
    rng = np.random.default_rng(seed)
    events = []
    t = 0
    while True:
        t += int(rng.exponential(mtbf_steps)) + 1
        if t >= n_steps:
            break
        if rng.uniform() < 0.25 and events:
            events.append(FailureEvent(t, "node_join", +8))
        else:
            events.append(FailureEvent(t, "node_loss", -8))
    return events


@dataclasses.dataclass
class ElasticController:
    """Drives train loops through failures.

    Parameters
    ----------
    total_chips: current healthy chip count
    replan: fn(surviving_chips) -> plan recommendation (repro_torch.planner)
    rebuild: fn(recommendation) -> new (step_fn, shardings) for the runner
    restore: fn(shardings) -> state restored from the latest checkpoint
    """

    total_chips: int
    replan: Callable
    rebuild: Callable
    restore: Callable
    min_chips: int = 8
    log: list = dataclasses.field(default_factory=list)

    def handle(self, event: FailureEvent):
        """Returns (step_fn, state) after re-planning + restore."""
        t0 = time.perf_counter()
        self.total_chips = max(self.min_chips,
                               self.total_chips + event.chips_delta)
        rec = self.replan(self.total_chips)
        step_fn, shardings = self.rebuild(rec)
        state = self.restore(shardings)
        dt = time.perf_counter() - t0
        self.log.append({
            "event": dataclasses.asdict(event),
            "chips": self.total_chips,
            "replan_chips": getattr(rec, "num_chips", None),
            "downtime_s": dt,
        })
        return step_fn, state
