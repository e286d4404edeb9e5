"""Admission control for the async serving plane (DESIGN.md §12).

A :class:`Ticket` is the future handed back by ``FrontDesk.submit``: the
caller waits on it (or polls) while probe work drains asynchronously.
The :class:`AdmissionQueue` is the bounded front door — when it is full,
``submit`` returns a ticket already in the ``rejected`` state instead of
blocking, which is the backpressure contract: the *client* decides
whether to retry, degrade, or give up; the plane never queues unbounded
work.

Admission counters are typed :class:`repro_torch.obs.Counter` / ``Gauge``
instruments (DESIGN.md §14) — ``snapshot()`` and the legacy int-valued
properties are views over the registry, so the plane's Prometheus
endpoint and ``FrontDesk.stats()`` read the *same* numbers.

All mutation happens under the owning ``FrontDesk``'s plane lock; these
classes hold no locks of their own beyond the registry's.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading

from ..obs import MetricsRegistry

# terminal ticket states (the event fires exactly once, on entry)
PENDING = "pending"
DONE = "done"
REJECTED = "rejected"  # bounded queue full at submit — never queued
SHED = "shed"  # deadline expired before completion — never re-dispatched
ERROR = "error"  # a dispatch covering this ticket raised

_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named service class: its default deadline and shed policy.

    ``sheddable=False`` marks work that is *never* load-shed once
    admitted (batch analytics with no interactive caller): its deadline
    still orders it in EDF, but expiry does not cancel it.
    """

    name: str
    deadline_s: float
    sheddable: bool = True


#: The default tenant mix (expt8 uses the same three classes).
SLO_CLASSES = {
    "interactive": SLOClass("interactive", deadline_s=0.5),
    "standard": SLOClass("standard", deadline_s=5.0),
    "batch": SLOClass("batch", deadline_s=60.0, sheddable=False),
}


@dataclasses.dataclass
class Ticket:
    """One admitted (or rejected) probe request — the caller's future.

    Completion semantics: the ticket is ``done`` once its session has
    accumulated ``n_probes`` additional probes since submission, or the
    session's rectangle queue is exhausted (its frontier is final, so no
    further probing can help).  ``recommend`` is *not* part of the
    ticket — it stays a synchronous, non-blocking read on the service.

    Latency attribution (DESIGN.md §14): the plane charges every second
    between submit and the terminal state to exactly one of the
    ``*_s`` phase fields below, so :meth:`breakdown` components sum to
    the end-to-end latency — an SLO miss names its culprit.
    """

    session_id: str
    group_key: tuple
    slo: SLOClass
    deadline: float  # absolute, on the plane's clock
    n_probes: int
    submitted_at: float
    ticket_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: str = PENDING
    credited: int = 0  # probes landed on the session since submit
    finished_at: float | None = None
    # -- latency attribution (all on the plane's clock) ----------------
    queue_wait_s: float = 0.0  # admitted but outside any batching hold
    batch_wait_s: float = 0.0  # deliberately held by the batcher window
    dispatch_s: float = 0.0  # riding a probe round (device + overhead)
    absorb_s: float = 0.0  # share of frontier absorb under service lock
    persist_s: float = 0.0  # share of vault export in its probe rounds
    last_enqueued_at: float | None = None  # submit or last re-queue
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def finish(self, state: str, now: float) -> None:
        """Move to a terminal state and release waiters (idempotent)."""
        if self.state != PENDING:
            return
        self.state = state
        self.finished_at = now
        self._event.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the ticket reaches a terminal state."""
        return self._event.wait(timeout)

    @property
    def done(self) -> bool:
        return self.state != PENDING

    @property
    def ok(self) -> bool:
        return self.state == DONE

    def latency(self) -> float | None:
        """Submit→terminal wall time (None while pending)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def breakdown(self) -> dict:
        """Where this ticket's latency went: per-phase seconds plus the
        accounted total and the end-to-end latency it should match."""
        out = {
            "queue_wait_s": self.queue_wait_s,
            "batch_wait_s": self.batch_wait_s,
            "dispatch_s": self.dispatch_s,
            "absorb_s": self.absorb_s,
            "persist_s": self.persist_s,
        }
        out["accounted_s"] = sum(out.values())
        out["e2e_s"] = self.latency()
        return out


class AdmissionQueue:
    """Bounded admission with explicit rejection (no silent queueing).

    ``capacity`` bounds the number of *live* tickets (queued or mid
    dispatch).  ``try_admit`` either claims a slot or refuses; the
    caller marks the ticket accordingly.  Counters are cumulative and
    monotone, registered as typed instruments on ``metrics`` (a private
    registry when standalone) — ``FrontDesk.stats`` exports them.
    """

    def __init__(self, capacity: int = 256,
                 metrics: MetricsRegistry | None = None,
                 labels: dict | None = None):
        if capacity < 1:
            raise ValueError("admission capacity must be >= 1")
        self.capacity = capacity
        m = metrics if metrics is not None else MetricsRegistry()
        self.metrics = m
        self._g_live = m.gauge(
            "frontdesk.live", labels, help="live tickets (queued or "
            "mid-dispatch)")
        self._c_submitted = m.counter(
            "frontdesk.submitted", labels, help="submit calls")
        self._c_admitted = m.counter(
            "frontdesk.admitted", labels, help="tickets admitted")
        self._c_rejected = m.counter(
            "frontdesk.rejected", labels, help="tickets rejected at the "
            "full queue (backpressure)")
        self._c_shed = m.counter(
            "frontdesk.shed", labels, help="tickets shed on deadline "
            "expiry")
        self._c_completed = m.counter(
            "frontdesk.completed", labels, help="tickets completed")
        self._c_errors = m.counter(
            "frontdesk.errors", labels, help="tickets failed by a "
            "dispatch error")

    # legacy int-valued counter surface: views over the registry
    @property
    def live(self) -> int:
        return int(self._g_live.value)

    @property
    def submitted(self) -> int:
        return int(self._c_submitted.value)

    @property
    def admitted(self) -> int:
        return int(self._c_admitted.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def shed(self) -> int:
        return int(self._c_shed.value)

    @property
    def completed(self) -> int:
        return int(self._c_completed.value)

    @property
    def errors(self) -> int:
        return int(self._c_errors.value)

    def try_admit(self) -> bool:
        self._c_submitted.inc()
        if self.live >= self.capacity:
            self._c_rejected.inc()
            return False
        self._g_live.inc()
        self._c_admitted.inc()
        return True

    def release(self, state: str) -> None:
        """A live ticket reached a terminal state — free its slot."""
        self._g_live.dec()
        if state == DONE:
            self._c_completed.inc()
        elif state == SHED:
            self._c_shed.inc()
        elif state == ERROR:
            self._c_errors.inc()

    def snapshot(self) -> dict:
        return {
            "capacity": self.capacity,
            "live": self.live,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "shed": self.shed,
            "completed": self.completed,
            "errors": self.errors,
        }
