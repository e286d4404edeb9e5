"""FrontDesk: the async admission plane in front of MOOService (§12).

One object ties the plane together::

    desk = FrontDesk(service)
    desk.start()                          # dispatcher thread
    t = desk.submit(spec, deadline_s=1.0, slo="interactive")
    t.wait()                              # future semantics
    rec = service.recommend(t.session_id)  # non-blocking, never solves

``submit`` is admission control: a bounded queue with explicit rejection
(backpressure), plus shed-at-admission for deadlines that are already
unmeetable.  Admitted tickets flow admission → adaptive batching window
→ EDF scheduler → ``MOOService.step_sessions`` (one executor dispatch
per structure group), with the dispatcher thread draining probe work so
``recommend`` stays non-blocking throughout — it reads the live
frontier under the service lock, which coalesced stepping releases
around device dispatches.

Observability (DESIGN.md §14): the plane shares one
:class:`repro_torch.obs.Observability` bundle with its service — counters and
phase histograms live in the shared registry (``stats()`` is a view over
it), spans cover admit → schedule → dispatch with explicit parents, and
every ticket's latency is attributed second-for-second to queue wait /
batch-window hold / dispatch / absorb / persist, so
``Ticket.breakdown()`` components sum to its end-to-end latency.

Lock order is strictly plane lock → service lock → executor lock; the
plane lock is never held across a device dispatch.

The ``clock`` is injectable (tests drive deadlines deterministically
with a fake clock and call :meth:`FrontDesk.poll` manually instead of
starting the thread).
"""

from __future__ import annotations

import itertools
import threading
import time

from .admission import (
    DONE,
    ERROR,
    REJECTED,
    SHED,
    SLO_CLASSES,
    AdmissionQueue,
    SLOClass,
    Ticket,
)
from .batcher import AdaptiveBatcher
from .scheduler import EDFScheduler
from ..obs import Observability

_plane_ids = itertools.count()

#: the attributed latency phases, in pipeline order
PHASES = ("queue_wait_s", "batch_wait_s", "dispatch_s", "absorb_s",
          "persist_s")


class FrontDesk:
    """Async serving plane: admission, micro-batching, EDF dispatch."""

    def __init__(
        self,
        service,
        capacity: int = 256,
        batcher: AdaptiveBatcher | None = None,
        session_kwargs: dict | None = None,
        clock=time.monotonic,
        poll_floor_s: float = 0.25,
        obs: Observability | None = None,
    ):
        self.service = service
        # share the service's bundle when it has one, so the whole
        # request path lands in ONE registry / tracer; instruments get a
        # per-instance label because benchmarks run several desks over
        # one service and expect independent counts
        self.obs = (obs if obs is not None
                    else getattr(service, "obs", None) or Observability())
        self._labels = {"plane": f"plane{next(_plane_ids)}"}
        m = self.obs.metrics
        self.queue = AdmissionQueue(capacity, metrics=m,
                                    labels=self._labels)
        self.batcher = batcher if batcher is not None else AdaptiveBatcher()
        self.scheduler = EDFScheduler()
        self.session_kwargs = dict(session_kwargs or {})
        self.clock = clock
        self.poll_floor_s = poll_floor_s
        self._c_dispatches = m.counter(
            "frontdesk.dispatches", self._labels,
            help="coalesced probe rounds dispatched")
        self._c_dispatched_probes = m.counter(
            "frontdesk.dispatched_probes", self._labels,
            help="probes landed by plane dispatches")
        self._c_dispatch_errors = m.counter(
            "frontdesk.dispatch_errors", self._labels,
            help="probe rounds that raised")
        self._c_fast_completions = m.counter(
            "frontdesk.fast_completions", self._labels,
            help="tickets settled at submit (frontier already final)")
        # per-SLO-class budget telemetry (DESIGN.md §15): probe credits
        # actually landed per class vs tickets shed per class — the
        # bandit's spending is auditable by tenant class.  Lazily keyed
        # by class name so custom SLOClass instances get counted too.
        self._c_credits_by_slo: dict[str, object] = {}
        self._c_shed_by_slo: dict[str, object] = {}
        # per-phase attribution histograms, recorded at ticket completion
        self._h = {p: m.histogram(f"frontdesk.{p}", self._labels,
                                  help=f"completed-ticket {p} share")
                   for p in PHASES}
        self._h["e2e_s"] = m.histogram(
            "frontdesk.e2e_s", self._labels,
            help="completed-ticket end-to-end latency")
        self._spec_sessions: dict[str, str] = {}
        self._cond = threading.Condition()  # the plane lock
        self._thread: threading.Thread | None = None
        self._stop = False

    # legacy int-valued counters: views over the registry
    @property
    def dispatches(self) -> int:
        return int(self._c_dispatches.value)

    @property
    def dispatched_probes(self) -> int:
        return int(self._c_dispatched_probes.value)

    @property
    def dispatch_errors(self) -> int:
        return int(self._c_dispatch_errors.value)

    @property
    def fast_completions(self) -> int:
        return int(self._c_fast_completions.value)

    def _slo_counter(self, table: dict, kind: str, slo_name: str):
        """Per-SLO-class counter, created on first use (shared registry,
        labeled ``{"slo": <class>}`` on top of the plane label)."""
        c = table.get(slo_name)
        if c is None:
            c = self.obs.metrics.counter(
                f"frontdesk.{kind}", {**self._labels, "slo": slo_name})
            table[slo_name] = c
        return c

    # -- ticket settlement ---------------------------------------------
    def _finish(self, t: Ticket, state: str, now: float) -> None:
        """Terminal transition + attribution export (plane lock held)."""
        t.finish(state, now)
        self.queue.release(state)
        if state == SHED:
            self._slo_counter(self._c_shed_by_slo, "shed_by_slo",
                              t.slo.name).inc()
        if state == DONE:
            for p in PHASES:
                self._h[p].record(getattr(t, p))
            self._h["e2e_s"].record(max(0.0, now - t.submitted_at))

    def _trace_admit(self, t: Ticket, t0: float) -> None:
        """Retroactive admit span (no-op when tracing is off)."""
        tr = self.obs.tracer
        if tr.enabled:
            tr.record_span(
                "frontdesk.admit", t0, tr.now(), cat="frontdesk",
                args={"ticket": t.ticket_id, "state": t.state,
                      "session": t.session_id})

    # -- admission -----------------------------------------------------
    def submit(
        self,
        spec=None,
        session_id: str | None = None,
        deadline_s: float | None = None,
        slo: SLOClass | str = "standard",
        n_probes: int = 16,
    ) -> Ticket:
        """Admit (or reject) one probe request; returns immediately.

        Exactly one of ``spec`` / ``session_id`` selects the tenant:
        recurring specs reuse one plane-owned session per task
        signature.  A full queue yields a ``rejected`` ticket — the
        backpressure signal; a deadline that is already unmeetable
        (``deadline_s <= 0``) yields a ``shed`` ticket that is never
        enqueued, let alone dispatched.
        """
        if (spec is None) == (session_id is None):
            raise ValueError("pass exactly one of spec / session_id")
        if isinstance(slo, str):
            slo = SLO_CLASSES[slo]
        if deadline_s is None:
            deadline_s = slo.deadline_s
        ta0 = self.obs.tracer.now()
        now = self.clock()
        with self._cond:
            admitted = self.queue.try_admit()
        if not admitted:
            t = Ticket(session_id=session_id or "", group_key=(),
                       slo=slo, deadline=now + deadline_s,
                       n_probes=n_probes, submitted_at=now)
            t.finish(REJECTED, now)
            self._trace_admit(t, ta0)
            return t
        try:
            sid = (session_id if session_id is not None
                   else self._resolve_session(spec))
            key = self.service.session_dispatch_key(sid)
        except Exception:
            with self._cond:
                self.queue.release(ERROR)
            raise
        t = Ticket(session_id=sid, group_key=key, slo=slo,
                   deadline=now + deadline_s, n_probes=n_probes,
                   submitted_at=now, last_enqueued_at=now)
        if slo.sheddable and deadline_s <= 0:
            with self._cond:
                self._finish(t, SHED, now)
            self._trace_admit(t, ta0)
            return t
        # warm-restart fast path (DESIGN.md §13): a session whose frontier
        # is already final — e.g. vault-restored at create_session — has
        # nothing to dispatch; complete the ticket at admission instead of
        # making it ride a probe round.  Optional protocol: services
        # without session_exhausted() keep the legacy dispatch-then-settle
        # behavior.
        probe_done = getattr(self.service, "session_exhausted", None)
        if probe_done is not None and probe_done(sid):
            with self._cond:
                self._finish(t, DONE, now)
                self._c_fast_completions.inc()
            self._trace_admit(t, ta0)
            return t
        with self._cond:
            self.scheduler.add(t)
            self.batcher.note_arrival(key, now)
            self._cond.notify_all()
        self._trace_admit(t, ta0)
        return t

    def _resolve_session(self, spec) -> str:
        """One plane-owned session per task signature (recurring jobs
        re-attach).  Creation runs outside the plane lock — it may
        compile — with a race-safe publish."""
        sig = spec.signature()
        with self._cond:
            sid = self._spec_sessions.get(sig)
        if sid is not None:
            return sid
        sid = self.service.create_session(spec, **self.session_kwargs)
        with self._cond:
            cur = self._spec_sessions.setdefault(sig, sid)
        if cur != sid:  # lost the race — keep the winner's session
            self.service.close_session(sid)
        return cur

    # -- dispatch ------------------------------------------------------
    def poll(self) -> dict:
        """One dispatcher iteration: shed expired work, pick ready
        groups in EDF order, run each group as one coalesced
        ``step_sessions`` round (plane lock released), settle tickets.
        Tests call this directly with a fake clock; the dispatcher
        thread calls it in a loop."""
        tr = self.obs.tracer
        tp0 = tr.now()
        now = self.clock()
        claims: list[tuple[tuple, list[Ticket], bool]] = []
        shed_n = 0
        with self._cond:
            for t in self.scheduler.shed_expired(now):
                enq = (t.last_enqueued_at if t.last_enqueued_at is not None
                       else t.submitted_at)
                t.queue_wait_s += max(0.0, now - enq)
                self._finish(t, SHED, now)
                shed_n += 1
            sizes = self.scheduler.group_sizes()
            for key in self.scheduler.group_order():
                edl = self.scheduler.earliest_deadline(key)
                if self.batcher.ready(key, sizes[key], edl, now):
                    expired = self.batcher.window_expired(key, now)
                    tickets = self.scheduler.claim_group(key)
                    # split the wait so far: time inside the batcher's
                    # open window is a deliberate hold (batch_wait),
                    # everything before it is queueing
                    opened = self.batcher.window_opened_at(key)
                    for t in tickets:
                        enq = (t.last_enqueued_at
                               if t.last_enqueued_at is not None
                               else t.submitted_at)
                        wait = max(0.0, now - enq)
                        held = (min(wait, max(0.0, now - opened))
                                if opened is not None else 0.0)
                        t.batch_wait_s += held
                        t.queue_wait_s += wait - held
                    claims.append((key, tickets, expired))
        if tr.enabled and (claims or shed_n):
            # retroactive: idle polls (the dispatcher spins) emit nothing
            tr.record_span("frontdesk.schedule", tp0, tr.now(),
                           cat="frontdesk",
                           args={"claims": len(claims), "shed": shed_n})
        probes = 0
        for key, tickets, expired in claims:
            sids = list(dict.fromkeys(t.session_id for t in tickets))
            t0 = self.clock()
            gap = max(0.0, t0 - now)  # earlier groups' dispatch time
            for t in tickets:
                t.queue_wait_s += gap
            sp = tr.span("frontdesk.dispatch", cat="frontdesk",
                         args={"group": str(key), "sessions": len(sids),
                               "tickets": [t.ticket_id
                                           for t in tickets[:32]]})
            try:
                with sp:
                    kw = ({"parent_span": sp} if sp.enabled else {})
                    # budget-policy context (DESIGN.md §15): each
                    # session's tightest deadline slack, SLO class, and
                    # the group's dispatch wall EMA become allocation
                    # features; only built for budget-aware services so
                    # minimal step_sessions implementations keep working
                    if getattr(self.service, "budget_policy",
                               None) is not None:
                        kw["context"] = self._budget_context(
                            tickets, key, t0)
                    out = self.service.step_sessions(
                        sids, origin="frontdesk", **kw)
                    sp.set("probes", out["probes"])
            except Exception:
                with self._cond:
                    end = self.clock()
                    for t in tickets:
                        t.dispatch_s += max(0.0, end - t0)
                        self._finish(t, ERROR, end)
                    self._c_dispatch_errors.inc()
                continue
            with self._cond:
                end = self.clock()
                wall = max(0.0, end - t0)
                # charge the round to dispatch/absorb/persist in the
                # proportions the service measured (perf_counter); the
                # plane clock keeps the total exact, so breakdown
                # components still sum to the end-to-end latency
                timing = out.get("timing") or {}
                rw = timing.get("round_wall_s", 0.0)
                af = timing.get("absorb_s", 0.0) / rw if rw > 0 else 0.0
                pf = timing.get("persist_s", 0.0) / rw if rw > 0 else 0.0
                scale = af + pf
                if scale > 1.0:
                    af, pf = af / scale, pf / scale
                d_abs, d_per = wall * af, wall * pf
                d_dis = wall - d_abs - d_per
                self.batcher.on_dispatch(key, len(tickets), wall,
                                         expired, end)
                exhausted = set(out["exhausted"])
                for t in tickets:
                    t.dispatch_s += d_dis
                    t.absorb_s += d_abs
                    t.persist_s += d_per
                    got = out["per_session"].get(t.session_id, 0)
                    t.credited += got
                    if got:
                        self._slo_counter(self._c_credits_by_slo,
                                          "credits_by_slo",
                                          t.slo.name).inc(got)
                    if t.credited >= t.n_probes or t.session_id in exhausted:
                        self._finish(t, DONE, end)
                    elif t.slo.sheddable and t.deadline <= end:
                        self._finish(t, SHED, end)
                        shed_n += 1
                    else:  # partial progress — back in the queue
                        t.last_enqueued_at = end
                        self.scheduler.add(t)
                        self.batcher.note_arrival(key, end)
                self._c_dispatches.inc()
                self._c_dispatched_probes.inc(out["probes"])
                probes += out["probes"]
        return {"groups": len(claims), "probes": probes, "shed": shed_n}

    def _budget_context(self, tickets: list[Ticket], key: tuple,
                        now: float) -> dict:
        """Per-session serving facts for the budget policy: the
        TIGHTEST deadline slack across the session's claimed tickets
        (the guard must protect the most urgent one), its SLO class and
        sheddability, and the group's dispatch wall EMA."""
        wall = self.batcher.wall_ema(key)
        ctx: dict[str, dict] = {}
        for t in tickets:
            slack = t.deadline - now
            cur = ctx.get(t.session_id)
            if cur is None or slack < cur["deadline_slack_s"]:
                ctx[t.session_id] = {
                    "slo": t.slo.name,
                    "deadline_slack_s": slack,
                    "wall_ema_s": wall,
                    "sheddable": t.slo.sheddable,
                }
        return ctx

    # -- dispatcher thread ---------------------------------------------
    def start(self) -> "FrontDesk":
        if self._thread is not None:
            return self
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="frontdesk-dispatcher", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                if not len(self.scheduler):
                    self._cond.wait(timeout=self.poll_floor_s)
                    if self._stop:
                        return
                hint = self.batcher.wait_hint(
                    self.scheduler.group_sizes(), self.clock())
            if hint is not None and hint > 1e-4:
                with self._cond:
                    if self._stop:
                        return
                    self._cond.wait(timeout=min(hint, self.poll_floor_s))
            self.poll()

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until no live tickets remain (benchmark teardown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if self.queue.live == 0:
                    return True
            time.sleep(0.005)
        return False

    def __enter__(self) -> "FrontDesk":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- telemetry -----------------------------------------------------
    def stats(self) -> dict:
        """Consistent plane snapshot (admission counters, pending depth,
        dispatch totals, batcher windows, completed-ticket latency
        attribution) — a view over the shared metrics registry."""
        with self._cond:
            out = self.queue.snapshot()
            out.update(
                pending=len(self.scheduler),
                groups=len(self.scheduler.group_sizes()),
                dispatches=self.dispatches,
                dispatched_probes=self.dispatched_probes,
                dispatch_errors=self.dispatch_errors,
                fast_completions=self.fast_completions,
                sessions=len(self._spec_sessions),
                batcher=self.batcher.snapshot(),
                latency={name: h.summary()
                         for name, h in self._h.items()},
                # per-SLO-class budget telemetry (DESIGN.md §15):
                # probe credits landed / tickets shed, by class
                budget={
                    "credits": {name: int(c.value) for name, c
                                in self._c_credits_by_slo.items()},
                    "shed": {name: int(c.value) for name, c
                             in self._c_shed_by_slo.items()},
                },
            )
            return out
