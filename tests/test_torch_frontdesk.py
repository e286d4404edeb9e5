"""The port's FrontDesk admission plane against the JAX reference's.

The classes mirror every test of ``tests/test_frontdesk.py`` on the port,
with the same stub service, fake clock, deadlines and assertions: bounded
admission with explicit rejection, deadline semantics (shed at admission,
EDF preemption, shed visibility), the adaptive batching window, and the
end-to-end submit -> micro-batch -> coalesced dispatch -> completion path
over a real port ``MOOService`` on the host (``device="cpu"``).
``TestFrontdeskFastPath`` mirrors ``tests/test_persist.py``'s class of that
name (a session whose frontier is final completes at submit).

``TestPlaneParity`` drives the reference's plane and the port's through the
same seeded schedule of submits, clock steps, polls and exhausted sessions,
each over its own stub: every ticket's state, credit and latency breakdown,
the stubs' dispatch calls and the planes' ``stats()`` must be equal,
exactly (the plane is pure Python in both packages).

The stub and the clock are copied here, as a port test imports no other
test file.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import repro.frontdesk as JF
from repro_torch.core import MOGDConfig
from repro_torch.core.synthetic import mlp_surrogate_task
from repro_torch.frontdesk import (
    DONE,
    REJECTED,
    SHED,
    AdaptiveBatcher,
    EDFScheduler,
    FrontDesk,
    SLOClass,
    Ticket,
)
from repro_torch.service import MOOService

CPU = "cpu"
FAST = MOGDConfig(steps=60, multistart=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class StubService:
    """Dispatch-seam double: sessions named ``<group>:<n>`` group by
    prefix; every round credits ``probes_per_round`` to each session."""

    def __init__(self, probes_per_round: int = 8):
        self.calls: list[list[str]] = []
        self.exhausted: set[str] = set()
        self.probes_per_round = probes_per_round

    def session_dispatch_key(self, session_id: str) -> tuple:
        return ("stub", session_id.split(":")[0])

    def step_sessions(self, session_ids, origin=None):
        sids = list(session_ids)
        self.calls.append(sids)
        per = {s: self.probes_per_round for s in sids}
        return {"batches": 1, "probes": sum(per.values()),
                "sessions": len(sids), "per_session": per,
                "exhausted": [s for s in sids if s in self.exhausted]}


def make_desk(stub=None, clock=None, capacity=8, package=None, **batcher_kw):
    stub = stub if stub is not None else StubService()
    clock = clock if clock is not None else FakeClock()
    batcher_kw.setdefault("w_min", 0.01)
    batcher_kw.setdefault("w_max", 1.0)
    batcher_kw.setdefault("w_init", 0.1)
    # ``package`` picks the reference's plane (``repro.frontdesk``)
    desk_cls, batcher_cls = ((FrontDesk, AdaptiveBatcher) if package is None
                             else (package.FrontDesk, package.AdaptiveBatcher))
    desk = desk_cls(stub, capacity=capacity, clock=clock,
                    batcher=batcher_cls(**batcher_kw))
    return desk, stub, clock


class TestAdmission:
    def test_bounded_queue_rejects_explicitly(self):
        desk, stub, clock = make_desk(capacity=2)
        t1 = desk.submit(session_id="a:1", n_probes=8)
        t2 = desk.submit(session_id="a:2", n_probes=8)
        t3 = desk.submit(session_id="a:3", n_probes=8)
        assert t1.state == t2.state == "pending"
        assert t3.state == REJECTED and t3.done  # backpressure, not a block
        st = desk.stats()
        assert st["rejected"] == 1 and st["admitted"] == 2
        assert st["live"] == 2 and st["pending"] == 2

    def test_completion_frees_admission_slot(self):
        desk, stub, clock = make_desk(capacity=1)
        t1 = desk.submit(session_id="a:1", n_probes=8)
        assert desk.submit(session_id="a:2", n_probes=8).state == REJECTED
        clock.advance(1.0)  # window expired -> group dispatches
        desk.poll()
        assert t1.state == DONE and t1.credited == 8
        t3 = desk.submit(session_id="a:3", n_probes=8)
        assert t3.state == "pending"  # slot was freed
        assert desk.stats()["completed"] == 1

    def test_partial_progress_requeues_until_budget_met(self):
        desk, stub, clock = make_desk()
        t = desk.submit(session_id="a:1", n_probes=20, slo="batch")
        clock.advance(1.0)
        desk.poll()
        assert t.state == "pending" and t.credited == 8
        clock.advance(1.0)
        desk.poll()
        clock.advance(1.0)
        desk.poll()
        assert t.state == DONE and t.credited == 24
        assert len(stub.calls) == 3

    def test_exhausted_session_completes_ticket_early(self):
        desk, stub, clock = make_desk()
        stub.exhausted.add("a:1")
        t = desk.submit(session_id="a:1", n_probes=10_000)
        clock.advance(1.0)
        desk.poll()
        assert t.state == DONE  # frontier is final; waiting can't help

    def test_submit_requires_exactly_one_target(self):
        desk, *_ = make_desk()
        with pytest.raises(ValueError):
            desk.submit()
        with pytest.raises(ValueError):
            desk.submit(spec=object(), session_id="a:1")


class TestDeadlines:
    def test_expired_at_admission_is_shed_never_dispatched(self):
        desk, stub, clock = make_desk()
        t = desk.submit(session_id="a:1", deadline_s=0.0, n_probes=8)
        assert t.state == SHED and t.done
        clock.advance(10.0)
        desk.poll()
        assert stub.calls == []  # nothing ever reached the executor
        assert desk.stats()["shed"] == 1 and desk.stats()["live"] == 0

    def test_expired_in_queue_is_shed_before_dispatch(self):
        desk, stub, clock = make_desk(w_init=1.0, w_max=1.0)
        t = desk.submit(session_id="a:1", deadline_s=0.5, n_probes=8)
        clock.advance(0.75)  # window still open, deadline gone
        desk.poll()
        assert t.state == SHED
        assert stub.calls == []

    def test_batch_slo_is_never_shed(self):
        desk, stub, clock = make_desk()
        t = desk.submit(session_id="a:1", slo="batch", deadline_s=0.1,
                        n_probes=8)
        clock.advance(5.0)  # long past deadline
        desk.poll()
        assert t.state == DONE  # sheddable=False work still runs

    def test_tight_deadline_preempts_loose_in_edf_order(self):
        desk, stub, clock = make_desk()
        desk.submit(session_id="loose:1", deadline_s=100.0, n_probes=8)
        desk.submit(session_id="tight:1", deadline_s=1.0, n_probes=8)
        clock.advance(0.5)  # both windows expired; neither deadline hit
        desk.poll()
        # the loose group arrived first but the tight group dispatches
        # first: EDF order, not FIFO
        assert stub.calls == [["tight:1"], ["loose:1"]]

    def test_shedding_is_visible_in_stats(self):
        desk, stub, clock = make_desk()
        desk.submit(session_id="a:1", deadline_s=0.0, n_probes=8)
        desk.submit(session_id="a:2", deadline_s=0.1, n_probes=8)
        ok = desk.submit(session_id="a:3", deadline_s=50.0, n_probes=8)
        clock.advance(0.2)  # second expires queued; third survives
        desk.poll()
        st = desk.stats()
        assert st["shed"] == 2
        assert st["completed"] == 1 and ok.state == DONE


class TestEDFScheduler:
    def _ticket(self, sid, key, deadline, sheddable=True):
        slo = SLOClass("t", deadline_s=1.0, sheddable=sheddable)
        return Ticket(session_id=sid, group_key=key, slo=slo,
                      deadline=deadline, n_probes=8, submitted_at=0.0)

    def test_group_order_by_earliest_member(self):
        s = EDFScheduler()
        s.add(self._ticket("a:1", ("a",), 5.0))
        s.add(self._ticket("a:2", ("a",), 0.5))  # drags group a forward
        s.add(self._ticket("b:1", ("b",), 2.0))
        assert s.group_order() == [("a",), ("b",)]

    def test_shed_expired_respects_slo_class(self):
        s = EDFScheduler()
        shed_me = self._ticket("a:1", ("a",), 1.0)
        keep_slo = self._ticket("a:2", ("a",), 1.0, sheddable=False)
        keep_late = self._ticket("b:1", ("b",), 9.0)
        for t in (shed_me, keep_slo, keep_late):
            s.add(t)
        out = s.shed_expired(now=2.0)
        assert out == [shed_me]
        assert len(s) == 2

    def test_claim_group_empties_it(self):
        s = EDFScheduler()
        s.add(self._ticket("a:1", ("a",), 1.0))
        s.add(self._ticket("a:2", ("a",), 2.0))
        got = s.claim_group(("a",))
        assert {t.session_id for t in got} == {"a:1", "a:2"}
        assert len(s) == 0 and s.group_order() == []


class TestAdaptiveBatcher:
    def test_cold_group_dispatches_immediately(self):
        b = AdaptiveBatcher(w_min=0.01, w_max=1.0, w_init=0.5)
        b.note_arrival(("g",), now=0.0)
        # ema starts at 1 -> target 1: no pointless cold-start hold
        assert b.ready(("g",), size=1, earliest_deadline=99.0, now=0.0)

    def test_target_tracks_executor_bucket_of_recent_sizes(self):
        b = AdaptiveBatcher(w_min=0.01, w_max=1.0, ema_alpha=1.0)
        b.on_dispatch(("g",), size=6, wall_s=0.01, expired=False, now=0.0)
        assert b.target(("g",)) == 8  # bucket(6) -> next power of two
        b.note_arrival(("g",), now=1.0)
        assert not b.ready(("g",), size=3, earliest_deadline=99.0, now=1.0)
        assert b.ready(("g",), size=8, earliest_deadline=99.0, now=1.0)

    def test_window_shrinks_under_load_grows_when_idle(self):
        b = AdaptiveBatcher(w_min=0.01, w_max=1.0, w_init=0.2,
                            ema_alpha=1.0)
        key = ("g",)
        b.on_dispatch(key, size=8, wall_s=0.01, expired=False, now=0.0)
        w0 = b._group(key).window_s
        # expiry at >= average size: waiting was long enough -> shrink
        b.note_arrival(key, now=1.0)
        b.on_dispatch(key, size=8, wall_s=0.01, expired=True, now=1.3)
        assert b._group(key).window_s < w0
        # expiry far below average: arrivals sparse -> grow
        b.on_dispatch(key, size=8, wall_s=0.01, expired=False, now=2.0)
        w1 = b._group(key).window_s
        b.note_arrival(key, now=3.0)
        b.on_dispatch(key, size=1, wall_s=0.01, expired=True, now=3.3)
        assert b._group(key).window_s > w1
        # and the window stays inside [w_min, w_max]
        for _ in range(20):
            b.note_arrival(key, now=4.0)
            b.on_dispatch(key, size=1, wall_s=0.01, expired=True, now=4.0)
        assert b._group(key).window_s <= b.w_max

    def test_deadline_urgency_forces_dispatch(self):
        b = AdaptiveBatcher(w_min=0.01, w_max=10.0, w_init=10.0,
                            ema_alpha=1.0)
        key = ("g",)
        b.on_dispatch(key, size=16, wall_s=0.5, expired=False, now=0.0)
        b.note_arrival(key, now=1.0)
        # window open, bucket unfilled — but the deadline is within two
        # dispatch walls, so waiting longer would shed admitted work
        assert b.ready(key, size=2, earliest_deadline=1.8, now=1.0)
        assert not b.ready(key, size=2, earliest_deadline=9.0, now=1.0)

    def test_wait_hint_is_time_to_soonest_expiry(self):
        b = AdaptiveBatcher(w_min=0.01, w_max=1.0, w_init=0.4)
        b.note_arrival(("a",), now=0.0)
        b.note_arrival(("b",), now=0.3)
        hint = b.wait_hint([("a",), ("b",)], now=0.35)
        assert hint == pytest.approx(0.05)  # group a expires first
        assert b.wait_hint([], now=0.0) is None


class TestPlaneStats:
    def test_stats_snapshot_is_consistent(self):
        desk, stub, clock = make_desk(capacity=4)
        desk.submit(session_id="a:1", n_probes=8)
        desk.submit(session_id="b:1", n_probes=8)
        st = desk.stats()
        assert st["live"] == st["admitted"] - st["completed"] - st["shed"] \
            - st["errors"] == 2
        assert st["pending"] == 2 and st["groups"] == 2
        clock.advance(1.0)
        desk.poll()
        st = desk.stats()
        assert st["live"] == 0 and st["dispatches"] == 2
        assert st["dispatched_probes"] == 16

    def test_dispatch_error_settles_tickets(self):
        desk, stub, clock = make_desk()

        def boom(sids, origin=None):
            raise RuntimeError("executor down")

        stub.step_sessions = boom
        t = desk.submit(session_id="a:1", n_probes=8)
        clock.advance(1.0)
        desk.poll()
        assert t.state == "error" and t.done
        st = desk.stats()
        assert st["errors"] == 1 and st["live"] == 0
        assert st["dispatch_errors"] == 1


class TestEndToEnd:
    """Real port MOOService + real MLP-surrogate solves behind the plane,
    on the host."""

    def _service(self):
        return MOOService(mogd=FAST, batch_rects=2, grid_l=2, device=CPU)

    def test_submit_to_completion_manual_poll(self):
        svc = self._service()
        desk = FrontDesk(svc, capacity=16)
        specs = [mlp_surrogate_task(seed=i, device=CPU) for i in range(3)]
        tickets = [desk.submit(spec=s, n_probes=8, slo="standard")
                   for s in specs]
        # same architecture -> one structure group -> dispatches coalesce
        assert len({t.group_key for t in tickets}) == 1
        for _ in range(50):
            desk.poll()
            if all(t.done for t in tickets):
                break
        assert all(t.ok for t in tickets)
        assert all(t.credited >= 8 for t in tickets)
        for t in tickets:
            F, _ = svc.frontier(t.session_id)
            assert len(F) >= 1
            rec = svc.recommend(t.session_id)
            assert np.isfinite(rec.objectives).all()
        st = svc.stats()
        assert st["in_flight_dispatches"] == 0
        assert st["in_flight_probes"] == 0
        assert desk.stats()["sessions"] == 3  # one per task signature

    def test_recurring_spec_reuses_session(self):
        svc = self._service()
        desk = FrontDesk(svc, capacity=16)
        t1 = desk.submit(spec=mlp_surrogate_task(seed=0, device=CPU),
                         n_probes=8)
        t2 = desk.submit(spec=mlp_surrogate_task(seed=0, device=CPU),
                         n_probes=8)
        assert t1.session_id == t2.session_id
        assert len(svc) == 1

    def test_dispatcher_thread_drains_asynchronously(self):
        svc = self._service()
        with FrontDesk(svc, capacity=16) as desk:
            tickets = [desk.submit(spec=mlp_surrogate_task(seed=i,
                                                           device=CPU),
                                   n_probes=8, slo="batch")
                       for i in range(2)]
            for t in tickets:
                assert t.wait(timeout=120.0), "dispatcher never completed"
            assert all(t.ok for t in tickets)
        assert desk._thread is None  # context exit stopped the thread

    def test_recommend_nonblocking_while_plane_dispatches(self):
        """The tentpole invariant end to end: while the dispatcher is
        mid-solve (service lock released), recommend answers from
        another thread."""
        svc = self._service()
        desk = FrontDesk(svc, capacity=16)
        t = desk.submit(spec=mlp_surrogate_task(seed=0, device=CPU),
                        n_probes=8)
        for _ in range(50):
            desk.poll()
            if t.done:
                break
        assert t.ok
        in_solve = threading.Event()
        release = threading.Event()
        orig = svc.executor.solve_requests

        def slow(requests, origin=None):
            in_solve.set()
            release.wait(timeout=30.0)
            return orig(requests, origin=origin)

        svc.executor.solve_requests = slow
        t2 = desk.submit(session_id=t.session_id, n_probes=8,
                         slo="batch")
        worker = threading.Thread(target=desk.poll, daemon=True)
        worker.start()
        assert in_solve.wait(timeout=30.0)
        got: list = []
        reader = threading.Thread(
            target=lambda: got.append(svc.recommend(t.session_id)),
            daemon=True)
        reader.start()
        reader.join(timeout=10.0)
        assert got, "recommend blocked behind an in-flight dispatch"
        assert svc.stats()["in_flight_dispatches"] == 1
        release.set()
        worker.join(timeout=60.0)
        assert t2.wait(timeout=60.0) and t2.ok


class TestInitOutsideTheLock:
    def test_recommend_nonblocking_while_a_session_initializes(self):
        """A new session's init phase (its k reference solves, device work
        on the card) runs with the service lock released: while the
        dispatcher initializes a newly admitted tenant, recommend on a
        served tenant answers, and the new tenant then completes."""
        svc = MOOService(mogd=FAST, batch_rects=2, grid_l=2, device=CPU)
        desk = FrontDesk(svc, capacity=16)
        t = desk.submit(spec=mlp_surrogate_task(seed=0, device=CPU),
                        n_probes=8)
        for _ in range(50):
            desk.poll()
            if t.done:
                break
        assert t.ok
        t2 = desk.submit(spec=mlp_surrogate_task(seed=1, device=CPU),
                         n_probes=8, slo="batch")
        engine = svc._sessions[t2.session_id].engine
        in_init, release = threading.Event(), threading.Event()
        orig = engine.initialize

        def slow_init():
            in_init.set()
            release.wait(timeout=30.0)
            return orig()

        engine.initialize = slow_init
        worker = threading.Thread(target=desk.poll, daemon=True)
        worker.start()
        assert in_init.wait(timeout=30.0)
        got: list = []
        reader = threading.Thread(
            target=lambda: got.append(svc.recommend(t.session_id)),
            daemon=True)
        reader.start()
        reader.join(timeout=10.0)
        assert got, "recommend blocked behind a session's init phase"
        release.set()
        worker.join(timeout=60.0)
        for _ in range(50):
            if t2.done:
                break
            desk.poll()
        assert t2.ok and svc.session_info(t2.session_id).probes >= 8


class TestFrontdeskFastPath:
    def test_exhausted_session_completes_at_submit(self):
        class RestoredStub(StubService):
            def session_exhausted(self, session_id):
                return session_id in self.exhausted

        stub = RestoredStub()
        stub.exhausted.add("a:1")
        desk, stub, clock = make_desk(stub=stub)
        t = desk.submit(session_id="a:1", n_probes=8)
        assert t.state == "done" and t.done
        assert stub.calls == []  # never dispatched
        st = desk.stats()
        assert st["fast_completions"] == 1
        assert st["live"] == 0  # admission slot released immediately
        # a non-exhausted session still rides the dispatch path
        t2 = desk.submit(session_id="a:2", n_probes=8)
        assert t2.state == "pending"

    def test_legacy_stub_without_probe_keeps_dispatching(self):
        desk, stub, clock = make_desk(StubService())
        t = desk.submit(session_id="a:1", n_probes=8)
        assert t.state == "pending"
        assert desk.stats()["fast_completions"] == 0


def _ticket_view(t) -> tuple:
    """Everything a ticket carries but its process-wide id."""
    return (t.session_id, t.group_key, t.slo.name, t.deadline, t.n_probes,
            t.submitted_at, t.state, t.credited, t.finished_at,
            t.last_enqueued_at, tuple(sorted(t.breakdown().items(),
                                             key=lambda kv: kv[0])))


class TestPlaneParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_schedule_same_tickets_and_stats(self, seed):
        """A seeded schedule of 120 operations through both planes:
        submits over 4 groups (every SLO class, deadlines from 0 to 3 s,
        budgets of 4 to 20 probes, some over the capacity), clock steps
        of 0 to 0.4 s, polls, sessions turning exhausted."""
        rng = np.random.default_rng(seed)
        planes = [make_desk(capacity=3, package=pkg) for pkg in (JF, None)]
        tickets = [[], []]
        for _ in range(120):
            op = rng.integers(0, 4)
            if op == 0:
                kw = dict(session_id=f"g{rng.integers(0, 4)}:"
                                     f"{rng.integers(0, 3)}",
                          slo=("interactive", "standard",
                               "batch")[rng.integers(0, 3)],
                          deadline_s=float(rng.choice(
                              [0.0, 0.05, 0.3, 1.0, 3.0])),
                          n_probes=int(rng.choice([4, 8, 20])))
                for i, (desk, _, _) in enumerate(planes):
                    tickets[i].append(desk.submit(**kw))
            elif op == 1:
                dt = float(rng.uniform(0.0, 0.4))
                for _, _, clock in planes:
                    clock.advance(dt)
            elif op == 2:
                for desk, _, _ in planes:
                    desk.poll()
            else:
                sid = f"g{rng.integers(0, 4)}:{rng.integers(0, 3)}"
                for _, stub, _ in planes:
                    stub.exhausted.add(sid)
            assert ([_ticket_view(t) for t in tickets[1]]
                    == [_ticket_view(t) for t in tickets[0]])
        (jdesk, jstub, _), (pdesk, pstub, _) = planes
        assert pstub.calls == jstub.calls and jstub.calls
        assert (json.dumps(pdesk.stats(), sort_keys=True)
                == json.dumps(jdesk.stats(), sort_keys=True))
        assert {t.state for t in tickets[1]} >= {DONE, SHED, REJECTED}


class TestKernelLibraryFromThreads:
    def test_first_launches_from_threads_build_once(self, monkeypatch):
        """The dispatcher thread may be the first to launch a kernel: any
        number of threads asking for the kernel library at once build and
        load it once (``native._LOCK``), and all get the same library."""
        import ctypes
        import time
        import types

        from repro_torch.kernels import native

        builds = []

        def build():
            builds.append(threading.get_ident())
            time.sleep(0.05)  # a build takes a while: others arrive
            return "librepro_torch_test.so"

        class FakeLib:
            def __getattr__(self, name):  # any entry point, typed below
                entry = types.SimpleNamespace()
                object.__setattr__(self, name, entry)
                return entry

        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "build", build)
        monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
        start = threading.Barrier(8)
        got = []

        def first_launch():
            start.wait()
            got.append(native.library())

        threads = [threading.Thread(target=first_launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        assert len(builds) == 1
        assert len(got) == 8 and all(lib is got[0] for lib in got)
