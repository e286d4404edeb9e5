"""The port's observability plane against the JAX reference's.

The classes mirror every test of ``tests/test_obs.py`` on the port: the
typed metrics registry (identity, exports, merge, thread safety under
concurrent writers), the tracer (no-op fast path, explicit parent chains,
Chrome export shape), the per-ticket latency attribution invariant (phase
breakdown sums to end-to-end latency) through the port's ``FrontDesk`` and
``MOOService`` on the host (``device="cpu"``), and the counter-drift
regression for the dispatch exception path, with the reference's
assertions and tolerances.

``TestExportParity`` feeds the same seeded samples to both packages'
registries: the snapshot, the JSON and the Prometheus text must be equal.
"""

from __future__ import annotations

import json
import math
import threading

import numpy as np
import pytest
import torch

import repro.obs as JO
from repro_torch.core import MOGDConfig
from repro_torch.core.synthetic import mlp_surrogate_task
from repro_torch.frontdesk import FrontDesk
from repro_torch.obs import (
    NOOP_SPAN,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Observability,
    Tracer,
)
from repro_torch.service import MOOService

CPU = "cpu"
FAST = MOGDConfig(steps=12, multistart=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- metrics: instruments + registry ---------------------------------------

class TestInstruments:
    def test_counter_monotone_and_rejects_negative(self):
        c = Counter("c")
        c.inc()
        c.inc(4)
        assert c.value == 5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_gauge_moves_both_ways(self):
        g = Gauge("g")
        g.inc(3)
        g.dec()
        assert g.value == 2
        g.set(-7.5)
        assert g.value == -7.5

    def test_histogram_matches_numpy_quantiles(self):
        h = Histogram("h")
        rng = np.random.default_rng(0)
        vals = rng.lognormal(mean=-5, sigma=1.5, size=1000)
        for v in vals:
            h.record(float(v))
        assert len(h) == 1000
        for q in (0.5, 0.95, 0.99):
            assert h.quantile(q) == pytest.approx(
                float(np.quantile(vals, q)), rel=1e-9)
        s = h.summary()
        assert s["count"] == 1000
        assert s["mean_s"] == pytest.approx(float(vals.mean()))
        assert s["p95_s"] == h.p95

    def test_histogram_empty_summary_is_nan(self):
        s = Histogram("h").summary()
        assert s["count"] == 0
        assert math.isnan(s["p50_s"]) and math.isnan(s["max_s"])

    def test_histogram_export_buckets(self):
        h = Histogram("h")
        for v in (1e-4, 1e-2, 1.0, 1e4):  # last lands in overflow
            h.record(v)
        out = h.histogram(n_buckets=24, lo_s=1e-5, hi_s=100.0)
        assert len(out["edges_s"]) == 24
        assert len(out["counts"]) == 25
        assert sum(out["counts"]) == 4
        assert out["counts"][-1] == 1  # the 1e4 overflow

    def test_histogram_truncation_keeps_exact_count_sum(self):
        h = Histogram("h", max_samples=100)
        for i in range(1000):
            h.record(1e-3 * (1 + i % 7))
        assert h.count == 1000
        q = h.quantile(0.5)  # bucket interpolation path
        assert 1e-3 <= q <= 8e-3
        assert h.summary()["count"] == 1000

    def test_merge_accumulates(self):
        a, b = Histogram("h"), Histogram("h")
        for v in (0.01, 0.02):
            a.record(v)
        b.record(0.04)
        a.merge(b)
        assert a.count == 3
        assert a.sum == pytest.approx(0.07)


class TestRegistry:
    def test_get_or_create_identity_by_name_and_labels(self):
        m = MetricsRegistry()
        c1 = m.counter("x", {"a": "1"})
        c2 = m.counter("x", {"a": "1"})
        c3 = m.counter("x", {"a": "2"})
        assert c1 is c2 and c1 is not c3

    def test_kind_mismatch_raises(self):
        m = MetricsRegistry()
        m.counter("x")
        with pytest.raises(TypeError):
            m.gauge("x")

    def test_snapshot_and_json(self):
        m = MetricsRegistry()
        m.counter("reqs", {"plane": "p0"}).inc(3)
        m.histogram("lat").record(0.5)
        snap = m.snapshot()
        assert snap["reqs{plane=p0}"]["value"] == 3
        assert snap["lat"]["count"] == 1
        assert json.loads(m.to_json())  # strictly valid

    def test_prometheus_format(self):
        m = MetricsRegistry()
        m.counter("reqs_total", {"plane": "p0"}, help="requests").inc(2)
        m.histogram("lat").record(0.01)
        text = m.to_prometheus()
        assert "# TYPE reqs_total counter" in text
        assert 'reqs_total{plane="p0"} 2' in text
        assert 'le="+Inf"' in text
        assert "lat_count 1" in text

    def test_concurrent_hammer_snapshots_consistent(self):
        """N writer threads inc + record while the main thread
        snapshots: every snapshot must be internally consistent (the
        histogram count equals the counter value at the same moment —
        both mutate under one registry lock per writer iteration is NOT
        guaranteed, so assert monotonicity + exact final totals)."""
        m = MetricsRegistry()
        n_threads, n_iters = 4, 2000
        c = m.counter("ops")
        h = m.histogram("lat")
        stop = threading.Event()

        def writer():
            for i in range(n_iters):
                h.record(1e-3)
                c.inc()

        threads = [threading.Thread(target=writer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        seen_c, seen_h = [], []
        while any(t.is_alive() for t in threads):
            snap = m.snapshot()
            seen_c.append(snap["ops"]["value"])
            seen_h.append(snap["lat"]["count"])
        for t in threads:
            t.join()
        stop.set()
        # monotone reads, never exceeding the true total
        total = n_threads * n_iters
        assert all(b >= a for a, b in zip(seen_c, seen_c[1:]))
        assert all(b >= a for a, b in zip(seen_h, seen_h[1:]))
        assert all(v <= total for v in seen_c + seen_h)
        final = m.snapshot()
        assert final["ops"]["value"] == total
        assert final["lat"]["count"] == total
        assert final["lat"]["sum"] == pytest.approx(total * 1e-3)


# -- tracer ----------------------------------------------------------------

class TestTracer:
    def test_disabled_returns_shared_noop(self):
        tr = Tracer(enabled=False)
        sp = tr.span("x")
        assert sp is NOOP_SPAN and not sp.enabled
        with sp:
            sp.set("k", 1)  # all no-ops
        assert len(tr) == 0
        assert tr.record_span("x", 0.0, 1.0) is None
        assert tr.now() == 0.0

    def test_nesting_parent_chain(self):
        tr = Tracer(enabled=True)
        with tr.span("outer") as outer:
            with tr.span("inner", parent=outer) as inner:
                pass
        spans = tr.spans()
        assert [s.name for s in spans] == ["inner", "outer"]
        assert spans[0].parent_id == outer.span_id
        assert spans[1].parent_id is None

    def test_record_span_retroactive(self):
        tr = Tracer(enabled=True)
        t0 = tr.now()
        t1 = tr.now()
        sp = tr.record_span("x", t0, t1, args={"a": 1})
        assert sp.t0 == t0 and sp.t1 == t1
        assert tr.spans()[0].args["a"] == 1

    def test_ring_buffer_bounds_memory(self):
        tr = Tracer(enabled=True, max_spans=10)
        for i in range(25):
            tr.span(f"s{i}").end()
        assert len(tr) == 10
        assert tr.spans()[0].name == "s15"

    def test_error_annotation_on_exception(self):
        tr = Tracer(enabled=True)
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                raise RuntimeError("x")
        assert tr.spans()[0].args["error"] == "RuntimeError"

    def test_chrome_trace_shape_and_containment(self):
        tr = Tracer(enabled=True)
        with tr.span("parent") as p:
            with tr.span("child", parent=p):
                pass
        doc = tr.chrome_trace()
        assert doc["displayTimeUnit"] == "ms"
        evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert len(evs) == 2 and metas
        by_name = {e["name"]: e for e in evs}
        par, chi = by_name["parent"], by_name["child"]
        assert chi["args"]["parent_id"] == par["args"]["span_id"]
        # child interval nests inside the parent interval
        assert chi["ts"] >= par["ts"]
        assert chi["ts"] + chi["dur"] <= par["ts"] + par["dur"] + 1e-6
        json.dumps(doc)  # serializable

    def test_export_chrome_writes_loadable_json(self, tmp_path):
        tr = Tracer(enabled=True)
        tr.span("x").end()
        path = tr.export_chrome(tmp_path / "trace.json")
        doc = json.loads(open(path).read())
        assert any(e["name"] == "x" for e in doc["traceEvents"])


# -- stats() surfaces stay views over the registry -------------------------

class TestStatsViews:
    def test_service_and_executor_stats_keys(self):
        svc = MOOService(mogd=FAST, batch_rects=1, grid_l=2, device=CPU)
        for key in ("sessions", "in_flight_probes", "in_flight_dispatches",
                    "solver_cache_hits", "coalesced_batches",
                    "vault_restores"):
            assert key in svc.stats()
        ex = svc.executor.stats()
        for key in ("dispatches", "probes", "compiles", "useful_rows",
                    "fill_ratio", "dispatch_origins"):
            assert key in ex
        # the whole stack shares ONE registry
        assert svc.executor.obs.metrics is svc.obs.metrics

    def test_registry_backs_legacy_int_surface(self):
        svc = MOOService(mogd=FAST, batch_rects=1, grid_l=2, device=CPU)
        sid = svc.create_session(mlp_surrogate_task(seed=0, device=CPU))
        svc.step_sessions([sid], origin="test")
        ex = svc.executor
        assert ex.dispatches >= 1
        assert ex.dispatch_origins.get("test", 0) >= 1
        snap = svc.obs.metrics.snapshot()
        key = next(k for k in snap if k.startswith("exec.dispatches{"))
        assert snap[key]["value"] == ex.dispatches


# -- end-to-end: request-path trace + latency attribution ------------------

class TestServingTrace:
    def _stack(self):
        obs = Observability(trace=True)
        svc = MOOService(mogd=FAST, batch_rects=2, grid_l=2, obs=obs,
                         device=CPU)
        return obs, svc

    def test_span_taxonomy_and_breakdown_sums(self):
        obs, svc = self._stack()
        desk = FrontDesk(svc, capacity=16)
        assert desk.obs is obs  # plane adopts the service bundle
        tickets = [desk.submit(spec=mlp_surrogate_task(seed=i, device=CPU),
                               n_probes=8, slo="standard")
                   for i in range(3)]
        for _ in range(50):
            desk.poll()
            if all(t.done for t in tickets):
                break
        assert all(t.ok for t in tickets)

        # -- attribution: phases sum to end-to-end, on the plane clock
        for t in tickets:
            b = t.breakdown()
            assert b["e2e_s"] is not None
            assert b["accounted_s"] == pytest.approx(b["e2e_s"],
                                                     abs=1e-6)
            assert all(b[k] >= 0.0 for k in
                       ("queue_wait_s", "batch_wait_s", "dispatch_s",
                        "absorb_s", "persist_s"))
            assert b["dispatch_s"] > 0.0  # real solves ran

        # -- taxonomy: the request path appears, correctly nested
        spans = {s.span_id: s for s in obs.tracer.spans()}
        names = {s.name for s in spans.values()}
        assert {"frontdesk.admit", "frontdesk.schedule",
                "frontdesk.dispatch", "service.step_round",
                "service.prepare", "service.solve", "service.absorb",
                "exec.dispatch"} <= names

        def parents_of(name):
            out = set()
            for s in spans.values():
                if s.name == name and s.parent_id in spans:
                    out.add(spans[s.parent_id].name)
            return out

        assert parents_of("service.step_round") == {"frontdesk.dispatch"}
        assert parents_of("service.solve") == {"service.step_round"}
        assert parents_of("exec.dispatch") <= {"service.solve"}
        # every child interval nests inside its parent's
        for s in spans.values():
            if s.parent_id in spans:
                p = spans[s.parent_id]
                assert s.t0 >= p.t0 - 1e-9
                assert s.t1 <= p.t1 + 1e-9

        # the stats() latency view carries the recorded phases
        lat = desk.stats()["latency"]
        assert lat["e2e_s"]["count"] == 3
        assert lat["dispatch_s"]["count"] == 3

    def test_breakdown_without_tracing(self):
        """Attribution is metrics-path, not tracing-path: it must hold
        with the tracer disabled (the default)."""
        svc = MOOService(mogd=FAST, batch_rects=2, grid_l=2,
                         device=CPU)
        desk = FrontDesk(svc, capacity=16)
        t = desk.submit(spec=mlp_surrogate_task(seed=0, device=CPU),
                        n_probes=8)
        for _ in range(50):
            desk.poll()
            if t.done:
                break
        assert t.ok and len(svc.obs.tracer) == 0
        b = t.breakdown()
        assert b["accounted_s"] == pytest.approx(b["e2e_s"], abs=1e-6)


# -- counter drift on the dispatch exception path --------------------------

class TestCounterDrift:
    def test_failed_dispatch_restores_baseline(self):
        svc = MOOService(mogd=FAST, batch_rects=2, grid_l=2,
                         device=CPU)
        desk = FrontDesk(svc, capacity=16)
        t0 = desk.submit(spec=mlp_surrogate_task(seed=0, device=CPU),
                         n_probes=8)
        for _ in range(50):
            desk.poll()
            if t0.done:
                break
        assert t0.ok
        ex = svc.executor
        base_ex = {"dispatches": ex.dispatches,
                   "compiles": ex.total_compiles}
        base_svc = svc.stats()

        orig = ex.solve_requests

        def boom(requests, origin=None, **kw):
            raise RuntimeError("mid-flight device failure")

        ex.solve_requests = boom
        t1 = desk.submit(session_id=t0.session_id, n_probes=8,
                         slo="batch")
        desk.poll()
        assert t1.state == "error"
        ex.solve_requests = orig

        st = svc.stats()
        # in-flight gauges wound back by the exception path
        assert st["in_flight_dispatches"] == 0
        assert st["in_flight_probes"] == 0
        # restore() pushes back the prepared grid cells (they partition
        # the popped rectangles, preserving uncertain volume), so the
        # queue is non-empty — nothing was lost to the failed dispatch
        assert st["queue_depth"] >= base_svc["queue_depth"]
        # the failed round never reached the executor's counters
        assert ex.dispatches == base_ex["dispatches"]
        assert ex.total_compiles == base_ex["compiles"]
        assert desk.stats()["dispatch_errors"] == 1
        # and the plane still serves: the next round succeeds
        t2 = desk.submit(session_id=t0.session_id, n_probes=8,
                         slo="batch")
        for _ in range(50):
            desk.poll()
            if t2.done:
                break
        assert t2.ok
        assert svc.stats()["in_flight_dispatches"] == 0


# -- the port's exports against the reference's ----------------------------

class TestExportParity:
    @pytest.mark.parametrize("max_samples", [None, 100])
    def test_same_samples_same_exports(self, max_samples):
        """Counters, gauges and histograms (sampled and bucket-truncated)
        fed the same values export the same snapshot, JSON and Prometheus
        text in both packages."""
        rng = np.random.default_rng(7)
        vals = rng.lognormal(mean=-5, sigma=1.5, size=600)
        kw = {} if max_samples is None else {"max_samples": max_samples}
        regs = []
        for pkg_reg in (JO.MetricsRegistry(), MetricsRegistry()):
            pkg_reg.counter("reqs_total", {"plane": "p0"},
                            help="requests").inc(5)
            g = pkg_reg.gauge("live", {"plane": "p0"})
            g.inc(3)
            g.dec()
            h = pkg_reg.histogram("lat", {"plane": "p0"}, **kw)
            for v in vals:
                h.record(float(v))
            regs.append(pkg_reg)
        ref, port = regs
        assert (json.dumps(port.snapshot(), sort_keys=True)
                == json.dumps(ref.snapshot(), sort_keys=True))
        assert port.to_json() == ref.to_json()
        assert port.to_prometheus() == ref.to_prometheus()
        for q in (0.5, 0.95, 0.99):
            assert (port.histogram("lat", {"plane": "p0"}).quantile(q)
                    == ref.histogram("lat", {"plane": "p0"}).quantile(q))
