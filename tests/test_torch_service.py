"""The port's multi-tenant MOOService against the JAX reference.

One parity test runs the same traffic through both services: eight
``batch_suite()`` tenants whose paper-shape-input MLP surrogates (12 Spark
knobs, D = 13, narrow hidden layers) carry the reference's weights across,
plus the 5-stage ETL job of ``examples/multistage_job.py`` as a DAG
session, for three ``step_all`` rounds with the reference's random draws
fed to the port.  Per-round batches, probes and sessions, and the
service's coalescing and cache counters, must be equal; every tenant's
and the DAG's hypervolume must lie within ±0.5 % of the reference's (the
band of ``tests/test_torch_pf.py``).

The classes after it mirror every test of ``tests/test_service.py`` and
``tests/test_dag.py::TestServiceDag`` on the port, on the host
(``device="cpu"``).
"""

from __future__ import annotations

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.data.workloads as JW
from repro.exec import stack_programs as j_stack_programs
from repro.models.mlp import MLPRegressor as JMLPRegressor
from repro.models.mlp import MLPSpec as JMLPSpec
from repro.models.mlp import init_mlp as j_init_mlp
from repro.service import MOOService as JMOOService
import repro_torch.core as P
import repro_torch.data.workloads as PW
from repro_torch.core import MOGDConfig
from repro_torch.core.problem import MOOProblem
from repro_torch.core.synthetic import mlp_surrogate_task, sphere2_task, zdt1_task
from repro_torch.core.task import (
    UtopiaNearest,
    WeightedUtopiaNearest,
    WorkloadAware,
)
from repro_torch.models.convert import program_from_numpy
from repro_torch.service import MOOService

CPU = "cpu"
FAST = MOGDConfig(steps=60, multistart=6)
HV_BAND = 0.005  # ±0.5 % of the reference's HV
READER_PAUSE_S = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def svc():
    return MOOService(mogd=FAST, batch_rects=2, grid_l=2, device=CPU)


def _export(tree):
    if isinstance(tree, dict):
        return {k: _export(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_export(v) for v in tree)
    return np.asarray(tree)


def _reference_draws(monkeypatch):
    """Make the port draw the reference's numbers: every solver replays the
    reference solver's key stream, problem sampling the reference's
    ``PRNGKey(seed)`` uniforms."""

    def draw_starts(self, B):
        key = getattr(self, "_ref_key", None)
        if key is None:
            key = jax.random.PRNGKey(self.config.seed)
        self._ref_key, sub = jax.random.split(key)
        return np.array(jax.random.uniform(
            sub, (B, self.config.multistart, self.problem.dim)))

    def sample(self, generator, n):
        u = jax.random.uniform(jax.random.PRNGKey(generator.initial_seed()),
                               (n, self.dim))
        return torch.as_tensor(np.array(u), device=self.device)

    monkeypatch.setattr(P.MOGDSolver, "draw_starts", draw_starts)
    monkeypatch.setattr(MOOProblem, "sample", sample)


def _tenant_pair(i, w, hidden=(16, 16)):
    """(reference, port) TaskSpecs for one batch workload: two MLP
    surrogates on log targets over the 12 Spark knobs, scaled by the
    workload's CPU demand, weights from the reference's ``init_mlp``."""
    D = 13
    scale = w.w_cpu / 1000.0
    regs = []
    for j, y_mean in enumerate((math.log(60.0 * scale),
                                math.log(2.0 * scale))):
        spec = JMLPSpec(D, hidden, 1)
        regs.append(JMLPRegressor(
            spec=spec, params=j_init_mlp(jax.random.PRNGKey(1000 * i + j),
                                         spec),
            x_mean=jnp.full((D,), 0.5), x_std=jnp.full((D,), 0.29),
            y_mean=jnp.float32(y_mean), y_std=jnp.float32(0.5),
            dropout=0.0, log_target=True))
    jprog = j_stack_programs([r.as_program() for r in regs])
    names = ("latency_s", "cost_usd")
    jt = J.TaskSpec(knobs=tuple(JW.spark_space()),
                    objectives=tuple(J.Objective(n) for n in names),
                    program=jprog, name=w.name)
    pt = P.TaskSpec(knobs=tuple(PW.spark_space()),
                    objectives=tuple(P.Objective(n) for n in names),
                    program=program_from_numpy(jprog.structure,
                                               _export(jprog.params),
                                               device=CPU),
                    name=w.name, device=CPU)
    return jt, pt


ETL_THETAS = (
    ("extract", (3.0, 0.4, 0.3, 0.6)),
    ("transform_a", (2.0, 0.2, 0.9, 0.8)),
    ("transform_b", (4.5, 0.3, 0.5, 0.5)),
    ("join", (2.5, 0.5, 1.2, 1.0)),
    ("report", (1.0, 0.1, 0.2, 0.4)),
)
ETL_EDGES = (("extract", "transform_a"), ("extract", "transform_b"),
             ("transform_a", "join"), ("transform_b", "join"),
             ("join", "report"))


def _etl_job(pkg):
    """The 5-stage ETL job of ``examples/multistage_job.py``."""
    fam = (J.make_analytics_family() if pkg is J
           else P.make_analytics_family(device=CPU))
    return pkg.JobDAG([fam.stage(n, th) for n, th in ETL_THETAS], ETL_EDGES,
                      name="etl")


def _hv_pair(F_ref, F_port):
    F_all = np.concatenate([F_ref, F_port])
    point = F_all.max(0) + 0.1 * (F_all.max(0) - F_all.min(0))
    return J.hypervolume(F_ref, point), P.hypervolume(F_port, point)


# ---------------------------------------------------------------------------
class TestServiceAgainstReference:
    def test_tenants_and_dag_session_match_reference(self, monkeypatch):
        _reference_draws(monkeypatch)
        cfg = dict(steps=30, multistart=4)
        suite = PW.batch_suite()
        pairs = [_tenant_pair(i, w) for i, w in enumerate(suite[:8])]
        jsvc = JMOOService(mogd=J.MOGDConfig(**cfg), batch_rects=4)
        psvc = MOOService(mogd=MOGDConfig(**cfg), batch_rects=4,
                          use_kernel=True, device=CPU)
        j_sids = [jsvc.create_session(jt) for jt, _ in pairs]
        p_sids = [psvc.create_session(pt) for _, pt in pairs]
        j_dag = jsvc.create_dag_session(_etl_job(J))
        p_dag = psvc.create_dag_session(_etl_job(P))
        for _ in range(3):
            want = jsvc.step_all(rounds=1)
            got = psvc.step_all(rounds=1)
            assert got == want
        js, ps = jsvc.stats(), psvc.stats()
        for key in ("sessions", "dag_sessions", "compiled_solvers",
                    "compiled_problems", "solver_cache_hits",
                    "problem_cache_hits", "coalesced_batches",
                    "coalesced_probes", "total_probes", "in_flight_probes",
                    "in_flight_dispatches"):
            assert ps[key] == js[key], key
        for js_id, ps_id in zip(j_sids, p_sids):
            hv_ref, hv_port = _hv_pair(jsvc.frontier(js_id)[0],
                                       psvc.frontier(ps_id)[0])
            assert hv_ref > 0.0
            assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (
                js_id, hv_port, hv_ref)
        want_c, got_c = jsvc.dag_frontier(j_dag), psvc.dag_frontier(p_dag)
        hv_ref, hv_port = _hv_pair(want_c.F, got_c.F)
        assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)
        rec = psvc.recommend_dag(p_dag)
        assert sorted(rec.stage_configs) == sorted(n for n, _ in ETL_THETAS)

    def test_default_device_is_cuda_and_raises_here(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match="CUDA"):
            MOOService()

    @pytest.mark.parametrize("kw", [
        dict(kernel_interpret=False), dict(kernel_interpret=True)])
    def test_later_slices_parameters_are_refused(self, kw):
        # Pallas interpret mode has no torch counterpart: the port routes
        # by the tensors' device (ROADMAP Queue 3 item 8)
        with pytest.raises(TypeError):
            MOOService(device=CPU, **kw)

    @pytest.mark.parametrize("mesh", [None, "auto"])
    def test_mesh_parameter_is_accepted(self, mesh):
        svc = MOOService(device=CPU, mesh=mesh)
        assert svc.executor.mesh is None  # one host device: unsharded

    @pytest.mark.parametrize("kw", [
        dict(vault=None), dict(vault_autosave_probes=8)])
    def test_vault_parameters_are_accepted(self, kw):
        svc = MOOService(device=CPU, **kw)
        assert svc.vault is None
        assert svc.vault_autosave_probes == kw.get("vault_autosave_probes",
                                                   64)
        assert svc.stats()["vault_snapshots"] == 0

    @pytest.mark.parametrize("kw", [
        dict(workloads={"extract": "w"}),
        dict(registry=object(), workloads={"nope": "w"})])
    def test_dag_session_model_server_arguments_are_refused(self, kw):
        """The model-server arguments are accepted since the model server
        was ported; stage workloads without a registry, or naming a stage
        the job does not have, are refused as in the reference."""
        match = "unknown stages" if "registry" in kw else "registry"
        svc = MOOService(device=CPU)
        with pytest.raises(ValueError, match=match):
            svc.create_dag_session(_etl_job(P), **kw)
        assert len(svc) == 0

    def test_later_slices_methods_are_absent(self, tmp_path):
        """The vault's surface, refused until the persistence plane was
        ported, is there and works on the host: a closed session is
        snapshotted, and a fresh service restores it with no dispatch."""
        from repro_torch.modelserver import ModelRegistry
        from repro_torch.persist import FrontierVault

        for name in ("persist_workload", "rehydrate"):
            assert callable(getattr(ModelRegistry, name))
        vault = FrontierVault(tmp_path, write_behind=False)
        svc = MOOService(mogd=FAST, batch_rects=2, grid_l=2, device=CPU,
                         vault=vault)
        sid = svc.create_session(sphere2_task(device=CPU))
        svc.run_until(min_probes=6)
        F, _ = svc.frontier(sid)
        svc.close_session(sid)
        assert svc.vault_snapshots == 1 and svc.vault_restores == 0
        again = MOOService(mogd=FAST, batch_rects=2, grid_l=2, device=CPU,
                           vault=vault)
        sid2 = again.create_session(sphere2_task(device=CPU))
        assert (again.vault_restores, again.vault_seeds,
                again.vault_tombstones) == (1, 0, 0)
        np.testing.assert_array_equal(again.frontier(sid2)[0], F)
        assert again.stats()["executor_dispatches"] == 0


# ---------------------------------------------------------------------------
# Mirrors of tests/test_service.py
# ---------------------------------------------------------------------------


class TestSessions:
    def test_eight_concurrent_sessions(self, svc):
        sids = [svc.create_session(zdt1_task(device=CPU)) for _ in range(4)]
        sids += [svc.create_session(sphere2_task(device=CPU))
                 for _ in range(4)]
        assert len(svc) == 8
        out = svc.run_until(min_probes=12)
        assert out["probes"] > 0
        for sid in sids:
            F, X = svc.frontier(sid)
            assert len(F) >= 2
            assert F.shape[1] == 2 and X.shape[0] == F.shape[0]
            info = svc.session_info(sid)
            assert info.probes >= 12 or info.exhausted

    def test_solver_cache_shared_by_signature(self, svc):
        s1 = svc.create_session(zdt1_task(device=CPU))
        s2 = svc.create_session(zdt1_task(device=CPU))
        s3 = svc.create_session(sphere2_task(device=CPU))
        st = svc.stats()
        assert st["compiled_solvers"] == 2
        assert st["solver_cache_hits"] == 1
        e1 = svc._sessions[s1].engine
        e2 = svc._sessions[s2].engine
        e3 = svc._sessions[s3].engine
        assert e1.solver is e2.solver
        assert e1.solver is not e3.solver

    def test_content_signature_distinguishes_specs(self):
        assert (zdt1_task(device=CPU).signature()
                == zdt1_task(device=CPU).signature())
        assert (zdt1_task(d=6, device=CPU).signature()
                != zdt1_task(d=5, device=CPU).signature())
        assert (zdt1_task(device=CPU).signature()
                != sphere2_task(device=CPU).signature())

    def test_session_limit(self):
        svc = MOOService(mogd=FAST, max_sessions=2, device=CPU)
        svc.create_session(zdt1_task(device=CPU))
        svc.create_session(zdt1_task(device=CPU))
        with pytest.raises(RuntimeError):
            svc.create_session(zdt1_task(device=CPU))

    def test_close_session(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        assert len(svc) == 1
        svc.close_session(sid)
        assert len(svc) == 0
        with pytest.raises(KeyError):
            svc.frontier(sid)

    def test_recurring_solver_survives_close(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.close_session(sid)
        assert svc.stats()["compiled_solvers"] == 1
        svc.create_session(zdt1_task(device=CPU))
        assert svc.stats()["solver_cache_hits"] == 1
        assert svc.stats()["problem_cache_hits"] == 1

    def test_zero_batch_rects_rejected(self, svc):
        with pytest.raises(ValueError):
            svc.create_session(zdt1_task(device=CPU), batch_rects=0)

    def test_failed_dispatch_restores_queue(self, svc, monkeypatch):
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.run_until(min_probes=6)
        sess = svc._sessions[sid]
        vol = sess.state.queue.total_volume
        probes = sess.state.probes

        def boom(*a, **k):
            raise RuntimeError("device lost")

        monkeypatch.setattr(svc.executor, "solve_requests", boom)
        with pytest.raises(RuntimeError):
            svc.step_all()
        assert sess.state.queue.total_volume == pytest.approx(vol, rel=1e-9)
        assert sess.state.probes == probes


class TestEviction:
    def test_open_session_survives_cache_pressure(self):
        svc = MOOService(mogd=FAST, batch_rects=2, max_cached_tasks=3,
                         device=CPU)
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.probe(sid, n_probes=6)
        sess = svc._sessions[sid]
        live_sig, live_solver_key = sess.signature, sess.solver_key
        for d in range(3, 12):
            one_shot = svc.create_session(zdt1_task(d=d, device=CPU))
            svc.close_session(one_shot)
        assert len(svc._problems) <= svc.max_cached_tasks
        assert live_sig in svc._problems
        assert live_solver_key in svc._solvers
        assert svc._sessions[sid].problem is svc._problems[live_sig]
        before = svc.session_info(sid).probes
        svc.probe(sid, n_probes=4)
        assert svc.session_info(sid).probes > before

    def test_closed_sessions_do_get_evicted(self):
        svc = MOOService(mogd=FAST, max_cached_tasks=2, device=CPU)
        sigs = []
        for d in range(3, 8):
            sid = svc.create_session(zdt1_task(d=d, device=CPU))
            sigs.append(svc._sessions[sid].signature)
            svc.close_session(sid)
        assert len(svc._problems) <= 2
        assert sigs[0] not in svc._problems
        assert all(k[0] != sigs[0] for k in svc._solvers)


class TestStructureCoalescing:
    def _mlp_spec(self, i, d=3, arch=(8, 8)):
        return mlp_surrogate_task(seed=i, d=d, arch=arch, name=f"wl-{i}",
                                  device=CPU)

    def test_distinct_workloads_one_structure_one_batch(self):
        svc = MOOService(mogd=FAST, batch_rects=2, device=CPU)
        specs = [self._mlp_spec(i) for i in range(4)]
        assert len({s.signature() for s in specs}) == 4
        for s in specs:
            svc.create_session(s)
        out = svc.step_all()
        st = svc.stats()
        assert out["sessions"] == 4 and out["batches"] == 1
        assert st["executor_structures"] == 1

    def test_legacy_mode_dispatches_per_tenant(self):
        svc = MOOService(mogd=FAST, batch_rects=2,
                         structure_coalescing=False, device=CPU)
        for i in range(4):
            svc.create_session(self._mlp_spec(i))
        out = svc.step_all()
        assert out["sessions"] == 4 and out["batches"] == 4
        assert svc.stats()["executor_structures"] == 4


class TestResume:
    def test_resume_returns_superset_frontier(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        r1 = svc.probe(sid, n_probes=8)
        F1 = np.asarray(r1.F)
        r2 = svc.probe(sid, n_probes=16)
        F2 = np.asarray(r2.F)
        assert r2.probes > r1.probes
        live = {tuple(np.round(f, 9)) for f in F2}
        for f in F1:
            if tuple(np.round(f, 9)) in live:
                continue
            dom = np.all(F2 <= f, axis=1) & np.any(F2 < f, axis=1)
            assert dom.any()

    def test_coalesced_and_per_session_probes_mix(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.run_until(min_probes=8)
        p1 = svc.session_info(sid).probes
        svc.probe(sid, n_probes=8)
        assert svc.session_info(sid).probes > p1


class TestRecommend:
    def test_preferences(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.probe(sid, n_probes=24)
        un = svc.recommend(sid, preference=UtopiaNearest())
        lat = svc.recommend(sid, preference=WeightedUtopiaNearest((0.9, 0.1)))
        cost = svc.recommend(sid, preference=WeightedUtopiaNearest((0.1, 0.9)))
        assert lat.objectives[0] <= cost.objectives[0] + 1e-9
        assert cost.objectives[1] <= lat.objectives[1] + 1e-9
        wl = svc.recommend(sid, preference=WorkloadAware(
            (0.5, 0.5), default_latency_s=500.0))
        assert wl.frontier_size == un.frontier_size
        assert set(un.config) == {f"x{i}" for i in range(6)}

    def test_legacy_strategy_shim_warns(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.probe(sid, n_probes=8)
        with pytest.warns(DeprecationWarning):
            rec = svc.recommend(sid, strategy="un")
        assert rec.index == svc.recommend(
            sid, preference=UtopiaNearest()).index

    def test_recommend_before_probe_raises(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        with pytest.raises(RuntimeError):
            svc.recommend(sid)

    def test_unknown_strategy_raises(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.probe(sid, n_probes=6)
        with pytest.raises(ValueError), pytest.warns(DeprecationWarning):
            svc.recommend(sid, strategy="nope")


class TestConcurrentServing:
    def test_recommend_and_stats_during_inflight_dispatch(self, svc):
        sid = svc.create_session(zdt1_task(device=CPU))
        svc.probe(sid, n_probes=6)
        in_solve, release = threading.Event(), threading.Event()
        orig = svc.executor.solve_requests

        def slow(requests, origin=None):
            in_solve.set()
            release.wait(timeout=30.0)
            return orig(requests, origin=origin)

        svc.executor.solve_requests = slow
        try:
            stepper = threading.Thread(target=svc.step_all, daemon=True)
            stepper.start()
            assert in_solve.wait(timeout=30.0)
            got: list = []

            def read():
                got.append(svc.stats())
                got.append(svc.recommend(sid))

            reader = threading.Thread(target=read, daemon=True)
            reader.start()
            reader.join(timeout=10.0)
            assert len(got) == 2, "stats/recommend blocked behind dispatch"
            st = got[0]
            assert st["in_flight_dispatches"] == 1
            assert st["in_flight_probes"] > 0
        finally:
            release.set()
        stepper.join(timeout=60.0)
        assert not stepper.is_alive()
        st = svc.stats()
        assert st["in_flight_dispatches"] == 0
        assert st["in_flight_probes"] == 0

    def test_recommend_hammer_while_step_all_runs(self, svc):
        sids = [svc.create_session(zdt1_task(device=CPU)),
                svc.create_session(sphere2_task(device=CPU))]
        for sid in sids:
            svc.probe(sid, n_probes=6)
        stop = threading.Event()
        errors: list = []
        counts = [0]

        def hammer():
            # the reader pauses 1 ms between rounds: PyTorch releases the
            # GIL around every operator, and a reader that never yields
            # takes it back each time, starving the stepping thread's
            # eager dispatch on the host
            while not stop.wait(READER_PAUSE_S):
                try:
                    for sid in sids:
                        rec = svc.recommend(sid)
                        assert rec.frontier_size >= 1
                        st = svc.stats()
                        assert st["in_flight_dispatches"] >= 0
                    counts[0] += 1
                except Exception as e:  # surfaced after the join
                    errors.append(e)
                    return

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            svc.run_until(min_probes=40)
        finally:
            stop.set()
            t.join(timeout=10.0)
        assert not errors, f"reader thread failed: {errors[:1]}"
        assert counts[0] > 0


# ---------------------------------------------------------------------------
# Mirrors of tests/test_dag.py::TestServiceDag
# ---------------------------------------------------------------------------

DAG_MOGD = MOGDConfig(steps=30, multistart=4)


class TestServiceDag:
    def test_dag_session_lifecycle(self):
        fam = P.make_analytics_family(device=CPU)
        rng = np.random.default_rng(10)
        stages = [fam.stage(f"s{i}", rng.uniform(0.5, 3.0, 4))
                  for i in range(2)]
        stages.append(fam.stage("s2", np.asarray(stages[0].theta)))
        dag = P.JobDAG(stages, [("s0", "s1"), ("s1", "s2")])
        svc = MOOService(mogd=DAG_MOGD, batch_rects=2, device=CPU)
        did = svc.create_dag_session(dag)
        st = svc.stats()
        assert st["dag_sessions"] == 1
        assert st["sessions"] == 2
        with pytest.raises(RuntimeError, match="probe first"):
            svc.recommend_dag(did)
        svc.run_until(min_probes=8)
        comp = svc.dag_frontier(did)
        assert len(comp) > 0
        rec = svc.recommend_dag(did)
        assert sorted(rec.stage_configs) == ["s0", "s1", "s2"]
        assert set(rec.stage_configs["s0"]) == {"parallelism", "mem_frac"}
        assert rec.objectives.shape == (2,)
        svc.close_dag_session(did)
        st = svc.stats()
        assert st["sessions"] == 0 and st["dag_sessions"] == 0

    def test_dag_probes_coalesce_with_other_tenants(self):
        fam = P.make_analytics_family(device=CPU)
        theta = (1.0, 0.5, 0.7, 0.9)
        dag = P.JobDAG([fam.stage("s0", theta)])
        svc = MOOService(mogd=DAG_MOGD, batch_rects=2, device=CPU)
        svc.create_dag_session(dag)
        svc.create_session(fam.stage("other", theta).task)
        assert svc.stats()["problem_cache_hits"] == 1
        svc.step_all(rounds=1)
        assert svc.stats()["coalesced_batches"] == 1

    def test_dag_frontier_composes_through_the_kernel_path(self):
        """With ``use_kernel`` the service composes through the compose
        wrapper (here its plain version) and equals the oracle path."""
        svc = MOOService(mogd=DAG_MOGD, batch_rects=2, use_kernel=True,
                         device=CPU)
        dag = _etl_job(P)
        did = svc.create_dag_session(dag)
        svc.run_until(min_probes=8)
        got = svc.dag_frontier(did)
        frontiers = {n: svc.frontier(sid) for n, sid in
                     svc._dags[did].stage_sids.items()}
        want = dag.compose_frontiers(frontiers, use_kernel=False, device=CPU)
        np.testing.assert_allclose(np.sort(got.F, axis=0),
                                   np.sort(want.F, axis=0),
                                   rtol=1e-5, atol=1e-5)
        assert bool(P.pareto_mask(got.F).all())
