"""The port's online model server against the reference's contract
(``tests/test_modelserver.py``), on the host (``device="cpu"``).

Every test of ``tests/test_modelserver.py`` is mirrored here at its sizes
(``hidden=(24, 24)``, 30 epochs) and bands — registry, gated promotion,
drift, the service's invalidation and warm re-solve, workload mapping, DAG
stage invalidation, the warm seed of the Progressive Frontier — except
``TestIngestBridge``: the dry-run ingest bridge needs the planner and the
trace harvest, which later slices of the port bring.

One parity case carries the reference's trained snapshot models across and
feeds both registries the same observation stream: the drift events and the
staleness must be equal, and the gate's relative error within 1e-6 (both
compare in float64 after a float32 forward).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import Objective as JObjective
from repro.core import continuous as j_continuous
from repro.modelserver import DriftConfig as JDriftConfig
from repro.modelserver import ModelRegistry as JModelRegistry
from repro.modelserver import TrainerConfig as JTrainerConfig
from repro.modelserver.trainer import relative_error as j_relative_error
from repro_torch.core import MOGDConfig, Objective, TaskSpec, continuous
from repro_torch.core.dag import JobDAG, StageSpec
from repro_torch.core.synthetic import zdt1_task
from repro_torch.modelserver import (
    DriftConfig,
    DriftDetector,
    ModelRegistry,
    ModelSnapshot,
    TrainerConfig,
    workload_signature,
)
from repro_torch.modelserver.trainer import gate_split, relative_error
from repro_torch.models import models_from_numpy
from repro_torch.service import MOOService

CPU = "cpu"
FAST = MOGDConfig(steps=50, multistart=4)
KNOBS = (continuous("a", 0.0, 1.0), continuous("b", 0.0, 1.0))
OBJECTIVES = (Objective("lat"), Objective("cost"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def truth(X, shift: bool = False, scale: float = 1.0):
    """Toy 2-knob / 2-objective cost surface; ``shift`` moves it (the
    mid-stream drift regime), ``scale`` separates workload families."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    a = 3.0 if shift else 1.0
    y1 = a * (X[:, 0] - 0.3) ** 2 + X[:, 1] + 0.5
    y2 = 1.5 - X[:, 0] + 0.2 * X[:, 1] ** 2 + (1.0 if shift else 0.0)
    return np.stack([y1, y2], axis=1) * scale


def make_registry(**kw):
    kw.setdefault("trainer", TrainerConfig(hidden=(24, 24), max_epochs=30,
                                           seed=0))
    kw.setdefault("drift", DriftConfig(window=16, min_obs=8, mult=3.0,
                                       floor=0.1))
    kw.setdefault("trim_on_drift", 16)
    kw.setdefault("device", CPU)
    return ModelRegistry(**kw)


def make_service():
    return MOOService(mogd=FAST, batch_rects=2, grid_l=2, device=CPU)


def _rows(n, rng, shift=False, scale=1.0, noise=0.03):
    X = rng.random((n, 2))
    Y = truth(X, shift=shift, scale=scale)
    return X, Y * np.exp(rng.normal(0.0, noise, Y.shape))


def feed(reg, sig, n, rng, shift=False, scale=1.0, noise=0.03):
    X, Y = _rows(n, rng, shift, scale, noise)
    return reg.observe_batch(sig, X, Y)


@pytest.fixture()
def trained():
    """Registry with one promoted workload model + its service session."""
    rng = np.random.default_rng(0)
    reg = make_registry()
    w = reg.register_workload(("toy", "w1"), KNOBS, OBJECTIVES)
    feed(reg, w, 160, rng)
    rep = reg.retrain(w)
    assert rep.improved and rep.version == 1
    svc = make_service()
    sid = svc.create_workload_session(reg, w)
    svc.run_until(min_probes=14)
    return reg, w, svc, sid, rng


class TestRegistry:
    def test_registration_idempotent_and_content_addressed(self):
        reg = make_registry()
        w1 = reg.register_workload(("toy", "w1"), KNOBS, OBJECTIVES)
        w2 = reg.register_workload(
            ("toy", "w1"),
            (continuous("a", 0.0, 1.0), continuous("b", 0.0, 1.0)),
            (Objective("lat"), Objective("cost")))
        assert w1 == w2 and len(reg.workloads()) == 1
        w3 = reg.register_workload(("toy", "w2"), KNOBS, OBJECTIVES)
        assert w3 != w1
        assert w1 == workload_signature(("toy", "w1"), KNOBS, OBJECTIVES)

    def test_observe_validates_shapes(self):
        reg = make_registry()
        w = reg.register_workload(("toy", "w"), KNOBS, OBJECTIVES)
        with pytest.raises(ValueError):  # k mismatch
            reg.observe(w, {"a": 0.5, "b": 0.5}, [1.0, 2.0, 3.0])
        with pytest.raises(ValueError):  # non-finite
            reg.observe(w, np.array([0.5, 0.5]), [np.inf, 1.0])
        with pytest.raises(ValueError):  # unknown knob via encoder
            reg.observe(w, {"a": 0.5, "zz": 1.0}, [1.0, 2.0])
        reg.observe(w, {"a": 0.5, "b": 0.5}, [1.0, 2.0])
        assert reg.info(w)["traces"] == 1

    def test_task_spec_requires_model(self):
        reg = make_registry()
        w = reg.register_workload(("toy", "w"), KNOBS, OBJECTIVES)
        with pytest.raises(RuntimeError, match="no trained model"):
            reg.task_spec(w)

    def test_version_bump_only_on_validation_improvement(self):
        rng = np.random.default_rng(1)
        reg = make_registry()
        w = reg.register_workload(("toy", "w"), KNOBS, OBJECTIVES)
        feed(reg, w, 160, rng)
        weak = TrainerConfig(hidden=(24, 24), max_epochs=3, seed=0)
        rep1 = reg.retrain(w, weak)
        assert rep1.improved and rep1.version == 1
        assert [e.kind for e in rep1.events] == ["version"]
        frozen = TrainerConfig(hidden=(24, 24), max_epochs=0, seed=0)
        rep2 = reg.retrain(w, frozen)
        assert not rep2.improved and rep2.version == 1
        assert rep2.events == []
        assert rep2.outcome.candidate_error >= (
            rep2.outcome.previous_error - 1e-12)
        assert reg.snapshot(w).version == 1
        rep3 = reg.retrain(w)
        assert rep3.improved and rep3.version == 2
        assert rep3.outcome.candidate_error < rep3.outcome.previous_error
        assert reg.snapshot(w).version == 2
        assert reg.snapshot(w).n_traces == 160

    def test_task_spec_signature_tracks_version(self):
        rng = np.random.default_rng(2)
        reg = make_registry()
        w = reg.register_workload(("toy", "w"), KNOBS, OBJECTIVES)
        feed(reg, w, 120, rng)
        reg.retrain(w, TrainerConfig(hidden=(24, 24), max_epochs=2, seed=0))
        s1a = reg.task_spec(w).signature()
        s1b = reg.task_spec(w).signature()
        assert s1a == s1b
        rep = reg.retrain(w)
        assert rep.improved
        assert reg.task_spec(w).signature() != s1a

    def test_gp_backend_serves_psi_and_std(self):
        rng = np.random.default_rng(3)
        reg = make_registry(trainer=TrainerConfig(backend="gp"))
        w = reg.register_workload(("toy", "gp"), KNOBS, OBJECTIVES)
        feed(reg, w, 60, rng)
        rep = reg.retrain(w)
        assert rep.improved
        spec = reg.task_spec(w)
        prob = spec.compile()
        x = torch.tensor([0.4, 0.6])
        f = prob.objectives(x).numpy()
        assert f.shape == (2,) and np.isfinite(f).all()
        s = prob.objective_stds(x).numpy()
        assert s.shape == (2,) and (s >= 0).all()
        assert reg.snapshot(w).program().structure[0] == "stack"

    def test_uncertainty_aware_session_runs_mc_dropout_std(self):
        """alphas > 0 on an MLP snapshot: the executor's scan path runs the
        program's MC-dropout apply_std under its nested vmap and grad."""
        rng = np.random.default_rng(8)
        reg = make_registry()
        w = reg.register_workload(("toy", "std"), KNOBS, OBJECTIVES)
        feed(reg, w, 120, rng)
        assert reg.retrain(w).improved
        spec = reg.task_spec(w, alphas=(0.5, 0.5))
        svc = make_service()
        sid = svc.create_session(spec)
        svc.run_until(min_probes=6)
        F, X = svc.frontier(sid)
        assert len(F) >= 2 and np.isfinite(F).all()
        solver = svc._sessions[sid].engine.solver
        assert solver.program().apply_std is not None and solver._use_std
        prog = reg.snapshot(w).program()
        s = torch.func.vmap(lambda x: prog.apply_std(prog.params, x))(
            torch.as_tensor(X, dtype=torch.float32))
        assert s.shape == (len(X), 2) and bool((s > 0).all())

    def test_the_vault_waits_for_the_persistence_plane(self):
        with pytest.raises(TypeError):
            ModelRegistry(device=CPU, vault=None)
        for name in ("persist_workload", "rehydrate"):
            assert not hasattr(ModelRegistry, name)

    def test_default_device_is_cuda_and_raises_here(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError, match="CUDA"):
            ModelRegistry()


class TestDrift:
    def test_detector_watermark_and_reset(self):
        det = DriftDetector(DriftConfig(window=8, min_obs=4, mult=2.0,
                                        floor=0.1))
        assert det.watermark(0.02) == pytest.approx(0.1)
        assert det.watermark(0.2) == pytest.approx(0.4)
        for _ in range(3):
            assert not det.update(9.9, 0.05)
        assert det.update(9.9, 0.05)
        det.reset()
        assert det.n_obs == 0 and not det.update(9.9, 0.05)

    def test_drift_event_emitted_once_until_retrain(self, trained):
        reg, w, svc, sid, rng = trained
        seen = []
        reg.subscribe(seen.append)
        for _ in range(5):
            feed(reg, w, 8, rng, shift=True)
        kinds = [e.kind for e in seen]
        assert kinds.count("drift") == 1
        assert reg.info(w)["stale"]
        rep = reg.retrain(w)
        assert rep.improved
        assert not reg.info(w)["stale"]

    def test_drift_invalidates_session_and_warm_resolves(self, trained):
        reg, w, svc, sid, rng = trained
        F1, X1 = svc.frontier(sid)
        assert len(F1) >= 3
        old_sig = svc._sessions[sid].signature
        old_probes = svc.session_info(sid).probes
        assert svc.stats()["frontier_invalidations"] == 0
        for _ in range(5):
            feed(reg, w, 8, rng, shift=True)
        st = svc.stats()
        assert st["frontier_invalidations"] == 1
        assert st["stale_sessions"] == 1
        assert svc.session_info(sid).stale
        assert old_sig not in svc._problems
        assert all(k[0] != old_sig for k in svc._solvers)
        rec = svc.recommend(sid)
        assert rec.frontier_size == len(F1)
        rep = reg.retrain(w)
        assert rep.improved and rep.version == 2
        svc.run_until(min_probes=10)
        st = svc.stats()
        assert st["warm_resolves"] == 1
        info = svc.session_info(sid)
        assert not info.stale
        assert svc._sessions[sid].signature != old_sig
        assert info.probes < old_probes
        F2, X2 = svc.frontier(sid)
        seeded = sum(
            any(np.allclose(x, x2, atol=1e-12) for x2 in X2) for x in X1)
        assert seeded >= max(1, len(X1) // 2)

    def test_rebinding_watch_drops_old_workload_entry(self, trained):
        reg, w, svc, sid, rng = trained
        w2 = reg.register_workload(("toy", "w2"), KNOBS, OBJECTIVES)
        feed(reg, w2, 120, np.random.default_rng(9))
        assert reg.retrain(w2).improved
        svc.watch_workload(sid, reg, w2)
        assert sid not in svc._watch.get(w, set())
        assert sid in svc._watch[w2]
        assert svc.session_info(sid).stale
        svc.run_until(min_probes=8)
        assert not svc.session_info(sid).stale
        inval = svc.stats()["frontier_invalidations"]
        for _ in range(5):
            feed(reg, w, 8, rng, shift=True)
        assert not svc.session_info(sid).stale
        assert svc.stats()["frontier_invalidations"] == inval

    def test_watch_after_bump_catches_missed_event(self, trained):
        reg, w, svc, sid, rng = trained
        spec_v1 = reg.task_spec(w)
        late = svc.create_session(spec_v1)
        for _ in range(5):
            feed(reg, w, 8, rng, shift=True)
        assert reg.retrain(w).improved
        inval0 = svc.stats()["frontier_invalidations"]
        svc.watch_workload(late, reg, w)
        assert svc.session_info(late).stale
        assert svc.stats()["frontier_invalidations"] == inval0 + 1

    def test_rebuild_preserves_session_objective_bounds(self, trained):
        reg, w, svc, sid, rng = trained
        svc.close_session(sid)
        capped = dataclasses.replace(
            reg.task_spec(w),
            objectives=(Objective("lat"),
                        Objective("cost", bound=(None, 2.0))))
        cid = svc.create_session(capped)
        svc.watch_workload(cid, reg, w)
        svc.run_until(min_probes=10)
        for _ in range(5):
            feed(reg, w, 8, rng, shift=True)
        assert reg.retrain(w).improved
        svc.run_until(min_probes=8)
        assert not svc.session_info(cid).stale
        rebuilt = svc._sessions[cid].spec
        assert rebuilt.objectives[1].bound == (None, 2.0)
        vc = svc._sessions[cid].problem.value_constraints
        assert vc is not None and vc[1][1] == 2.0

    def test_stale_without_new_version_keeps_serving(self, trained):
        reg, w, svc, sid, rng = trained
        for _ in range(5):
            feed(reg, w, 8, rng, shift=True)
        assert svc.session_info(sid).stale
        svc.run_until(min_probes=20)
        assert svc.session_info(sid).stale
        assert svc.stats()["warm_resolves"] == 0
        assert svc.recommend(sid).frontier_size >= 3

    def test_registry_on_another_device_is_refused(self, trained):
        reg, _w, _svc, _sid, _rng = trained

        class Elsewhere:
            device = torch.device("meta")

        svc = make_service()
        with pytest.raises(ValueError, match="serves on meta"):
            svc.attach_registry(Elsewhere())
        svc.attach_registry(reg)  # same device: accepted, idempotent
        svc.attach_registry(reg)
        assert svc._registries == [reg]


class TestWorkloadMapping:
    def test_new_workload_warm_starts_from_nearest(self):
        rng = np.random.default_rng(4)
        reg = make_registry()
        near = reg.register_workload(("toy", "near"), KNOBS, OBJECTIVES)
        far = reg.register_workload(("toy", "far"), KNOBS, OBJECTIVES)
        feed(reg, near, 150, rng, scale=1.0)
        feed(reg, far, 150, rng, scale=400.0)
        assert reg.retrain(near).improved
        assert reg.retrain(far).improved
        cold = reg.register_workload(("toy", "cold"), KNOBS, OBJECTIVES)
        feed(reg, cold, 60, rng, scale=1.1)
        assert reg.nearest_workload(cold) == near
        rep = reg.retrain(cold)
        assert rep.improved
        assert rep.outcome.warm_started_from in (near, None)

    def test_mismatched_donor_architecture_falls_back_cold(self):
        rng = np.random.default_rng(6)
        reg = make_registry()
        a = reg.register_workload(("toy", "a"), KNOBS, OBJECTIVES)
        feed(reg, a, 100, rng)
        assert reg.retrain(
            a, TrainerConfig(hidden=(12, 12), max_epochs=10, seed=0)
        ).improved
        cold = reg.register_workload(("toy", "cold"), KNOBS, OBJECTIVES)
        feed(reg, cold, 80, rng)
        assert reg.nearest_workload(cold) == a
        rep = reg.retrain(cold)
        assert rep.improved
        assert rep.outcome.warm_started_from is None
        rep2 = reg.retrain(a, TrainerConfig(hidden=(24, 24), max_epochs=20,
                                            seed=1))
        assert rep2.outcome.warm_started_from is None

    def test_small_retrain_every_waits_for_min_traces(self):
        reg = make_registry(retrain_every=1)
        w = reg.register_workload(("toy", "tiny"), KNOBS, OBJECTIVES)
        rng = np.random.default_rng(7)
        for _ in range(3):
            feed(reg, w, 1, rng)
        assert reg.info(w)["train_attempts"] == 0
        feed(reg, w, 1, rng)
        assert reg.info(w)["train_attempts"] == 1

    def test_no_donor_for_incompatible_shapes(self):
        rng = np.random.default_rng(5)
        reg = make_registry()
        a = reg.register_workload(("toy", "a"), KNOBS, OBJECTIVES)
        feed(reg, a, 80, rng)
        assert reg.retrain(a).improved
        other = reg.register_workload(
            ("toy", "b"), (continuous("z", 0.0, 1.0),), (Objective("lat"),))
        reg.observe_batch(other, rng.random((20, 1)),
                          rng.random((20, 1)) + 0.5)
        assert reg.nearest_workload(other) is None


class TestDagInvalidation:
    def test_dag_stage_children_invalidate_too(self, trained):
        reg, w, svc, sid, rng = trained
        svc.close_session(sid)
        spec = reg.task_spec(w)

        def fixed_model(x):
            return torch.stack([(x[0] - 0.3) ** 2 + x[1] + 0.5,
                                1.5 - x[0] + 0.2 * x[1] ** 2])

        fixed = TaskSpec(
            knobs=KNOBS,
            objectives=OBJECTIVES,
            model=fixed_model,
            name="fixed-stage",
            model_id=("fixed-stage", 1),
            device=CPU,
        )
        dag = JobDAG(
            stages=[StageSpec("tuned", task=spec),
                    StageSpec("fixed", task=fixed)],
            edges=[("tuned", "fixed")],
        )
        did = svc.create_dag_session(dag, registry=reg,
                                     workloads={"tuned": w})
        svc.run_until(min_probes=10)
        comp1 = svc.dag_frontier(did)
        assert len(comp1) >= 1
        inval0 = svc.stats()["frontier_invalidations"]
        for _ in range(5):
            feed(reg, w, 8, rng, shift=True)
        st = svc.stats()
        assert st["frontier_invalidations"] == inval0 + 1
        tuned_sid = svc._dags[did].stage_sids["tuned"]
        fixed_sid = svc._dags[did].stage_sids["fixed"]
        assert svc.session_info(tuned_sid).stale
        assert not svc.session_info(fixed_sid).stale
        assert reg.retrain(w).improved
        svc.run_until(min_probes=8)
        assert svc.stats()["warm_resolves"] >= 1
        assert not svc.session_info(tuned_sid).stale
        comp2 = svc.dag_frontier(did)
        assert len(comp2) >= 1

    def test_dag_workloads_validation(self, trained):
        reg, w, svc, _sid, _rng = trained
        dag = JobDAG([StageSpec("s0", task=reg.task_spec(w))])
        with pytest.raises(ValueError, match="registry"):
            svc.create_dag_session(dag, workloads={"s0": w})
        with pytest.raises(ValueError, match="unknown stages"):
            svc.create_dag_session(dag, registry=reg,
                                   workloads={"nope": w})


class TestWarmSeed:
    def test_seed_carves_queue_and_populates_store(self):
        from repro_torch.core import ProgressiveFrontier, as_problem

        pf = ProgressiveFrontier(as_problem(zdt1_task(device=CPU)),
                                 mode="AP", mogd=FAST, batch_rects=2,
                                 device=CPU)
        base = pf.initialize()
        base_vol = base.queue.total_volume
        res = pf.run(n_probes=12)
        _F, X = res.state.store.frontier()
        seeded = pf.seed(X)
        assert seeded.store.n_points >= len(X)
        assert seeded.queue.total_volume < base_vol
        out = pf.run(n_probes=8, state=seeded)
        assert len(out.F) >= len(X) // 2

    def test_seed_keeps_dominating_corner_uncertain(self):
        from repro_torch.core import ProgressiveFrontier, as_problem

        pf = ProgressiveFrontier(as_problem(zdt1_task(device=CPU)),
                                 mode="AP", mogd=FAST, device=CPU)
        x_mid = np.array([[0.3, 0.05, 0.05, 0.05, 0.05, 0.05]])
        st = pf.seed(x_mid)
        f = pf.problem.evaluate_batch(x_mid).numpy()[0]
        assert np.all(f > st.utopia) and np.all(f < st.nadir)
        covers_utopia = any(
            np.allclose(r.utopia, st.utopia) and np.all(r.nadir <= f + 1e-9)
            for r in st.queue._heap)
        assert covers_utopia
        res = pf.run(n_probes=16, state=st)
        assert np.any(np.all(res.F <= f, axis=1) & np.any(res.F < f, axis=1))

    def test_seed_empty_is_noop(self):
        from repro_torch.core import ProgressiveFrontier, as_problem

        pf = ProgressiveFrontier(as_problem(zdt1_task(device=CPU)),
                                 mode="AP", mogd=FAST, device=CPU)
        st = pf.seed(np.empty((0, 6)))
        assert st.store.n_points == 2


def test_fit_mlp_init_params_shape_mismatch():
    from repro_torch.models import MLPSpec, TrainConfig, fit_mlp, init_mlp

    X = np.random.default_rng(0).random((32, 3))
    y = X.sum(1)
    wrong = init_mlp(torch.Generator().manual_seed(0),
                     MLPSpec(in_dim=3, hidden=(8,), out_dim=1))
    with pytest.raises(ValueError, match="init_params"):
        fit_mlp(X, y, hidden=(16, 16),
                config=TrainConfig(max_epochs=1), init_params=wrong,
                device=CPU)


# ---------------------------------------------------------------------------
# Parity: the reference's snapshot models, one observation stream
# ---------------------------------------------------------------------------


def _export_models(models) -> list[dict]:
    return [{"layers": [{k: np.asarray(v) for k, v in layer.items()}
                        for layer in m.params],
             "x_mean": np.asarray(m.x_mean), "x_std": np.asarray(m.x_std),
             "y_mean": np.asarray(m.y_mean), "y_std": np.asarray(m.y_std),
             "log_target": bool(m.log_target), "dropout": float(m.dropout)}
            for m in models]


def test_drift_parity_on_carried_snapshot():
    rng = np.random.default_rng(11)
    X0, Y0 = _rows(160, rng)
    jknobs = (j_continuous("a", 0.0, 1.0), j_continuous("b", 0.0, 1.0))
    jobjs = (JObjective("lat"), JObjective("cost"))
    jreg = JModelRegistry(
        trainer=JTrainerConfig(hidden=(24, 24), max_epochs=30, seed=0),
        drift=JDriftConfig(window=16, min_obs=8, mult=3.0, floor=0.1),
        trim_on_drift=16)
    jw = jreg.register_workload(("toy", "w1"), jknobs, jobjs)
    jreg.observe_batch(jw, X0, Y0)
    assert jreg.retrain(jw).improved
    jsnap = jreg.snapshot(jw)

    preg = make_registry()
    pw = preg.register_workload(("toy", "w1"), KNOBS, OBJECTIVES)
    preg.observe_batch(pw, X0, Y0)
    models = models_from_numpy(_export_models(jsnap.models), device=CPU)
    snap = ModelSnapshot(version=1, models=models,
                         val_error=jsnap.val_error, n_traces=jsnap.n_traces,
                         backend="mlp", warm_started_from=None)
    rec = preg._records[pw]
    rec.snapshots.append(snap)
    rec.active = snap

    # the gate's error on the same split, both packages
    _tr, va = gate_split(len(X0), 0.2, 0)
    assert relative_error(models, X0[va], Y0[va]) == pytest.approx(
        j_relative_error(jsnap.models, X0[va], Y0[va]), abs=1e-6)

    jseen, pseen = [], []
    jreg.subscribe(jseen.append)
    preg.subscribe(pseen.append)
    for i in range(6):
        X, Y = _rows(8, rng, shift=i >= 2)
        jev, pev = jreg.observe_batch(jw, X, Y), preg.observe_batch(pw, X, Y)
        assert [(e.kind, e.version) for e in pev] == [
            (e.kind, e.version) for e in jev]
        assert preg.info(pw)["stale"] == jreg.info(jw)["stale"]
        assert preg.info(pw)["rolling_error"] == pytest.approx(
            jreg.info(jw)["rolling_error"], abs=1e-6)
    assert [e.kind for e in pseen] == [e.kind for e in jseen] == ["drift"]
    assert preg.info(pw)["traces"] == jreg.info(jw)["traces"]
