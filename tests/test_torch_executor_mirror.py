"""Mirrors of the reference's executor-plane tests on the port (host).

The cases of ``tests/test_executor.py::{TestProgramSplits, TestBucketing,
TestStructureSharing, TestPromotionParamsSwap}`` and
``tests/test_mogd_descend.py::{TestPlanFromStructure,
TestExecutorBackendSeam}`` that ``tests/test_torch_executor.py``,
``tests/test_torch_models.py`` and ``tests/test_torch_kernels.py`` do not
already hold, with the reference's assertions, on ``device="cpu"`` (the
fused backend takes the descend kernel's plain version here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (
    MOGDConfig,
    Objective,
    ProgressiveFrontier,
    continuous,
)
from repro_torch.core.mogd import (
    MOGDSolver,
    estimate_objective_bounds,
    solve_grouped,
)
from repro_torch.core.synthetic import (
    make_sphere2,
    make_zdt1,
    mlp_surrogate_task,
)
from repro_torch.core.task import TaskSpec, as_problem
from repro_torch.exec import ProbeExecutor, bucket
from repro_torch.kernels.mogd_descend import plan_from_structure
from repro_torch.models.gp import fit_gp

CPU = "cpu"
FAST = MOGDConfig(steps=40, multistart=4)
CFG = MOGDConfig(steps=25, multistart=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zdt1():
    return make_zdt1(device=CPU)


@pytest.fixture(scope="module")
def sphere2():
    return make_sphere2(device=CPU)


def mlp_workload(i: int, d: int = 3, arch=(8, 8), k: int = 2, bound=None,
                 name: str | None = None) -> TaskSpec:
    return mlp_surrogate_task(seed=i, d=d, arch=tuple(arch), k=k,
                              bound=bound, name=name, device=CPU)


def boxes_for(problem, n: int, seed: int = 0) -> np.ndarray:
    """n random (lo, hi) probe boxes inside the sampled objective range."""
    b = estimate_objective_bounds(problem, n=512, seed=seed)
    rng = np.random.default_rng(seed)
    lo = b[0] + rng.random((n, problem.k)) * 0.3 * (b[1] - b[0])
    hi = lo + (0.2 + 0.5 * rng.random((n, problem.k))) * (b[1] - b[0])
    return np.stack([lo, hi], axis=1)


def _solver(problem, cfg=FAST, **ex):
    return MOGDSolver(problem, cfg, device=CPU,
                      executor=ProbeExecutor(device=CPU, **ex))


# ---------------------------------------------------------------------------
# Program splits (tests/test_executor.py::TestProgramSplits)
# ---------------------------------------------------------------------------


class TestProgramSplits:
    def test_mlp_structure_key_is_weight_free(self):
        a = mlp_workload(0).program
        b = mlp_workload(1).program
        c = mlp_workload(2, arch=(16, 8)).program
        assert a.structure == b.structure  # same arch, different weights
        assert a.structure != c.structure  # different arch

    def test_explicit_model_beside_program_changes_signature(self):
        """An explicit model diverging from the program must not share the
        program-only spec's signature."""
        base = mlp_workload(0)
        divergent = TaskSpec(
            knobs=base.knobs, objectives=base.objectives,
            model=lambda x: torch.stack([5.0 * x[0], 5.0 * x[1]]),
            program=base.program, name=base.name, device=CPU)
        assert divergent.signature() != base.signature()
        # re-submitting equal content still hashes equal
        assert mlp_workload(0).signature() == base.signature()

    def test_gp_retrain_within_bucket_is_params_swap(self):
        rng = np.random.default_rng(1)
        r1 = fit_gp(rng.random((10, 3)), rng.normal(size=10), device=CPU)
        r2 = fit_gp(rng.random((14, 3)), rng.normal(size=14), device=CPU)
        assert r1.as_program().structure == r2.as_program().structure

    def test_eval_batch_routes_through_program(self):
        spec = mlp_workload(5)
        problem = spec.compile()
        assert getattr(problem, "program", None) is not None
        X = torch.rand((13, problem.dim),
                       generator=torch.Generator().manual_seed(9))
        want = torch.stack([spec.model(x) for x in X]).numpy()
        got = problem.evaluate_batch(X).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_eval_batch_empty_input(self):
        problem = mlp_workload(5).compile()
        out = problem.evaluate_batch(np.empty((0, problem.dim)))
        assert tuple(out.shape) == (0, problem.k)


# ---------------------------------------------------------------------------
# Bucketing (tests/test_executor.py::TestBucketing)
# ---------------------------------------------------------------------------


class TestBucketing:
    def test_bucket_base(self):
        assert bucket(3, base=4) == 4

    def test_padded_refine_matches_unpadded_reference(self, zdt1):
        ref = _solver(zdt1, bucket_fn=lambda b: b)
        pad = _solver(zdt1)
        x0s = np.random.default_rng(7).random((5, zdt1.dim)).astype(
            np.float32)
        box = boxes_for(zdt1, 1)[0]
        xr, fr, sr = ref.refine(x0s, box)
        xp, fp, sp = pad.refine(x0s, box)
        np.testing.assert_array_equal(sp, sr)
        np.testing.assert_allclose(xp, xr, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fp, fr, rtol=1e-5, atol=1e-6)

    def test_pad_rows_never_leak_into_frontier(self):
        """An off-bucket PF probe batch must only ever absorb solutions of
        real cells: every frontier row re-evaluates to its stored F."""
        problem = as_problem(mlp_workload(3))
        pf = ProgressiveFrontier(problem, mode="AP", mogd=FAST, grid_l=2,
                                 batch_rects=3, device=CPU)
        res = pf.run(n_probes=20)
        F_re = problem.evaluate_batch(torch.as_tensor(
            res.X, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(F_re, res.F, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Structure sharing (tests/test_executor.py::TestStructureSharing)
# ---------------------------------------------------------------------------


class TestStructureSharing:
    def test_seed_is_not_part_of_the_structure(self):
        ex = ProbeExecutor(device=CPU)
        p = as_problem(mlp_workload(0))
        s0 = MOGDSolver(p, FAST, executor=ex, device=CPU)
        s1 = MOGDSolver(p, dataclasses.replace(FAST, seed=17), executor=ex,
                        device=CPU)
        assert s0.dispatch_key() == s1.dispatch_key()
        # but a change to the descent itself splits the structure
        s2 = MOGDSolver(p, dataclasses.replace(FAST, steps=50), executor=ex,
                        device=CPU)
        assert s0.dispatch_key() != s2.dispatch_key()

    def test_program_cache_is_bounded(self, zdt1, sphere2):
        ex = ProbeExecutor(max_programs=1, device=CPU)
        for problem in (zdt1, sphere2, zdt1):
            MOGDSolver(problem, FAST, executor=ex, device=CPU).solve(
                boxes_for(problem, 2))
        assert len(ex._programs) == 1
        assert ex.structures_compiled == 2  # telemetry keeps counting
        assert ex.total_compiles == 3  # zdt1 evicted, rebuilt on reuse

    def test_second_workload_adds_no_structure(self):
        ex = ProbeExecutor(device=CPU)
        p0, p1 = as_problem(mlp_workload(0)), as_problem(mlp_workload(1))
        s0 = MOGDSolver(p0, FAST, executor=ex, device=CPU)
        s1 = MOGDSolver(p1, FAST, executor=ex, device=CPU)
        s0.solve(boxes_for(p0, 4))
        n_structs, n_builds = ex.structures_compiled, ex.total_compiles
        assert n_structs == 1
        s1.solve(boxes_for(p1, 4, seed=1))  # params swap, warm program
        assert ex.structures_compiled == n_structs
        assert ex.total_compiles == n_builds


# ---------------------------------------------------------------------------
# Promotion is a params swap (tests/test_executor.py::TestPromotionParamsSwap)
# ---------------------------------------------------------------------------


class TestPromotionParamsSwap:
    def test_warm_resolve_reuses_compiled_executor(self):
        from repro_torch.modelserver import (
            DriftConfig,
            ModelRegistry,
            TrainerConfig,
        )
        from repro_torch.service import MOOService

        rng = np.random.default_rng(0)
        knobs = (continuous("a", 0.0, 1.0), continuous("b", 0.0, 1.0))
        objectives = (Objective("lat"), Objective("cost"))

        def truth(X, shift=False):
            X = np.atleast_2d(X)
            y1 = (3.0 if shift else 1.0) * (X[:, 0] - 0.3) ** 2 + X[:, 1]
            y2 = 1.5 - X[:, 0] + 0.2 * X[:, 1] ** 2
            return np.stack([y1 + 0.5, y2], axis=1)

        reg = ModelRegistry(
            trainer=TrainerConfig(hidden=(16, 16), max_epochs=25, seed=0),
            drift=DriftConfig(window=16, min_obs=8, mult=3.0, floor=0.1),
            device=CPU)
        sigs = [reg.register_workload(("exec", f"w{i}"), knobs, objectives)
                for i in range(2)]
        for i, w in enumerate(sigs):
            X = rng.random((140, 2))
            reg.observe_batch(w, X, truth(X) * (1.0 + 0.5 * i))
            assert reg.retrain(w).improved
        svc = MOOService(mogd=FAST, batch_rects=2, device=CPU)
        for w in sigs:
            svc.create_workload_session(reg, w)
        svc.run_until(min_probes=14)
        st = svc.stats()
        # two workloads, one MLP architecture -> one structure
        assert st["executor_structures"] == 1
        builds = st["executor_compiles"]
        # a promotion on w0: new weights, same architecture
        X = rng.random((160, 2))
        reg.observe_batch(sigs[0], X, truth(X, shift=True))
        rep = reg.retrain(sigs[0])
        assert rep.improved and rep.version == 2
        assert svc.stats()["stale_sessions"] == 1
        svc.run_until(min_probes=14)  # triggers the warm re-solve
        st = svc.stats()
        assert st["warm_resolves"] >= 1 and st["stale_sessions"] == 0
        # the params swap reused every built program: 0 new builds
        assert st["executor_compiles"] == builds
        assert st["executor_structures"] == 1


# ---------------------------------------------------------------------------
# tests/test_mogd_descend.py::{TestPlanFromStructure, TestExecutorBackendSeam}
# ---------------------------------------------------------------------------


class TestPlanFromStructure:
    def test_mlp_stack(self):
        problem = mlp_surrogate_task(seed=0, d=3, arch=(8, 8), k=2,
                                     device=CPU).compile()
        plan = plan_from_structure(problem.program.structure)
        assert plan is not None
        assert plan.k == 2 and plan.dim == 3
        assert plan.layer_dims[0] == (3, 8, 8, 1)
        assert plan.signs == (1.0, 1.0)

    def test_rejects_non_fusable(self):
        assert plan_from_structure(("closure", ("sig", "x"))) is None
        assert plan_from_structure(("stack", (("gp", 64, False),))) is None
        assert plan_from_structure(("family", "fp", 2)) is None
        fus = ("stack", (("mlp", (3, 8, 1), False, 0.0, 16),))
        assert plan_from_structure(fus) is not None
        assert plan_from_structure(fus, use_std=True) is None


class TestExecutorBackendSeam:
    def _boxes(self, problem, n, seed=0):
        b = estimate_objective_bounds(problem, n=128, seed=seed)
        rng = np.random.default_rng(seed)
        lo = b[0] + rng.random((n, 2)) * 0.3 * (b[1] - b[0])
        return np.stack([lo, lo + 0.5 * (b[1] - b[0])], axis=1)

    def test_auto_routes_mlp_and_matches_jnp(self):
        task = mlp_surrogate_task(seed=3, d=3, arch=(8, 8), k=2, device=CPU)
        boxes = self._boxes(task.compile(), 6)
        cfg = MOGDConfig(steps=30, multistart=4)
        rs = {}
        for backend in ("auto", "jnp", "fused"):
            ex = ProbeExecutor(backend=backend, device=CPU)
            solver = MOGDSolver(task.compile(), cfg, executor=ex, device=CPU)
            rs[backend] = (solver.solve(boxes), ex.stats())
        auto, jnp_, fused = rs["auto"], rs["jnp"], rs["fused"]
        assert auto[1]["fused_structures"] == 1
        assert auto[1]["fused_dispatches"] >= 1
        assert auto[1]["fused_fallbacks"] == 0
        assert jnp_[1]["fused_dispatches"] == 0
        for other in (jnp_, fused):
            np.testing.assert_allclose(auto[0].x, other[0].x, atol=2e-4)
            np.testing.assert_allclose(auto[0].f, other[0].f, atol=2e-3,
                                       rtol=1e-4)
            np.testing.assert_array_equal(auto[0].feasible,
                                          other[0].feasible)

    def test_grouped_tenants_share_fused_program(self):
        cfg = MOGDConfig(steps=20, multistart=2)
        ex = ProbeExecutor(backend="auto", device=CPU)
        items = []
        for seed in (5, 6):
            p = mlp_surrogate_task(seed=seed, d=3, arch=(8, 8), k=2,
                                   device=CPU).compile()
            items.append((MOGDSolver(p, cfg, executor=ex, device=CPU),
                          self._boxes(p, 3, seed), 0))
        res = solve_grouped(items)
        s = ex.stats()
        assert res.x.shape == (6, 3)
        assert s["fused_structures"] == 1
        assert s["fused_dispatches"] == 1
