"""Mirror of the reference's ``tests/test_progressive_frontier.py`` on the
port: ``TestHyperrectangle``, ``TestMOGD``, ``TestProgressiveFrontier`` and
``TestRecommendation``, each test with the reference's problem, budget and
bar, the port's problems built on the host (``device="cpu"``).  The
``TestBaselines`` mirror is in ``tests/test_torch_baselines.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # property tests skip; unit tests still run
    from _hypothesis_stub import given, settings, st

from repro_torch.core import (
    MOGDConfig,
    MOGDSolver,
    MOOProblem,
    ProgressiveFrontier,
    RectangleQueue,
    estimate_objective_bounds,
    grid_cells,
    hypervolume_2d,
    make_dtlz2,
    make_mixed_problem,
    make_rectangle,
    make_sphere2,
    make_zdt1,
    pareto_mask,
    solve_pf,
    split_rectangle,
    utopia_nearest,
    weighted_utopia_nearest,
)

CPU = "cpu"
FAST = MOGDConfig(steps=80, multistart=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
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


@pytest.fixture(scope="module")
def dtlz2_3d():
    return make_dtlz2(k=3, device=CPU)


@pytest.fixture(scope="module")
def mixed_problem():
    return make_mixed_problem(device=CPU)


class TestHyperrectangle:
    def test_split_2d_keeps_two(self):
        subs = split_rectangle(np.zeros(2), np.array([0.4, 0.6]), np.ones(2))
        assert len(subs) == 2
        vols = sorted(r.volume for r in subs)
        assert np.isclose(sum(vols), 0.4 * 0.4 + 0.6 * 0.6)

    def test_split_3d_keeps_six(self):
        subs = split_rectangle(np.zeros(3), np.full(3, 0.5), np.ones(3))
        assert len(subs) == 2**3 - 2

    @given(st.lists(st.floats(0.05, 0.95), min_size=2, max_size=4))
    @settings(max_examples=30, deadline=None)
    def test_split_volume_conservation(self, mids):
        """kept + dominated-corner + dominating-corner == total volume."""
        k = len(mids)
        u, n, m = np.zeros(k), np.ones(k), np.array(mids)
        subs = split_rectangle(u, m, n)
        kept = sum(r.volume for r in subs)
        corners = np.prod(m - u) + np.prod(n - m)
        assert np.isclose(kept + corners, 1.0, atol=1e-9)

    def test_grid_cells_partition(self):
        cells = grid_cells(np.zeros(2), np.ones(2), 3)
        assert len(cells) == 9
        assert np.isclose(sum(c.volume for c in cells), 1.0)

    def test_queue_accounting(self):
        q = RectangleQueue(make_rectangle(np.zeros(2), np.ones(2)))
        assert q.uncertain_fraction == 1.0
        r = q.pop()
        assert q.uncertain_fraction == 0.0
        for sub in split_rectangle(r.utopia, np.full(2, 0.5), r.nadir):
            q.push(sub)
        assert 0.0 < q.uncertain_fraction < 1.0
        # pop returns the largest-volume rectangle first
        vols = []
        while len(q):
            vols.append(q.pop().volume)
        assert vols == sorted(vols, reverse=True)


class TestMOGD:
    def test_single_objective_reaches_optimum(self, sphere2):
        solver = MOGDSolver(sphere2, MOGDConfig(steps=150, multistart=8),
                            device=CPU)
        bounds = estimate_objective_bounds(sphere2)
        res = solver.solve_single_objective(0, bounds)
        assert bool(res.feasible[0])
        assert res.f[0, 0] < 0.01  # min |x-a|^2 = 0

    def test_constraint_satisfaction(self, zdt1):
        solver = MOGDSolver(zdt1, MOGDConfig(steps=200, multistart=8),
                            device=CPU)
        box = np.array([[0.2, 0.2], [0.9, 0.6]])
        res = solver.solve(box[None], target=0)
        assert bool(res.feasible[0])
        f = res.f[0]
        assert np.all(f >= box[0] - 1e-2) and np.all(f <= box[1] + 1e-2)

    def test_infeasible_box_detected(self, zdt1):
        # Region strictly below the true front f2 = 1 - sqrt(f1) is empty.
        solver = MOGDSolver(zdt1, MOGDConfig(steps=150, multistart=8),
                            device=CPU)
        box = np.array([[0.0, 0.0], [0.04, 0.5]])  # front needs f2 >= 0.8
        res = solver.solve(box[None], target=0)
        assert not bool(res.feasible[0])

    def test_batch_shapes(self, sphere2):
        solver = MOGDSolver(sphere2, FAST, device=CPU)
        boxes = np.stack(
            [np.array([[0.0, 0.0], [2.0, 2.0]]) for _ in range(5)]
        )
        res = solver.solve(boxes, target=0)
        assert res.x.shape == (5, sphere2.dim)
        assert res.f.shape == (5, 2)
        assert res.feasible.shape == (5,)

    def test_mixed_space_snap(self, mixed_problem):
        solver = MOGDSolver(mixed_problem, FAST, device=CPU)
        bounds = estimate_objective_bounds(mixed_problem)
        res = solver.solve_single_objective(0, bounds)
        cfg = mixed_problem.encoder.decode(res.x[0])
        assert cfg["mode"] in ("slow", "fast", "turbo")
        assert isinstance(cfg["n"], int) and 1 <= cfg["n"] <= 8
        # latency-minimal: wants big n / turbo
        assert cfg["n"] >= 6 and cfg["mode"] == "turbo"

    def test_uncertainty_conservative(self, sphere2):
        """alpha>0 optimizes mean + alpha*std: higher (more conservative)
        reported objective than alpha=0 on the same problem."""
        std_fn = lambda x: torch.ones(2, dtype=x.dtype) * 0.3

        p2 = MOOProblem(
            specs=sphere2.specs,
            objectives=sphere2.objectives,
            k=2,
            objective_stds=std_fn,
            device=CPU,
        )
        s0 = MOGDSolver(p2, MOGDConfig(steps=100, multistart=4, alpha=0.0),
                        device=CPU)
        s1 = MOGDSolver(p2, MOGDConfig(steps=100, multistart=4, alpha=1.0),
                        device=CPU)
        b = estimate_objective_bounds(p2)
        f0 = s0.solve_single_objective(0, b).f[0, 0]
        f1 = s1.solve_single_objective(0, b).f[0, 0]
        # alpha enters the loss, not the reported mean; both should solve,
        # and the alpha-solution cannot be better than the direct optimum.
        assert f1 >= f0 - 1e-3


class TestProgressiveFrontier:
    @pytest.mark.parametrize("mode", ["AS", "AP"])
    def test_zdt1_front_recovery(self, zdt1, mode):
        res = solve_pf(zdt1, mode=mode, n_probes=40,
                       mogd=MOGDConfig(steps=120, multistart=8), device=CPU)
        assert len(res.F) >= 5
        resid = np.abs(res.F[:, 1] - (1 - np.sqrt(np.clip(res.F[:, 0], 0, 1))))
        assert resid.mean() < 0.12
        # returned set is mutually non-dominated
        assert bool(pareto_mask(res.F).all())

    def test_uncertain_space_monotone_decreasing(self, zdt1):
        res = solve_pf(zdt1, mode="AP", n_probes=30, mogd=FAST, device=CPU)
        fracs = [row[1] for row in res.trace]
        assert fracs[0] == 1.0 or fracs[0] <= 1.0
        assert all(b <= a + 1e-12 for a, b in zip(fracs, fracs[1:]))
        assert fracs[-1] < 0.6

    def test_incremental_resume_extends(self, zdt1):
        pf = ProgressiveFrontier(zdt1, mode="AP", mogd=FAST, device=CPU)
        r1 = pf.run(n_probes=8)
        n1, u1 = len(r1.F), r1.state.queue.uncertain_fraction
        r2 = pf.run(n_probes=16, state=r1.state)
        assert r2.probes > r1.probes
        assert r2.state.queue.uncertain_fraction <= u1 + 1e-12
        assert len(r2.F) >= n1  # frontier only grows (after filtering, >=)

    def test_deadline_is_per_call(self, zdt1):
        """A resumed session whose lifetime elapsed exceeds the per-call
        deadline must still make progress (the service resume path)."""
        pf = ProgressiveFrontier(zdt1, mode="AP", mogd=FAST, device=CPU)
        r1 = pf.run(n_probes=8)
        r1.state.elapsed = 1e6  # pretend the session is very old
        r2 = pf.run(n_probes=8, state=r1.state, deadline_s=30.0)
        assert r2.probes > r1.probes
        assert r2.elapsed >= 1e6  # lifetime time keeps accumulating

    def test_use_kernel_store_path(self, zdt1):
        pf = ProgressiveFrontier(zdt1, mode="AP", mogd=FAST, batch_rects=2,
                                 use_kernel=True, device=CPU)
        res = pf.run(n_probes=16)
        assert res.state.store.use_kernel
        assert len(res.F) >= 3
        assert bool(pareto_mask(res.F).all())

    def test_3d_objectives(self, dtlz2_3d):
        res = solve_pf(dtlz2_3d, mode="AP", n_probes=40, mogd=FAST, device=CPU)
        assert len(res.F) >= 4
        # DTLZ2 front: |f| = 1. allow slack for approximate solver
        norms = np.linalg.norm(res.F, axis=1)
        assert np.median(np.abs(norms - 1.0)) < 0.25

    def test_pf_s_reference_mode(self, sphere2):
        res = solve_pf(sphere2, mode="S", n_probes=4, mogd=FAST, device=CPU)
        assert len(res.F) >= 2

    def test_cross_rectangle_matches_single_rectangle(self, zdt1):
        """Cross-rectangle batched PF-AP (one MOGD dispatch for the top-B
        rectangles) reaches the same frontier quality as the seed
        one-rectangle-per-iteration path (hypervolume within tolerance)."""
        cfg = MOGDConfig(steps=120, multistart=8)
        r1 = solve_pf(zdt1, mode="AP", n_probes=40, mogd=cfg, batch_rects=1,
                      device=CPU)
        r8 = solve_pf(zdt1, mode="AP", n_probes=40, mogd=cfg, batch_rects=8,
                      device=CPU)
        ref = np.array([1.5, 1.5])
        hv1 = hypervolume_2d(r1.F, ref)
        hv8 = hypervolume_2d(r8.F, ref)
        assert abs(hv8 - hv1) <= 0.05 * max(hv1, 1e-9)
        assert bool(pareto_mask(r8.F).all())
        # batching pops several rectangles per iteration -> fewer dispatches
        assert len(r8.trace) <= len(r1.trace)

    def test_finalize_reads_incremental_store(self, zdt1):
        """finalize is a plain read of the live frontier store — no
        O(N^2) re-filter of the probe history."""
        pf = ProgressiveFrontier(zdt1, mode="AP", mogd=FAST, batch_rects=2,
                                 device=CPU)
        res = pf.run(n_probes=20)
        store = res.state.store
        F_live, X_live = store.frontier()
        np.testing.assert_array_equal(res.F, F_live)
        np.testing.assert_array_equal(res.X, X_live)
        # the store saw more candidates than survive, and the live set is
        # exactly its incrementally-maintained Pareto mask
        assert store.total_offered >= store.total_accepted >= len(F_live)
        assert bool(pareto_mask(F_live).all())

    def test_cross_rectangle_respects_queue_budget(self, zdt1):
        pf = ProgressiveFrontier(zdt1, mode="AP", mogd=FAST, batch_rects=4,
                                 device=CPU)
        state = pf.initialize()
        cells, boxes, pop = pf.prepare_parallel(state)
        # first iteration has a single rectangle -> l^k cells
        assert len(cells) == pf.grid_l ** zdt1.k
        assert boxes.shape == (len(cells), 2, zdt1.k)
        # pop metadata surfaces what was taken off the queue
        assert pop.n_rects == 1 and pop.cells_per_rect == [len(cells)]
        assert pop.popped_volume > 0.0
        res = pf._probe(boxes)
        pf.absorb(state, cells, res, pop=pop)
        assert state.probes == zdt1.k + len(cells)
        # the absorb logged the hv delta the batch bought
        assert len(state.gain_log) == 1
        probes_after, delta, vol, n_cells = state.gain_log[-1]
        assert probes_after == state.probes and n_cells == len(cells)
        assert vol == pytest.approx(pop.popped_volume)
        if len(state.queue) >= 2:
            cells2, _, _ = pf.prepare_parallel(state)
            assert len(cells2) > len(cells) or len(state.queue) == 0


class TestRecommendation:
    def test_un_is_on_frontier(self):
        F = np.array([[0.0, 1.0], [0.4, 0.4], [1.0, 0.0]])
        i = utopia_nearest(F, np.zeros(2), np.ones(2))
        assert i == 1  # balanced point nearest utopia

    def test_wun_follows_weights(self):
        F = np.array([[0.05, 1.0], [0.5, 0.5], [1.0, 0.05]])
        u, n = np.zeros(2), np.ones(2)
        i_lat = weighted_utopia_nearest(F, u, n, (0.9, 0.1))
        i_cost = weighted_utopia_nearest(F, u, n, (0.1, 0.9))
        assert F[i_lat][0] <= F[i_cost][0]
        assert F[i_cost][1] <= F[i_lat][1]
