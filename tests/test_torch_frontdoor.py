"""Mirrors on the port of the reference's front-door and Pareto tests that
had no port counterpart: ``tests/test_task.py`` (``TestObjective``,
``TestPreference``, ``TestCompile``, ``TestEnforcedBounds``,
``TestServiceFrontDoor``), ``tests/test_pareto.py`` (``TestDomination``,
``TestHypervolume``, ``TestCrowding``), all of ``tests/test_recommend.py``
and ``tests/test_encoder.py``, the encoder and recommendation classes of
``tests/test_properties.py`` and ``tests/test_models.py::TestWorkloads``.

Each test keeps the reference's inputs and bars; models are torch
callables and problems live on the host (``device="cpu"``).  The
hypothesis properties run on seeded draws of the same strategies
(parametrized seeds, so every case counts), and where a property's input
is a JAX ``PRNGKey`` draw the port gets the same numbers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import (
    MOGDConfig,
    MOOProblem,
    Objective,
    TaskSpec,
    UtopiaNearest,
    WeightedUtopiaNearest,
    WorkloadAware,
    as_problem,
    boolean,
    categorical,
    continuous,
    crowding_distance,
    dominates,
    hypervolume,
    hypervolume_2d,
    integer,
    pareto_mask,
    preference_from_legacy,
    solve_pf,
    zdt1_task,
)
from repro_torch.core.mogd import MOGDSolver
from repro_torch.core.problem import SpaceEncoder
from repro_torch.core.recommend import (
    WorkloadClassWeights,
    classify_workload,
    select,
    utopia_nearest,
    weighted_utopia_nearest,
    workload_aware_wun,
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


def _uniform(seed: int, dim: int) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), (dim,))``'s numbers."""
    import jax

    return torch.as_tensor(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (dim,))))


# ---------------------------------------------------------------------------
# tests/test_task.py
# ---------------------------------------------------------------------------


def _toy_spec(scale=1.0, cap=None, preference=UtopiaNearest(), model_id=None):
    """A tiny 2-objective spec built with *fresh closures* on every call."""
    specs = [continuous("a", 0.0, 1.0), integer("n", 1, 4)]

    def model(x):
        return torch.stack([scale * x[0] + x[1], 1.0 - x[0]])

    return TaskSpec(
        knobs=specs,
        objectives=(Objective("lat"),
                    Objective("cost",
                              bound=None if cap is None else (None, cap))),
        model=model,
        preference=preference,
        model_id=model_id,
        device=CPU,
    )


class TestObjective:
    def test_direction_validated(self):
        with pytest.raises(ValueError, match="direction"):
            Objective("f", direction="minimise")

    def test_bound_ordering_validated(self):
        with pytest.raises(ValueError, match="exceed"):
            Objective("f", bound=(2.0, 1.0))

    def test_negative_alpha_rejected(self):
        with pytest.raises(ValueError, match="alpha"):
            Objective("f", alpha=-0.5)

    def test_minimized_bound_flips_for_max(self):
        o = Objective("thr", direction="max", bound=(10.0, 100.0))
        assert o.minimized_bound() == (-100.0, -10.0)
        open_lo = Objective("f", bound=(None, 5.0)).minimized_bound()
        assert open_lo == (-np.inf, 5.0)


class TestPreference:
    def test_wun_rejects_bad_weights(self):
        with pytest.raises(ValueError):
            WeightedUtopiaNearest((-0.1, 1.0))
        with pytest.raises(ValueError):
            WeightedUtopiaNearest((0.0, 0.0))

    def test_legacy_shim(self):
        assert isinstance(preference_from_legacy("un"), UtopiaNearest)
        p = preference_from_legacy("wun", weights=(0.2, 0.8))
        assert isinstance(p, WeightedUtopiaNearest)
        p = preference_from_legacy("workload", weights=(1, 1),
                                   default_latency_s=10.0)
        assert isinstance(p, WorkloadAware)
        with pytest.raises(ValueError):
            preference_from_legacy("nope")
        with pytest.raises(ValueError):
            preference_from_legacy("wun")  # missing weights

    def test_pick_matches_selector_semantics(self):
        F = np.array([[0.0, 1.0], [0.5, 0.5], [1.0, 0.0]])
        u, n = np.zeros(2), np.ones(2)
        assert UtopiaNearest().pick(F, u, n) == 1
        assert WeightedUtopiaNearest((1.0, 0.0)).pick(F, u, n) == 0

    def test_weight_arity_checked_against_objectives(self):
        with pytest.raises(ValueError, match="weights"):
            _toy_spec(preference=WeightedUtopiaNearest((1.0, 1.0, 1.0)))


class TestCompile:
    def test_compile_is_single_construction_path(self):
        spec = _toy_spec(cap=1.5)
        p = spec.compile()
        assert p.k == 2 and p.names == ("lat", "cost")
        assert p.task_spec is spec
        assert p.signature == spec.signature()
        np.testing.assert_allclose(p.value_constraints[1], [-np.inf, 1.5])

    def test_max_direction_negated(self):
        spec = TaskSpec(
            knobs=[continuous("a", 0.0, 1.0)],
            objectives=(Objective("lat"), Objective("thr", direction="max")),
            model=lambda x: torch.stack([x[0], x[0] * 2.0]),
            device=CPU,
        )
        f = spec.compile().objectives(torch.tensor([0.5]))
        np.testing.assert_allclose(f.numpy(), [0.5, -1.0])

    def test_alpha_folds_std_into_effective_objectives(self):
        spec = TaskSpec(
            knobs=[continuous("a", 0.0, 1.0)],
            objectives=(Objective("f1", alpha=2.0), Objective("f2")),
            model=lambda x: torch.stack([x[0], x[0]]),
            model_stds=lambda x: torch.stack([x[0] * 0.0 + 1.0,
                                              x[0] * 0.0 + 1.0]),
            device=CPU,
        )
        p = spec.compile()
        f = p.effective_objectives()(torch.tensor([0.5]))
        # f1 gets +2.0 * std, f2's alpha is 0 -> untouched
        np.testing.assert_allclose(f.numpy(), [2.5, 0.5])

    def test_as_problem_caches_by_signature(self):
        p1 = as_problem(_toy_spec())
        p2 = as_problem(_toy_spec())
        assert p1 is p2
        assert as_problem(p1) is p1

    def test_validation(self):
        with pytest.raises(ValueError, match="knob"):
            TaskSpec(knobs=[], objectives=("f",), model=lambda x: x)
        with pytest.raises(ValueError, match="Objective"):
            TaskSpec(knobs=[continuous("a", 0, 1)], objectives=(),
                     model=lambda x: x)
        with pytest.raises(ValueError, match="duplicate"):
            TaskSpec(knobs=[continuous("a", 0, 1)], objectives=("f", "f"),
                     model=lambda x: x)
        with pytest.raises(ValueError, match="Preference"):
            TaskSpec(knobs=[continuous("a", 0, 1)], objectives=("f",),
                     model=lambda x: x, preference="un")


class TestEnforcedBounds:
    """Acceptance: a declared budget cap provably changes what comes back."""

    def test_mogd_reports_bound_violations_infeasible(self):
        # cost = 1 - x0 >= 0.5 requires x0 <= 0.5; cap cost at 0.3 and
        # constrain a probe box where lat forces x0 small -> infeasible
        spec = _toy_spec(cap=0.3)
        solver = MOGDSolver(spec.compile(), FAST, device=CPU)
        # probe box asking for tiny lat (x0 ~ 0, n ~ 1) -> cost ~ 1 > cap
        box = np.array([[0.0, 0.0], [1.3, 1.1]])
        res = solver.solve(box[None], target=0)
        assert not bool(res.feasible[0])

    def test_bounded_frontier_excludes_infeasible_and_changes_pick(self):
        cap = 0.6
        unbounded = zdt1_task(device=CPU)
        bounded = zdt1_task(f2_cap=cap, device=CPU)
        assert unbounded.signature() != bounded.signature()
        r_u = solve_pf(unbounded, n_probes=32, mogd=FAST, device=CPU)
        r_b = solve_pf(bounded, n_probes=32, mogd=FAST, device=CPU)
        # the unbounded ZDT1 frontier spans f2 well above the cap
        assert r_u.F[:, 1].max() > cap
        # the bounded frontier contains no infeasible point at all
        assert len(r_b.F) > 0
        assert np.all(r_b.F[:, 1] <= cap + 1e-6)
        # and the recommendation changes
        i_u = unbounded.preference.pick(r_u.F, r_u.utopia, r_u.nadir)
        i_b = bounded.preference.pick(r_b.F, r_b.utopia, r_b.nadir)
        assert not np.allclose(r_u.F[i_u], r_b.F[i_b])

    def test_store_excludes_and_counts_infeasible(self):
        from repro_torch.core import FrontierStore

        store = FrontierStore(k=2, dim=3,
                              bounds=np.array([[-np.inf, np.inf],
                                               [-np.inf, 0.5]]),
                              device=CPU)
        n = store.add(np.array([[0.1, 0.9], [0.2, 0.4]]), np.zeros((2, 3)))
        assert n == 1
        assert store.total_infeasible == 1
        F, _ = store.frontier()
        assert np.all(F[:, 1] <= 0.5)

    def test_baselines_filter_infeasible_before_pareto_mask(self):
        """An infeasible point that dominates the constrained optimum must
        not knock it out: feasibility filters before the Pareto mask."""
        from repro_torch.core.baselines import _apply_value_constraints

        problem = MOOProblem(
            specs=[continuous("a", 0, 1)],
            objectives=lambda x: torch.stack([x[0], x[0]]),
            k=2,
            value_constraints=np.array([[0.5, np.inf], [-np.inf, np.inf]]),
            device=CPU)
        # (0,0) is infeasible (f1 < 0.5) and dominates the feasible (.6,.6)
        F = np.array([[0.0, 0.0], [0.6, 0.6]])
        X = np.zeros((2, 1))
        Ff, Xf = _apply_value_constraints(problem, F, X)
        np.testing.assert_allclose(Ff, [[0.6, 0.6]])
        assert np.asarray(pareto_mask(Ff)).sum() == 1  # survivor kept


class TestServiceFrontDoor:
    """Acceptance: structurally-equal specs share one compiled solver."""

    def test_equal_specs_hit_one_solver_without_id_identity(self):
        svc = MOOService(mogd=FAST, batch_rects=2, device=CPU)
        s1 = svc.create_session(zdt1_task(device=CPU))
        s2 = svc.create_session(zdt1_task(device=CPU))  # equal content
        st = svc.stats()
        assert st["compiled_solvers"] == 1
        assert st["solver_cache_hits"] == 1
        assert st["compiled_problems"] == 1
        assert st["problem_cache_hits"] == 1
        # the sessions actually run and coalesce into shared batches
        svc.run_until(min_probes=8)
        assert svc.stats()["coalesced_batches"] >= 1
        for sid in (s1, s2):
            F, X = svc.frontier(sid)
            assert len(F) >= 2

    def test_different_specs_do_not_collide(self):
        svc = MOOService(mogd=FAST, batch_rects=2, device=CPU)
        svc.create_session(zdt1_task(device=CPU))
        svc.create_session(zdt1_task(f2_cap=0.7, device=CPU))
        assert svc.stats()["compiled_solvers"] == 2
        assert svc.stats()["solver_cache_hits"] == 0

    def test_recommend_uses_spec_preference_and_legacy_shim(self):
        svc = MOOService(mogd=FAST, batch_rects=2, device=CPU)
        sid = svc.create_session(
            zdt1_task(preference=WeightedUtopiaNearest((0.9, 0.1)),
                      device=CPU))
        svc.probe(sid, n_probes=16)
        rec_default = svc.recommend(sid)  # spec's latency-heavy WUN
        rec_explicit = svc.recommend(
            sid, preference=WeightedUtopiaNearest((0.1, 0.9)))
        assert rec_default.objectives[0] <= rec_explicit.objectives[0] + 1e-9
        with pytest.warns(DeprecationWarning):
            rec_legacy = svc.recommend(sid, strategy="wun",
                                       weights=(0.9, 0.1))
        assert rec_legacy.index == rec_default.index

    def test_cold_cached_tasks_evicted_open_sessions_kept(self):
        from repro_torch.core import sphere2_task

        svc = MOOService(mogd=FAST, max_cached_tasks=1, device=CPU)
        s1 = svc.create_session(zdt1_task(device=CPU))
        svc.close_session(s1)
        # over the cap -> zdt1 evicted
        s2 = svc.create_session(sphere2_task(device=CPU))
        assert svc.stats()["compiled_problems"] == 1
        svc.create_session(zdt1_task(device=CPU))
        # both signatures now have open sessions: neither is evictable
        assert svc.stats()["compiled_problems"] == 2
        assert s2 in svc._sessions

    def test_create_session_rejects_raw_problem(self):
        svc = MOOService(mogd=FAST, device=CPU)
        with pytest.raises(TypeError, match="TaskSpec"):
            svc.create_session(as_problem(zdt1_task(device=CPU)))

    def test_no_open_session_shim(self):
        # the TaskSpec front door is the only way in
        assert not hasattr(MOOService, "open_session")


# ---------------------------------------------------------------------------
# tests/test_pareto.py
# ---------------------------------------------------------------------------


def _seeded_points(seed: int, k: int = 2, nmax: int = 40) -> np.ndarray:
    """A draw like the reference's hypothesis strategy: 1..nmax points of
    float32 coordinates in [-100, 100]."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, nmax + 1))
    return rng.uniform(-100, 100, (n, k)).astype(np.float32)


class TestDomination:
    def test_simple(self):
        t = torch.tensor
        assert bool(dominates(t([1.0, 1.0]), t([2.0, 2.0])))
        assert bool(dominates(t([1.0, 2.0]), t([1.0, 3.0])))
        assert not bool(dominates(t([1.0, 3.0]), t([2.0, 2.0])))

    def test_equal_points_do_not_dominate(self):
        p = torch.tensor([1.0, 2.0])
        assert not bool(dominates(p, p))

    @pytest.mark.parametrize("seed", range(10))
    def test_antisymmetric(self, seed):
        arr = torch.as_tensor(_seeded_points(seed))
        a, b = arr[0], arr[-1]
        assert not (bool(dominates(a, b)) and bool(dominates(b, a)))


class TestHypervolume:
    def test_single_point(self):
        assert hypervolume_2d(np.array([[0.0, 0.0]]),
                              np.array([1.0, 1.0])) == 1.0

    def test_dominated_point_adds_nothing(self):
        a = hypervolume_2d(np.array([[0.0, 0.0]]), np.array([1.0, 1.0]))
        b = hypervolume_2d(
            np.array([[0.0, 0.0], [0.5, 0.5]]), np.array([1.0, 1.0])
        )
        assert a == b

    def test_monotone_in_points(self):
        ref = np.array([1.0, 1.0])
        base = np.array([[0.5, 0.1]])
        more = np.array([[0.5, 0.1], [0.1, 0.5]])
        assert hypervolume_2d(more, ref) >= hypervolume_2d(base, ref)

    def test_3d_cube(self):
        pts = np.array([[0.0, 0.0, 0.0]])
        assert abs(hypervolume(pts, np.array([1.0, 1.0, 1.0])) - 1.0) < 1e-12

    def test_3d_staircase_exact(self):
        """Two overlapping boxes: |A ∪ B| = |A| + |B| - |A ∩ B|."""
        ref = np.array([1.0, 1.0, 1.0])
        pts = np.array([[0.0, 0.5, 0.2], [0.5, 0.0, 0.6]])
        vol_a = 1.0 * 0.5 * 0.8
        vol_b = 0.5 * 1.0 * 0.4
        vol_ab = 0.5 * 0.5 * 0.4
        assert abs(hypervolume(pts, ref) - (vol_a + vol_b - vol_ab)) < 1e-12

    def test_3d_monotone_in_points(self):
        rng = np.random.default_rng(7)
        ref = np.array([1.0, 1.0, 1.0])
        pts = rng.uniform(0, 1, (12, 3))
        hv_all = hypervolume(pts, ref)
        hv_part = hypervolume(pts[:6], ref)
        assert hv_all >= hv_part - 1e-12
        # adding a dominated point changes nothing
        worst = pts.max(0)[None] * 0.999 + 0.001
        assert abs(hypervolume(np.vstack([pts, worst]), ref) - hv_all) < 1e-12

    @pytest.mark.parametrize("seed", range(10))
    def test_nonnegative(self, seed):
        arr = _seeded_points(seed).astype(np.float64)
        assert hypervolume_2d(arr, np.array([200.0, 200.0])) >= 0.0


def _crowding_reference(pts: np.ndarray) -> np.ndarray:
    """The O(n·k) loop, kept as the oracle."""
    n, k = pts.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for j in range(k):
        order = np.argsort(pts[:, j])
        fmin, fmax = pts[order[0], j], pts[order[-1], j]
        dist[order[0]] = dist[order[-1]] = np.inf
        if fmax - fmin < 1e-30:
            continue
        for idx in range(1, n - 1):
            dist[order[idx]] += (
                pts[order[idx + 1], j] - pts[order[idx - 1], j]
            ) / (fmax - fmin)
    return dist


class TestCrowding:
    def test_extremes_infinite(self):
        pts = np.array([[0.0, 3.0], [1.0, 2.0], [2.0, 1.0], [3.0, 0.0]])
        cd = crowding_distance(pts)
        assert np.isinf(cd[0]) and np.isinf(cd[-1])
        assert np.isfinite(cd[1]) and np.isfinite(cd[2])

    @pytest.mark.parametrize("n,k,seed", [(3, 2, 0), (25, 2, 1), (40, 3, 2),
                                          (17, 4, 3)])
    def test_vectorized_matches_loop(self, n, k, seed):
        pts = np.random.default_rng(seed).uniform(0, 1, (n, k))
        np.testing.assert_allclose(crowding_distance(pts),
                                   _crowding_reference(pts))

    def test_degenerate_column(self):
        """A constant objective contributes nothing except inf extremes."""
        pts = np.array([[0.0, 5.0], [1.0, 5.0], [2.0, 5.0], [3.0, 5.0]])
        got = crowding_distance(pts)
        np.testing.assert_allclose(got, _crowding_reference(pts))


# ---------------------------------------------------------------------------
# tests/test_recommend.py
# ---------------------------------------------------------------------------

F = np.array([[0.0, 1.0], [0.45, 0.45], [1.0, 0.0]])
U, N = np.zeros(2), np.ones(2)


class TestWUNWeights:
    def test_scale_invariant_normalization(self):
        """Weights are normalized: scaling all weights changes nothing."""
        a = weighted_utopia_nearest(F, U, N, (0.8, 0.2))
        b = weighted_utopia_nearest(F, U, N, (8.0, 2.0))
        assert a == b

    def test_extreme_weight_picks_extreme_point(self):
        assert weighted_utopia_nearest(F, U, N, (1.0, 0.0)) == 0
        assert weighted_utopia_nearest(F, U, N, (0.0, 1.0)) == 2

    def test_zero_weights_rejected(self):
        with pytest.raises(ValueError, match="positive sum"):
            weighted_utopia_nearest(F, U, N, (0.0, 0.0))

    def test_negative_weights_rejected(self):
        with pytest.raises(ValueError, match=">= 0"):
            weighted_utopia_nearest(F, U, N, (-1.0, 2.0))

    def test_uniform_weights_match_un(self):
        assert (weighted_utopia_nearest(F, U, N, (1.0, 1.0))
                == utopia_nearest(F, U, N))


class TestWorkloadClassWeights:
    def test_unknown_class_is_descriptive_value_error(self):
        with pytest.raises(ValueError) as ei:
            WorkloadClassWeights().for_class("extreme", k=2)
        msg = str(ei.value)
        assert "extreme" in msg
        for cls in ("low", "medium", "high"):
            assert cls in msg

    def test_known_classes_pad_to_k(self):
        w = WorkloadClassWeights().for_class("high", k=3)
        np.testing.assert_allclose(w, [0.7, 0.3, 1.0])


class TestClassifyWorkload:
    @pytest.mark.parametrize("latency,expected", [
        (0.0, "low"),
        (29.999, "low"),
        (30.0, "medium"),  # boundary is inclusive-upper
        (299.999, "medium"),
        (300.0, "high"),
        (1e6, "high"),
    ])
    def test_threshold_edges(self, latency, expected):
        assert classify_workload(latency) == expected

    def test_custom_thresholds(self):
        assert classify_workload(5.0, thresholds=(1.0, 10.0)) == "medium"


class TestWorkloadAwareWUN:
    def test_long_jobs_weight_latency(self):
        """A high-latency-class workload pulls the pick toward low latency
        relative to a low-class one with the same external weights."""
        i_long = workload_aware_wun(F, U, N, (1.0, 1.0),
                                    default_latency_s=500.0)
        i_short = workload_aware_wun(F, U, N, (1.0, 1.0),
                                     default_latency_s=5.0)
        assert F[i_long][0] <= F[i_short][0]


class TestSelectErrorPaths:
    def test_unknown_strategy(self):
        with pytest.raises(ValueError, match="unknown"):
            select(F, U, N, strategy="pareto-magic")

    def test_wun_requires_weights(self):
        with pytest.raises(ValueError, match="weights"):
            select(F, U, N, strategy="wun")

    def test_workload_requires_weights_and_latency(self):
        with pytest.raises(ValueError, match="workload"):
            select(F, U, N, strategy="workload", weights=(1, 1))
        with pytest.raises(ValueError, match="workload"):
            select(F, U, N, strategy="workload", default_latency_s=10.0)

    def test_strategy_case_insensitive(self):
        assert select(F, U, N, strategy="UN") == utopia_nearest(F, U, N)


# ---------------------------------------------------------------------------
# tests/test_encoder.py
# ---------------------------------------------------------------------------

SPECS = [
    continuous("frac", 0.2, 0.9),
    integer("cores", 1, 8),
    categorical("mode", ("slow", "fast", "turbo")),
    boolean("flag"),
]
CFG = {"frac": 0.5, "cores": 4, "mode": "fast", "flag": True}


@pytest.fixture()
def enc():
    return SpaceEncoder(SPECS)


class TestEncodeValidation:
    def test_unknown_knob_rejected(self, enc):
        bad = dict(CFG, typo_knob=1)
        with pytest.raises(ValueError, match="typo_knob"):
            enc.encode(bad)

    def test_missing_knob_rejected(self, enc):
        bad = {k: v for k, v in CFG.items() if k != "cores"}
        with pytest.raises(ValueError, match="cores"):
            enc.encode(bad)

    def test_out_of_range_numeric_rejected(self, enc):
        with pytest.raises(ValueError, match="frac"):
            enc.encode(dict(CFG, frac=0.95))
        with pytest.raises(ValueError, match="cores"):
            enc.encode(dict(CFG, cores=0))

    def test_non_numeric_rejected(self, enc):
        with pytest.raises(ValueError, match="number"):
            enc.encode(dict(CFG, frac="half"))

    def test_unknown_categorical_choice_listed(self, enc):
        with pytest.raises(ValueError) as ei:
            enc.encode(dict(CFG, mode="warp"))
        assert "turbo" in str(ei.value)  # message lists the valid choices

    def test_boundary_values_accepted(self, enc):
        enc.encode(dict(CFG, frac=0.2))
        enc.encode(dict(CFG, frac=0.9))
        enc.encode(dict(CFG, cores=8))


class TestRoundTrip:
    def test_encode_decode_identity(self, enc):
        assert enc.decode(enc.encode(CFG)) == CFG

    def test_roundtrip_every_categorical_choice(self, enc):
        for mode in ("slow", "fast", "turbo"):
            for flag in (True, False):
                cfg = dict(CFG, mode=mode, flag=flag)
                assert enc.decode(enc.encode(cfg)) == cfg

    def test_roundtrip_integer_extremes(self, enc):
        for cores in (1, 8):
            cfg = dict(CFG, cores=cores)
            assert enc.decode(enc.encode(cfg)) == cfg

    def test_decode_of_snapped_point_reencodes(self, enc):
        x = enc.snap(_uniform(3, enc.dim)).numpy()
        cfg = enc.decode(x)
        assert enc.decode(enc.encode(cfg)) == cfg


# ---------------------------------------------------------------------------
# tests/test_properties.py: encoder and recommendation properties
# ---------------------------------------------------------------------------

_SPEC_POOL = [
    continuous("c1", 0.0, 1.0),
    continuous("c2", -5.0, 5.0),
    integer("i1", 1, 9),
    integer("i2", 0, 100),
    boolean("b1"),
    categorical("k1", ("a", "b", "c")),
    categorical("k2", (1, 2, 4, 8)),
]


def _specs(seed: int):
    """1..5 distinct knobs of the pool, as the reference's strategy draws."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    return [_SPEC_POOL[i] for i in rng.permutation(len(_SPEC_POOL))[:n]]


class TestEncoderProperties:
    @pytest.mark.parametrize("seed", range(12))
    def test_decode_encode_roundtrip(self, seed):
        """decode(encode(cfg)) == cfg for any snapped point."""
        enc = SpaceEncoder(_specs(seed))
        x = enc.snap(_uniform(seed, enc.dim)).numpy()
        cfg = enc.decode(x)
        x2 = enc.encode(cfg)
        assert enc.decode(x2) == cfg

    @pytest.mark.parametrize("seed", range(12))
    def test_encode_decode_roundtrip_from_raw(self, seed):
        """encode(decode(encode(cfg))) round-trips for any *valid* raw
        configuration, and encode's validation accepts everything decode
        can produce (the two stay mutually consistent)."""
        specs = _specs(seed)
        rng = np.random.default_rng(seed)
        enc = SpaceEncoder(specs)
        cfg = {}
        for s in specs:
            if s.kind == "continuous":
                cfg[s.name] = float(rng.uniform(s.low, s.high))
            elif s.kind == "integer":
                cfg[s.name] = int(rng.integers(int(s.low), int(s.high) + 1))
            elif s.kind == "categorical":
                cfg[s.name] = s.choices[int(rng.integers(len(s.choices)))]
            else:
                cfg[s.name] = bool(rng.integers(2))
        out = enc.decode(enc.encode(cfg))
        for s in specs:
            if s.kind == "continuous":
                assert out[s.name] == pytest.approx(cfg[s.name], abs=1e-9)
            else:
                assert out[s.name] == cfg[s.name]
        # decode -> encode never trips the validation
        assert enc.decode(enc.encode(out)) == out

    @pytest.mark.parametrize("seed", range(8))
    def test_snap_idempotent(self, seed):
        enc = SpaceEncoder(_specs(seed))
        x = _uniform(seed, enc.dim)
        s1 = enc.snap(x)
        s2 = enc.snap(s1)
        np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-7)

    @pytest.mark.parametrize("seed", range(8))
    def test_decode_soft_categorical_convex(self, seed):
        specs = _specs(seed)
        enc = SpaceEncoder(specs)
        x = _uniform(0, enc.dim) + 0.01
        soft = enc.decode_soft(x)
        for s in specs:
            if s.kind == "categorical":
                w = soft[s.name].numpy()
                assert w.min() >= 0
                assert abs(w.sum() - 1.0) < 1e-5


class TestRecommendProperties:
    @pytest.mark.parametrize("n,k,seed", [(2, 2, 0), (7, 3, 1), (40, 4, 2),
                                          (13, 2, 3), (25, 3, 999)])
    def test_un_invariant_to_affine_rescale(self, n, k, seed):
        """UN pick is invariant to per-objective affine rescaling when
        utopia/nadir are rescaled consistently."""
        rng = np.random.default_rng(seed)
        F = rng.uniform(0, 1, (n, k))
        u, nd = F.min(0) - 0.1, F.max(0) + 0.1
        i1 = utopia_nearest(F, u, nd)
        scale = rng.uniform(0.5, 20.0, k)
        shift = rng.uniform(-5, 5, k)
        i2 = utopia_nearest(F * scale + shift, u * scale + shift,
                            nd * scale + shift)
        assert i1 == i2

    @pytest.mark.parametrize("n,seed", [(3, 0), (9, 1), (30, 2), (17, 500)])
    def test_wun_extreme_weight_picks_extreme_point(self, n, seed):
        """As w -> (1, 0), the WUN pick converges to the min-F1 point."""
        rng = np.random.default_rng(seed)
        F = rng.uniform(0, 1, (n, 2))
        u, nd = F.min(0), F.max(0)
        i = weighted_utopia_nearest(F, u, nd, (0.999, 0.001))
        assert F[i, 0] <= np.quantile(F[:, 0], 0.34) + 1e-9


# ---------------------------------------------------------------------------
# tests/test_models.py::TestWorkloads
# ---------------------------------------------------------------------------


class TestWorkloads:
    def test_suite_sizes(self):
        from repro_torch.data import batch_suite, streaming_suite

        assert len(batch_suite(258)) == 258
        assert len(streaming_suite(63)) == 63

    def test_latency_cost_conflict(self):
        """More cores -> lower latency, higher cost rate (tradeoff exists)."""
        from repro_torch.data import batch_problem, batch_suite, default_config

        w = batch_suite(1)[0]
        prob = batch_problem(w, device=CPU)
        small = dict(default_config(), num_executors=2, cores_per_executor=1)
        big = dict(default_config(), num_executors=32, cores_per_executor=8)
        xs = torch.as_tensor(prob.encoder.encode(small), dtype=torch.float32)
        xb = torch.as_tensor(prob.encoder.encode(big), dtype=torch.float32)
        fs, fb = prob.objectives(xs), prob.objectives(xb)
        assert fb[0] < fs[0]  # big cluster is faster

    def test_streaming_capacity_saturation(self):
        from repro_torch.data import (
            default_config,
            streaming_problem,
            streaming_suite,
        )

        w = streaming_suite(1)[0]
        prob = streaming_problem(w, k=2, device=CPU)
        big = dict(default_config(), num_executors=32, cores_per_executor=8)
        x = torch.as_tensor(prob.encoder.encode(big), dtype=torch.float32)
        f = prob.objectives(x)
        assert -f[1] <= w.rate_rec_s * (1 + 1e-6)  # throughput <= offered

    def test_traces_have_noise(self):
        from repro_torch.data import (
            batch_problem,
            batch_suite,
            generate_traces,
        )

        prob = batch_problem(batch_suite(1)[0], device=CPU)
        X, Y = generate_traces(prob, 64, noise=0.1, seed=0)
        Ytrue = prob.evaluate_batch(X).numpy()
        assert not np.allclose(Y, Ytrue)
        assert np.median(np.abs(Y - Ytrue) / Ytrue) < 0.5


class TestBoundOverlay:
    """A declared cap beyond the sampled objective box's other edge keeps
    the initial box open (the reference's overlay inverts that axis)."""

    def test_inverted_axis_moves_the_sampled_edge(self):
        from repro_torch.core.progressive_frontier import _overlay_bounds

        est = np.array([[-0.05, 0.619], [1.05, 8.88]])
        user = np.array([[-np.inf, -np.inf], [np.inf, 0.6]])
        got = _overlay_bounds(est, user)
        np.testing.assert_allclose(got[:, 0], est[:, 0])
        assert got[1, 1] == 0.6
        np.testing.assert_allclose(got[0, 1], 0.6 - 0.05 * (8.88 - 0.619))
        low_cap = np.array([[-np.inf, 9.5], [np.inf, np.inf]])
        got = _overlay_bounds(est, low_cap)
        assert got[0, 1] == 9.5 and got[1, 1] > 9.5

    def test_overlay_equals_the_references_where_no_axis_inverts(self):
        from repro_torch.core.progressive_frontier import _overlay_bounds

        est = np.array([[0.0, 0.2], [1.0, 8.0]])
        for user in (np.array([[-np.inf, -np.inf], [np.inf, 0.6]]),
                     np.array([[0.1, 0.3], [0.9, 7.0]]),
                     np.array([[-np.inf, 1.0], [0.5, np.inf]])):
            np.testing.assert_array_equal(
                _overlay_bounds(est, user),
                np.where(np.isfinite(user), user, est))

    def test_capped_zdt1_frontier_on_the_ports_own_draws(self):
        """The sample of seed 0 puts f2's estimated lower edge at 0.619,
        above the cap of 0.6: the frontier is still found."""
        prob = as_problem(zdt1_task(f2_cap=0.6, device=CPU))
        from repro_torch.core import estimate_objective_bounds

        assert estimate_objective_bounds(prob)[0, 1] > 0.6
        res = solve_pf(prob, n_probes=32, mogd=FAST, device=CPU)
        assert len(res.F) >= 2 and np.all(res.F[:, 1] <= 0.6 + 1e-6)
