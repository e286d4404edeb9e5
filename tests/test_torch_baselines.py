"""The paper's baselines (WS, NC, NSGA-II) in the port, against the JAX
reference.

Tolerances: ``weight_lattice`` and ``_fast_non_dominated_sort`` are exact on
seeded inputs; WS and NC, fed the reference's random draws (its
``PRNGKey(seed)`` starts and sample streams), give the same number of
points within 1e-4, and their hypervolumes (against one point past both
nadirs) agree within ±0.5 %, the band of ``tests/test_torch_pf.py``;
NSGA-II shares numpy's generator with the reference, so its frontiers are
compared the same way.  ``TestBaselines`` mirrors the reference's
``tests/test_progressive_frontier.py::TestBaselines`` on the port alone.

``TestWSGraph``: WS's descent step captured and replayed through the
stand-in of ``tests/_graph_stand_in.py`` (the card's route, without a
card) equals the eager loop bit for bit, on the synthetic tasks and on an
MLP-surrogate task, and equals the reference as ``TestAgainstReference``
does; a step that syncs with the host raises.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.baselines as JB
import repro_torch.core as P
import repro_torch.core.baselines as PB
from _graph_stand_in import eager as _eager, stand_in  # noqa: F401
from repro_torch.core.problem import MOOProblem
from repro_torch.kernels import graphs, platform

CPU = "cpu"
HV_BAND = 0.005  # ±0.5 % of the reference's HV
FAST = P.MOGDConfig(steps=80, multistart=6)
J_FAST = J.MOGDConfig(steps=80, multistart=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_draws(monkeypatch):
    """The port draws the reference's numbers: each MOGD solver replays the
    reference solver's key stream, and problem sampling the reference's
    ``PRNGKey(seed)`` uniforms (``tests/test_torch_pf.py``'s helper)."""

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


def _problems(name):
    """(reference problem, port problem) of one synthetic task, each built
    fresh so neither carries a solver stream from another test."""
    if name == "zdt1":
        return J.make_zdt1(), P.make_zdt1(device=CPU)
    if name == "sphere2":
        return J.make_sphere2(), P.make_sphere2(device=CPU)
    return J.make_dtlz2(k=3), P.make_dtlz2(k=3, device=CPU)


def _hv_pair(Fa, Fb):
    both = np.concatenate([Fa, Fb])
    nadir, utopia = both.max(0), both.min(0)
    point = nadir + 0.1 * np.maximum(nadir - utopia, 1e-9)
    return J.hypervolume(Fa, point), P.hypervolume(Fb, point)


def _same_frontier(want, got, atol=1e-4):
    """Equal point counts, rows within ``atol`` (after sorting both), and
    HV within the band."""
    assert got.F.shape == want.F.shape, (got.F.shape, want.F.shape)
    assert got.X.shape == want.X.shape
    order_w = np.lexsort(want.F.T[::-1])
    order_g = np.lexsort(got.F.T[::-1])
    np.testing.assert_allclose(got.F[order_g], want.F[order_w], atol=atol)
    np.testing.assert_allclose(got.X[order_g], want.X[order_w], atol=atol)
    if not len(want.F):
        return
    hv_ref, hv_port = _hv_pair(want.F, got.F)
    assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)


# ---------------------------------------------------------------------------
# Exact numpy parts
# ---------------------------------------------------------------------------


class TestExactParts:
    @pytest.mark.parametrize("k,n", [(2, 1), (2, 5), (2, 10), (3, 10),
                                     (3, 7), (4, 12), (5, 30)])
    def test_weight_lattice_equals_reference(self, k, n):
        np.testing.assert_array_equal(PB.weight_lattice(k, n),
                                      JB.weight_lattice(k, n))

    @pytest.mark.parametrize("n,k,seed", [(1, 2, 0), (17, 2, 1), (40, 3, 2),
                                          (64, 2, 3), (25, 4, 4)])
    def test_non_dominated_sort_equals_reference(self, n, k, seed):
        rng = np.random.default_rng(seed)
        F = rng.uniform(0, 1, (n, k)).astype(np.float32)
        F[: n // 4] = np.round(F[: n // 4], 1)  # ties and duplicates
        np.testing.assert_array_equal(PB._fast_non_dominated_sort(F),
                                      JB._fast_non_dominated_sort(F))

    def test_value_constraints_filter_before_the_mask(self):
        """An infeasible point that dominates the constrained optimum does
        not knock it out (``TestEnforcedBounds`` of the reference)."""
        problem = MOOProblem(
            specs=[P.continuous("a", 0, 1)],
            objectives=lambda x: torch.stack([x[0], x[0]]), k=2,
            value_constraints=np.array([[0.5, np.inf], [-np.inf, np.inf]]),
            device=CPU)
        F = np.array([[0.0, 0.0], [0.6, 0.6]])
        Ff, Xf = PB._apply_value_constraints(problem, F, np.zeros((2, 1)))
        np.testing.assert_allclose(Ff, [[0.6, 0.6]])
        assert np.asarray(P.pareto_mask(Ff)).sum() == 1


# ---------------------------------------------------------------------------
# Against the reference, on the reference's draws
# ---------------------------------------------------------------------------


class TestAgainstReference:
    @pytest.mark.parametrize("name", ["sphere2", "zdt1", "dtlz2"])
    def test_weighted_sum(self, monkeypatch, name):
        _reference_draws(monkeypatch)
        jp, pp = _problems(name)
        want = J.weighted_sum(jp, n_probes=8, mogd=J_FAST)
        got = P.weighted_sum(pp, n_probes=8, mogd=FAST, device=CPU)
        assert got.probes == want.probes
        _same_frontier(want, got)

    @pytest.mark.parametrize("name", ["sphere2", "zdt1", "dtlz2"])
    def test_normalized_constraints(self, monkeypatch, name):
        _reference_draws(monkeypatch)
        jp, pp = _problems(name)
        want = J.normalized_constraints(jp, n_probes=8, mogd=J_FAST)
        got = P.normalized_constraints(pp, n_probes=8, mogd=FAST,
                                       device=CPU)
        assert got.probes == want.probes
        _same_frontier(want, got)

    def test_normalized_constraints_given_bounds(self, monkeypatch):
        """With bounds given there is no anchor pass: the grid alone."""
        _reference_draws(monkeypatch)
        jp, pp = _problems("zdt1")
        bounds = np.array([[0.0, 0.0], [1.0, 1.2]])
        want = J.normalized_constraints(jp, n_probes=6, mogd=J_FAST,
                                        bounds=bounds)
        got = P.normalized_constraints(pp, n_probes=6, mogd=FAST,
                                       bounds=bounds, device=CPU)
        _same_frontier(want, got)

    @pytest.mark.parametrize("name,pop,gens,seed", [
        ("zdt1", 24, 6, 0), ("zdt1", 40, 8, 3), ("sphere2", 24, 10, 1),
        ("dtlz2", 20, 5, 2)])
    def test_nsga2(self, name, pop, gens, seed):
        """numpy's generator in both packages: the same individuals while
        the fp32 evaluations agree (they do on these problems)."""
        jp, pp = _problems(name)
        want = J.nsga2(jp, n_probes=100, pop_size=pop, n_gens=gens,
                       seed=seed)
        got = P.nsga2(pp, n_probes=100, pop_size=pop, n_gens=gens,
                      seed=seed, device=CPU)
        assert got.probes == want.probes
        assert [r[2] for r in got.trace] == [r[2] for r in want.trace]
        _same_frontier(want, got)

    def test_nsga2_stops_at_requested_front(self):
        jp, pp = _problems("sphere2")
        want = J.nsga2(jp, n_probes=10, pop_size=20, seed=5)
        got = P.nsga2(pp, n_probes=10, pop_size=20, seed=5, device=CPU)
        assert len(got.trace) == len(want.trace)
        _same_frontier(want, got)

    def test_bounded_task_honors_cap_in_every_method(self, monkeypatch):
        """A declared cap on f2: no method returns a point above it, and the
        port's frontiers are the reference's."""
        _reference_draws(monkeypatch)
        cap = 0.6
        jt, pt = J.zdt1_task(f2_cap=cap), P.zdt1_task(f2_cap=cap, device=CPU)
        jp, pp = J.as_problem(jt), P.as_problem(pt)
        sizes = []
        for jf, pf, kw in ((J.weighted_sum, P.weighted_sum,
                            dict(n_probes=8)),
                           (J.normalized_constraints,
                            P.normalized_constraints, dict(n_probes=8)),
                           (J.nsga2, P.nsga2, dict(n_probes=50, pop_size=24,
                                                   n_gens=6))):
            extra = {"mogd": J_FAST} if jf is not J.nsga2 else {}
            pextra = {"mogd": FAST} if pf is not P.nsga2 else {}
            want = jf(jp, **kw, **extra)
            got = pf(pp, **kw, **pextra, device=CPU)
            assert np.all(got.F[:, 1] <= cap + 1e-6)
            _same_frontier(want, got)
            sizes.append(len(got.F))
        # the gradient methods reach under the cap; six generations of
        # NSGA-II do not on ZDT1 (an empty frontier in both packages)
        assert sizes[0] >= 1 and sizes[1] >= 1, sizes


class TestDevice:
    def test_entry_points_check_the_device(self):
        pp = P.make_zdt1(device=CPU)
        for fn in (P.weighted_sum, P.normalized_constraints, P.nsga2):
            with pytest.raises(ValueError, match="lives on"):
                fn(pp, device="meta")

    @pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
    def test_default_device_is_cuda(self):
        with pytest.raises(RuntimeError):
            P.weighted_sum(P.make_zdt1(device=CPU))

    def test_mlp_task_runs_no_kernel_on_the_host(self):
        """On host tensors NC's solves take the plain descent: no launch."""
        from repro_torch.core.synthetic import mlp_surrogate_task

        platform.reset_launches()
        r = P.normalized_constraints(
            mlp_surrogate_task(seed=0, d=3, arch=(16, 16), device=CPU),
            n_probes=4, mogd=P.MOGDConfig(steps=20, multistart=4),
            device=CPU)
        assert len(r.F) >= 1 and np.all(np.isfinite(r.F))
        assert platform.launch_counts() == {}


# ---------------------------------------------------------------------------
# WS's descent as a CUDA graph (the stand-in's route)
# ---------------------------------------------------------------------------


def _ws_problem(name):
    if name == "mlp":
        from repro_torch.core.synthetic import mlp_surrogate_task

        return mlp_surrogate_task(seed=0, d=3, arch=(16, 16), device=CPU)
    return _problems(name)[1]


class TestWSGraph:
    @pytest.mark.parametrize("name", ["zdt1", "dtlz2", "mlp"])
    def test_replays_equal_the_eager_loop(self, stand_in, name):
        problem = _ws_problem(name)
        platform.reset_launches()
        got = P.weighted_sum(problem, n_probes=8, mogd=FAST, device=CPU)
        routes = platform.route_counts()
        assert routes["ws:eager"] == 1
        assert routes["ws:graph"] == FAST.steps
        assert graphs.CAPTURE_S["ws"] > 0
        replays = [g().replays for g in stand_in.graphs
                   if g() is not None and g().replays == FAST.steps]
        assert replays  # one graph, replayed once a step
        want = _eager(stand_in, lambda: P.weighted_sum(
            problem, n_probes=8, mogd=FAST, device=CPU))
        np.testing.assert_array_equal(got.F, want.F)
        np.testing.assert_array_equal(got.X, want.X)
        assert got.probes == want.probes

    @pytest.mark.parametrize("name", ["sphere2", "zdt1"])
    def test_replays_equal_the_reference(self, stand_in, monkeypatch, name):
        _reference_draws(monkeypatch)
        jp, pp = _problems(name)
        want = J.weighted_sum(jp, n_probes=8, mogd=J_FAST)
        platform.reset_launches()
        got = P.weighted_sum(pp, n_probes=8, mogd=FAST, device=CPU)
        assert platform.route_counts().get("ws:graph") == FAST.steps
        assert got.probes == want.probes
        _same_frontier(want, got)

    def test_a_step_that_syncs_with_the_host_raises(self, stand_in):
        def objectives(x):
            return torch.stack([x[0], x[1] * torch.tensor(2.0)])

        problem = MOOProblem(
            specs=[P.continuous("a", 0, 1), P.continuous("b", 0, 1)],
            objectives=objectives, k=2, device=CPU)
        with pytest.raises(RuntimeError, match="WS's descent step"):
            P.weighted_sum(problem, n_probes=4, mogd=FAST, device=CPU,
                           bounds=np.array([[0.0, 0.0], [1.0, 2.0]]))


# ---------------------------------------------------------------------------
# Mirror of tests/test_progressive_frontier.py::TestBaselines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zdt1():
    return P.make_zdt1(device=CPU)


@pytest.fixture(scope="module")
def sphere2():
    return P.make_sphere2(device=CPU)


class TestBaselines:
    def test_weight_lattice(self):
        w = P.weight_lattice(2, 5)
        assert w.shape == (5, 2)
        assert np.allclose(w.sum(1), 1.0)
        w3 = P.weight_lattice(3, 10)
        assert np.allclose(w3.sum(1), 1.0) and len(w3) >= 10

    def test_ws_on_convex_front(self, sphere2):
        r = P.weighted_sum(sphere2, n_probes=8, mogd=FAST, device=CPU)
        assert len(r.F) >= 3
        assert np.asarray(P.pareto_mask(r.F)).all()

    def test_nc_coverage(self, zdt1):
        r = P.normalized_constraints(zdt1, n_probes=8, mogd=FAST, device=CPU)
        assert len(r.F) >= 3

    def test_nsga2_improves_with_budget(self, zdt1):
        ref = np.array([1.5, 12.0])
        r_small = P.nsga2(zdt1, n_probes=100, pop_size=24, n_gens=5, seed=0,
                          device=CPU)
        r_big = P.nsga2(zdt1, n_probes=100, pop_size=24, n_gens=40, seed=0,
                        device=CPU)
        hv_s = P.hypervolume_2d(r_small.F, ref)
        hv_b = P.hypervolume_2d(r_big.F, ref)
        assert hv_b >= hv_s - 1e-6

    def test_pf_beats_ws_coverage_on_zdt1(self, zdt1):
        """The paper's core coverage claim (Fig 4b-c), as an assertion."""
        pf = P.solve_pf(zdt1, mode="AP", n_probes=60,
                        mogd=P.MOGDConfig(steps=120, multistart=8),
                        device=CPU)
        ws = P.weighted_sum(zdt1, n_probes=10,
                            mogd=P.MOGDConfig(steps=120, multistart=8),
                            device=CPU)
        assert len(pf.F) >= len(ws.F)
        ref = np.array([1.5, 1.5])
        assert P.hypervolume_2d(pf.F, ref) >= \
            P.hypervolume_2d(ws.F, ref) - 0.05

    def test_results_carry_trace_and_budget(self, zdt1):
        for r in (P.weighted_sum(zdt1, n_probes=6, mogd=FAST, device=CPU),
                  P.normalized_constraints(zdt1, n_probes=6, mogd=FAST,
                                           device=CPU)):
            assert isinstance(r, P.BaselineResult)
            assert r.probes == 6 and len(r.trace) == 1
            el, unc, n = r.trace[0]
            assert el == r.elapsed and np.isnan(unc) and n == len(r.F)
