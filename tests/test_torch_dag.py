"""Multi-stage DAG composition of the port against the JAX reference.

Both packages get the same numpy inputs from a seed:

* the pairwise compose — the port's plain version and its oracle against
  the reference's oracle (``ref.pairwise_compose``) and its Pallas kernel
  in interpret mode — exactly (``assert_array_equal``, the reference's own
  kernel test), ``+inf`` rows and empty inputs included;
* ``compose_frontiers`` on synthetic stage frontiers, series-parallel and
  not, with and without the kernels: composed F at rtol = atol = 1e-5 (the
  reference's ``test_composition_via_kernel_path`` tolerance) and the
  composed X provenance exactly;
* ``FamilySolver.solve`` from the reference's multistart draws: final x
  and f at the executor's parity tolerance, 1e-3 (as
  ``tests/test_torch_executor.py`` holds the scan path);
* ``solve_dag`` with the reference's draws fed to the port: probe,
  unique-stage and dispatch counts equal, composed hypervolume within
  ±0.5 % (the band of ``tests/test_torch_pf.py``).

The classes after those mirror ``tests/test_dag.py``'s ``TestComposition``,
``TestSolveDag`` and ``TestValidationAndSignatures`` on the port, on the
host (``device="cpu"``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels.compose import pairwise_compose_blocked as j_blocked
from repro.kernels.ref import pairwise_compose as j_compose
import repro_torch.core as P
from repro_torch.core.problem import MOOProblem
from repro_torch.core.task import as_problem
from repro_torch.kernels import ref as pref
from repro_torch.kernels.compose import (
    pairwise_compose_blocked,
    pairwise_compose_plain,
)

CPU = "cpu"
MOGD = dict(steps=30, multistart=4)
HV_BAND = 0.005  # ±0.5 % of the reference's HV
ATOL_GATE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stages(pkg, n, seed=0, fam=None):
    fam = fam or _family(pkg)
    rng = np.random.default_rng(seed)
    return [fam.stage(f"s{i}", rng.uniform(0.5, 3.0, 4)) for i in range(n)]


def _family(pkg):
    if pkg is J:
        return J.make_analytics_family()
    return P.make_analytics_family(device=CPU)


def _fake_frontiers(dag, sizes, seed=0):
    """Synthetic per-stage frontiers (objective values + encoded X)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, n in zip(dag.stage_names, sizes):
        d = dag.slices[name].stop - dag.slices[name].start
        out[name] = (rng.uniform(0.5, 4.0, (n, dag.k)),
                     rng.uniform(0.0, 1.0, (n, d)))
    return out


def _brute_force(dag, frontiers):
    sizes = [len(frontiers[n][0]) for n in dag.stage_names]
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in sizes],
                               indexing="ij")).reshape(len(sizes), -1)
    vals = {n: np.asarray(frontiers[n][0], np.float64)[idx[i]]
            for i, n in enumerate(dag.stage_names)}
    return P.pareto_filter(dag.evaluate(vals))


def _canon(F):
    F = np.unique(np.round(np.asarray(F, np.float64), 6), axis=0)
    return F[np.lexsort(F.T[::-1])]


def _by_rows(comp):
    """Composed (F, X) with rows in one canonical order (F, then X)."""
    FX = np.concatenate([comp.F, comp.X], axis=1)
    order = np.lexsort(FX.T[::-1])
    return comp.F[order], comp.X[order]


def _reference_draws(monkeypatch):
    """Make the port draw the reference's numbers: every MOGD and family
    solver replays the reference solver's key stream, and problem sampling
    the reference's ``PRNGKey(seed)`` uniforms."""

    def replay(self, B, dim):
        key = getattr(self, "_ref_key", None)
        if key is None:
            key = jax.random.PRNGKey(self.config.seed)
        self._ref_key, sub = jax.random.split(key)
        return np.array(jax.random.uniform(
            sub, (B, self.config.multistart, dim)))

    def mogd_starts(self, B):
        return replay(self, B, self.problem.dim)

    def family_starts(self, B):
        return replay(self, B, self.family.encoder.dim)

    def sample(self, generator, n):
        u = jax.random.uniform(jax.random.PRNGKey(generator.initial_seed()),
                               (n, self.dim))
        return torch.as_tensor(np.array(u), device=self.device)

    monkeypatch.setattr(P.MOGDSolver, "draw_starts", mogd_starts)
    monkeypatch.setattr(P.FamilySolver, "draw_starts", family_starts)
    monkeypatch.setattr(MOOProblem, "sample", sample)


def _dag_pair(n, edges_fn=None, seed=0):
    """(reference JobDAG, port JobDAG) over the same stages and edges."""
    jst, pst = _stages(J, n, seed), _stages(P, n, seed)
    edges = edges_fn([s.name for s in jst]) if edges_fn else ()
    return J.JobDAG(jst, edges), P.JobDAG(pst, edges)


# ---------------------------------------------------------------------------
# The compose kernel's math, against the reference
# ---------------------------------------------------------------------------


def _compose_inputs(N, M, k, inf_rows=False):
    rng = np.random.default_rng(N * M + k)
    A = rng.normal(size=(N, k)).astype(np.float32)
    B = rng.normal(size=(M, k)).astype(np.float32)
    if inf_rows and N > 2 and M > 2:
        A[rng.choice(N, size=N // 3, replace=False)] = np.inf
        B[rng.choice(M, size=M // 3, replace=False), 0] = np.inf
    mask = rng.integers(0, 2, k).astype(bool)
    mask[0] = not mask[-1] if k > 1 else mask[0]  # both operators present
    return A, B, mask


class TestComposeAgainstReference:
    @pytest.mark.parametrize("shape,inf_rows", [
        ((7, 5, 2), False), ((130, 200, 3), False), ((1, 1, 2), False),
        ((37, 41, 2), True), ((130, 9, 3), True), ((0, 6, 2), False),
        ((5, 0, 3), False)])
    def test_plain_equals_reference_oracle_and_kernel(self, shape, inf_rows):
        N, M, k = shape
        A, B, mask = _compose_inputs(N, M, k, inf_rows)
        want = np.asarray(j_compose(jnp.asarray(A), jnp.asarray(B),
                                    jnp.asarray(mask)))
        want_kernel = np.asarray(j_blocked(A, B, mask, interpret=True))
        At, Bt = torch.as_tensor(A), torch.as_tensor(B)
        got = pairwise_compose_blocked(At, Bt, mask)
        assert got.dtype == torch.float32 and got.shape == (N * M, k)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), want_kernel)
        np.testing.assert_array_equal(
            pairwise_compose_plain(At, Bt, mask).numpy(), want)
        np.testing.assert_array_equal(
            pref.pairwise_compose(At, Bt, torch.as_tensor(mask)).numpy(),
            want)

    def test_float64_inputs_compose_in_float32(self):
        """The reference casts to fp32 before composing; so does the port."""
        rng = np.random.default_rng(3)
        A, B = rng.uniform(0.5, 4.0, (9, 2)), rng.uniform(0.5, 4.0, (11, 2))
        mask = np.array([True, False])
        want = np.asarray(j_blocked(A, B, mask, interpret=True))
        got = pairwise_compose_blocked(A, B, mask)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)

    def test_nan_propagates_through_max(self):
        A = torch.tensor([[np.nan, 1.0], [2.0, 3.0]])
        B = torch.tensor([[1.0, np.nan], [0.5, 0.5]])
        got = pairwise_compose_blocked(A, B, [False, False]).numpy()
        want = np.asarray(jnp.maximum(jnp.asarray(A.numpy())[:, None],
                                      jnp.asarray(B.numpy())[None]))
        np.testing.assert_array_equal(got, want.reshape(-1, 2))
        assert np.isnan(got[0]).all() and np.isnan(got[2, 1])

    def test_bad_inputs_raise(self):
        with pytest.raises(ValueError):
            pairwise_compose_blocked(torch.ones(3, 2), torch.ones(3, 3),
                                     [True, True])
        with pytest.raises(ValueError):
            pairwise_compose_blocked(torch.ones(3, 2), torch.ones(3, 2),
                                     [True])


# ---------------------------------------------------------------------------
# compose_frontiers, against the reference
# ---------------------------------------------------------------------------


def _edges_sp(names):
    return tuple(J.random_series_parallel_edges(
        names, np.random.default_rng(1)))


def _edges_n_graph(names):
    return ((names[0], names[2]), (names[0], names[3]), (names[1], names[3]))


class TestComposeFrontiersAgainstReference:
    @pytest.mark.parametrize("case", ["sp3", "sp5", "diamond", "non_sp"])
    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_composed_frontier_equals_reference(self, case, use_kernel):
        if case == "sp3":
            jd, pd = _dag_pair(3, _edges_sp, seed=0)
            sizes = [5, 7, 6]
        elif case == "sp5":
            jd, pd = _dag_pair(5, _edges_sp, seed=1)
            sizes = [9, 4, 12, 6, 8]
        elif case == "diamond":
            jd, pd = _dag_pair(4, lambda n: ((n[0], n[1]), (n[0], n[2]),
                                             (n[1], n[3]), (n[2], n[3])),
                               seed=2)
            sizes = [6, 5, 7, 4]
        else:
            jd, pd = _dag_pair(4, _edges_n_graph, seed=4)
            sizes = [4, 5, 3, 4]
        assert jd.edges == pd.edges and jd.slices == pd.slices
        frontiers = _fake_frontiers(pd, sizes, seed=len(case))
        want = jd.compose_frontiers(frontiers, use_kernel=use_kernel,
                                    kernel_interpret=True)
        got = pd.compose_frontiers(frontiers, use_kernel=use_kernel,
                                   device=CPU)
        np.testing.assert_allclose(_canon(got.F), _canon(want.F),
                                   rtol=1e-5, atol=1e-5)
        assert len(got) == len(want)
        Fg, Xg = _by_rows(got)
        Fw, Xw = _by_rows(want)
        np.testing.assert_allclose(Fg, Fw, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(Xg, Xw)
        assert got.slices == want.slices
        assert got.objective_names == want.objective_names

    def test_chunked_composition_equals_reference(self):
        """A chunk smaller than one FB block exercises the chunk loop."""
        jd, pd = _dag_pair(2, lambda n: ((n[0], n[1]),), seed=5)
        frontiers = _fake_frontiers(pd, [30, 20], seed=5)
        want = jd.compose_frontiers(frontiers, use_kernel=True, chunk=50)
        got = pd.compose_frontiers(frontiers, use_kernel=True, chunk=50,
                                   device=CPU)
        np.testing.assert_allclose(_canon(got.F), _canon(want.F),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The family solver and solve_dag, against the reference
# ---------------------------------------------------------------------------


class TestSolversAgainstReference:
    def test_family_solver_matches_reference(self, monkeypatch):
        _reference_draws(monkeypatch)
        rng = np.random.default_rng(21)
        thetas = rng.uniform([1.0, 0.2, 0.1, 0.3], [6.0, 1.0, 1.5, 1.2],
                             (6, 4))
        lo = rng.uniform(0.5, 2.0, (6, 2))
        boxes = np.stack([lo, lo + rng.uniform(0.5, 3.0, (6, 2))], axis=1)
        jcfg, pcfg = J.MOGDConfig(**MOGD), P.MOGDConfig(**MOGD)
        jfs = J.FamilySolver(J.make_analytics_family(), jcfg)
        pfs = P.FamilySolver(_family(P), pcfg, device=CPU)
        for target in (0, 1):
            want = jfs.solve(boxes, thetas, target=target)
            got = pfs.solve(boxes, thetas, target=target)
            np.testing.assert_array_equal(got.feasible, want.feasible)
            np.testing.assert_allclose(got.x, want.x, atol=ATOL_GATE, rtol=0)
            np.testing.assert_allclose(got.f, want.f, atol=ATOL_GATE, rtol=0)
        assert pfs.dispatches == jfs.dispatches == 2

    @pytest.mark.parametrize("n_stages,seed", [(3, 3), (5, 5)])
    def test_solve_dag_matches_reference(self, monkeypatch, n_stages, seed):
        _reference_draws(monkeypatch)

        def build(pkg):
            rng = np.random.default_rng(seed)
            fam = _family(pkg)
            names = [f"s{i}" for i in range(n_stages)]
            stages = [fam.stage(n, rng.uniform([1.0, 0.2, 0.1, 0.3],
                                               [6.0, 1.0, 1.5, 1.2]))
                      for n in names]
            edges = pkg.random_series_parallel_edges(names, rng)
            return pkg.JobDAG(stages, edges, name=f"job{n_stages}")

        jd, pd = build(J), build(P)
        assert jd.edges == pd.edges
        kw = dict(n_probes_per_stage=12, batch_rects=2)
        want = J.solve_dag(jd, mogd=J.MOGDConfig(**MOGD), **kw)
        got = P.solve_dag(pd, mogd=P.MOGDConfig(**MOGD), use_kernel=True,
                          device=CPU, **kw)
        assert got.probes == want.probes
        assert got.unique_stages == want.unique_stages
        assert got.dispatches == want.dispatches
        F_all = np.concatenate([want.frontier.F, got.frontier.F])
        point = F_all.max(0) + 0.1 * (F_all.max(0) - F_all.min(0))
        hv_ref = J.hypervolume(want.frontier.F, point)
        hv_port = P.hypervolume(got.frontier.F, point)
        assert hv_ref > 0.0
        assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_dag.py on the port
# ---------------------------------------------------------------------------


class TestComposition:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sp_composition_matches_bruteforce(self, seed):
        rng = np.random.default_rng(seed)
        stages = _stages(P, 3, seed)
        edges = P.random_series_parallel_edges([s.name for s in stages], rng)
        dag = P.JobDAG(stages, edges)
        frontiers = _fake_frontiers(dag, [5, 7, 6], seed)
        comp = dag.compose_frontiers(frontiers, device=CPU)
        np.testing.assert_allclose(_canon(comp.F),
                                   _canon(_brute_force(dag, frontiers)),
                                   rtol=1e-5, atol=1e-6)

    def test_composed_x_provenance(self):
        stages = _stages(P, 3, seed=3)
        dag = P.JobDAG(stages, [("s0", "s1"), ("s0", "s2")])
        frontiers = _fake_frontiers(dag, [4, 4, 4], 3)
        frontiers = {
            n: (as_problem(dag.stage(n).task).evaluate_batch(X).numpy(), X)
            for n, (F, X) in frontiers.items()
        }
        comp = dag.compose_frontiers(frontiers, device=CPU)
        for i in range(len(comp)):
            per = {
                n: as_problem(dag.stage(n).task).evaluate_batch(
                    comp.X[i][dag.slices[n]][None]).numpy()[0]
                for n in dag.stage_names
            }
            np.testing.assert_allclose(dag.evaluate(per), comp.F[i],
                                       rtol=1e-5, atol=1e-6)

    def test_non_sp_fallback_exact(self):
        stages = _stages(P, 4, seed=4)
        dag = P.JobDAG(stages, _edges_n_graph([s.name for s in stages]))
        frontiers = _fake_frontiers(dag, [4, 5, 3, 4], 4)
        comp = dag.compose_frontiers(frontiers, device=CPU)
        np.testing.assert_allclose(_canon(comp.F),
                                   _canon(_brute_force(dag, frontiers)),
                                   rtol=1e-5, atol=1e-6)

    def test_non_sp_combo_guard(self):
        stages = _stages(P, 4, seed=4)
        dag = P.JobDAG(stages, _edges_n_graph([s.name for s in stages]))
        frontiers = _fake_frontiers(dag, [4, 5, 3, 4], 4)
        with pytest.raises(ValueError, match="max_combos"):
            dag.compose_frontiers(frontiers, max_combos=10, device=CPU)

    def test_compose_operator_semantics(self):
        stages = _stages(P, 4, seed=5)
        dag = P.JobDAG(stages, [("s0", "s1"), ("s0", "s2"), ("s1", "s3"),
                                ("s2", "s3")],
                       compose=("critical_path", "sum"))
        vals = {"s0": np.array([1.0, 10.0]), "s1": np.array([2.0, 20.0]),
                "s2": np.array([5.0, 30.0]), "s3": np.array([1.0, 40.0])}
        np.testing.assert_allclose(dag.evaluate(vals), [7.0, 100.0])
        dag_max = P.JobDAG(stages, dag.edges, compose=("max", "sum"))
        np.testing.assert_allclose(dag_max.evaluate(vals), [5.0, 100.0])
        tv = {n: torch.as_tensor(v) for n, v in vals.items()}
        np.testing.assert_allclose(dag.evaluate(tv, xp=torch).numpy(),
                                   [7.0, 100.0])

    def test_composition_via_kernel_path(self):
        stages = _stages(P, 3, seed=6)
        dag = P.JobDAG(stages, [("s0", "s2"), ("s1", "s2")])
        frontiers = _fake_frontiers(dag, [5, 6, 4], 6)
        a = dag.compose_frontiers(frontiers, use_kernel=False, device=CPU)
        b = dag.compose_frontiers(frontiers, use_kernel=True, device=CPU)
        np.testing.assert_allclose(_canon(a.F), _canon(b.F),
                                   rtol=1e-5, atol=1e-5)


class TestSolveDag:
    def test_solve_dedupe_and_consistency(self):
        fam = _family(P)
        rng = np.random.default_rng(7)
        s0 = fam.stage("s0", rng.uniform(0.5, 3.0, 4))
        s1 = fam.stage("s1", rng.uniform(0.5, 3.0, 4))
        s2 = fam.stage("s2", np.asarray(s0.theta))  # recurring sub-task
        dag = P.JobDAG([s0, s1, s2], [("s0", "s1"), ("s1", "s2")])
        res = P.solve_dag(dag, n_probes_per_stage=8,
                          mogd=P.MOGDConfig(**MOGD), batch_rects=2,
                          device=CPU)
        assert res.unique_stages == 2
        assert len(res.frontier) > 0
        assert res.dispatches <= 4
        i = int(np.argmin(res.frontier.F[:, 0]))
        per = {
            n: as_problem(dag.stage(n).task).evaluate_batch(
                res.frontier.X[i][dag.slices[n]][None]).numpy()[0]
            for n in dag.stage_names
        }
        np.testing.assert_allclose(dag.evaluate(per), res.frontier.F[i],
                                   rtol=1e-5, atol=1e-6)

    def test_family_single_dispatch_per_round(self):
        fam = _family(P)
        stages = _stages(P, 3, seed=8, fam=fam)
        dag = P.JobDAG(stages, [("s0", "s1"), ("s0", "s2")])
        res = P.solve_dag(dag, n_probes_per_stage=8,
                          mogd=P.MOGDConfig(**MOGD), batch_rects=2,
                          device=CPU)
        assert res.dispatches <= 3
        assert res.probes >= 3 * 8

    def test_mixed_family_and_plain_stages(self):
        import dataclasses as dc

        fam = _family(P)
        rng = np.random.default_rng(9)
        s0 = fam.stage("s0", rng.uniform(0.5, 3.0, 4))
        plain = dc.replace(P.sphere2_task(d=3, device=CPU),
                           objectives=("latency", "cost"))
        s1 = P.StageSpec("s1", plain)
        dag = P.JobDAG([s0, s1], [("s0", "s1")])
        res = P.solve_dag(dag, n_probes_per_stage=6,
                          mogd=P.MOGDConfig(**MOGD), batch_rects=2,
                          device=CPU)
        assert len(res.frontier) > 0
        assert res.unique_stages == 2


class TestValidationAndSignatures:
    def test_cycle_rejected(self):
        with pytest.raises(ValueError, match="cycle"):
            P.JobDAG(_stages(P, 2), [("s0", "s1"), ("s1", "s0")])

    def test_unknown_edge_rejected(self):
        with pytest.raises(ValueError, match="unknown"):
            P.JobDAG(_stages(P, 2), [("s0", "nope")])

    def test_mismatched_objectives_rejected(self):
        s0 = _family(P).stage("s0", (1.0, 0.5, 0.7, 0.9))
        s1 = P.StageSpec("s1", P.sphere2_task(d=3, device=CPU))
        with pytest.raises(ValueError, match="aligned objectives"):
            P.JobDAG([s0, s1], [("s0", "s1")])

    def test_bad_compose_op_rejected(self):
        with pytest.raises(ValueError, match="unknown compose"):
            P.JobDAG(_stages(P, 2), compose=("critical_path", "median"))

    def test_flatten_matches_evaluate(self):
        stages = _stages(P, 3, seed=12)
        dag = P.JobDAG(stages, [("s0", "s1"), ("s1", "s2")])
        flat = as_problem(dag.flatten())
        x = np.random.default_rng(12).uniform(0, 1, dag.dim)
        got = flat.evaluate_batch(x[None]).numpy()[0]
        per = {
            n: as_problem(dag.stage(n).task).evaluate_batch(
                x[dag.slices[n]][None]).numpy()[0]
            for n in dag.stage_names
        }
        np.testing.assert_allclose(got, dag.evaluate(per), rtol=1e-5,
                                   atol=1e-6)

    def test_signature_content_addressed(self):
        fam = _family(P)

        def build(theta0=1.0, edge=("s0", "s1"), compose=None):
            s0 = fam.stage("s0", (theta0, 0.5, 0.7, 0.9))
            s1 = fam.stage("s1", (2.0, 0.4, 0.2, 1.1))
            return P.JobDAG([s0, s1], [edge], compose=compose)

        assert build().signature() == build().signature()
        assert build().signature() != build(theta0=1.5).signature()
        assert build().signature() != build(edge=("s1", "s0")).signature()
        assert build().signature() != build(
            compose=("sum", "sum")).signature()

    def test_stage_solver_reuse_across_jobs(self):
        fam = _family(P)
        theta = (1.3, 0.6, 0.8, 1.0)
        p1 = as_problem(fam.stage("a", theta).task)
        p2 = as_problem(fam.stage("b", theta).task)  # fresh closure
        assert p1 is p2

    def test_decode_gives_each_stage_its_knobs(self):
        stages = _stages(P, 2, seed=13)
        dag = P.JobDAG(stages, [("s0", "s1")])
        got = dag.decode(np.array([0.25, 0.5, 1.0, 0.0]))
        assert got == {"s0": {"parallelism": 0.25, "mem_frac": 0.5},
                       "s1": {"parallelism": 1.0,
                              "mem_frac": pytest.approx(0.1)}}


class TestDeviceDefault:
    @pytest.fixture
    def no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")

    def test_solve_dag_without_device_raises_here(self, no_cuda):
        dag = P.JobDAG(_stages(P, 2), [("s0", "s1")])
        with pytest.raises(RuntimeError, match="CUDA"):
            P.solve_dag(dag, n_probes_per_stage=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            dag.compose_frontiers(_fake_frontiers(dag, [2, 2]))
        with pytest.raises(RuntimeError, match="CUDA"):
            P.make_analytics_family()
