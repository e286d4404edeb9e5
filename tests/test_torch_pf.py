"""The Progressive Frontier, end to end, against the JAX reference.

Both packages run PF-AP on the same task at the same probe budget, and the
frontier hypervolumes (HV, against one reference point past both nadirs)
must agree within ±0.5 %, the band the reference's own parity benchmarks
use.  The port draws its random numbers from ``torch.Generator``s, which
give other numbers than JAX's PRNG for the same seed, so these runs feed
the reference's draws to the port: the multistart seeds of every MOGD
dispatch (the reference solver's key stream) and the samples of the
objective-bound estimate.  MLP weights are carried across with
``models.convert``.  A run of the port on its own draws is checked for a
sound frontier.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.synthetic as JS
import repro_torch.core as P
from repro.kernels.mogd_descend import descend_batch as j_descend_batch
from repro.kernels.mogd_descend import plan_from_structure as j_plan
from repro_torch.core.problem import MOOProblem
from repro_torch.exec import tree_map
from repro_torch.kernels import mogd_descend as pmd
from repro_torch.models.convert import program_from_numpy

CPU = "cpu"
BUDGET = 64
HV_BAND = 0.005  # ±0.5 % of the reference's HV


def _export(tree):
    if isinstance(tree, dict):
        return {k: _export(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_export(v) for v in tree)
    return np.asarray(tree)


def _tasks(name, mlp_seed=0):
    """(reference TaskSpec, port TaskSpec) over the same model."""
    if name == "zdt1":
        return J.zdt1_task(d=4), P.zdt1_task(d=4, device=CPU)
    if name == "sphere2":
        return J.sphere2_task(), P.sphere2_task(device=CPU)
    jt = JS.mlp_surrogate_task(seed=mlp_seed, d=3, arch=(16, 16))
    prog = program_from_numpy(jt.program.structure,
                              _export(jt.program.params), device=CPU)
    pt = P.TaskSpec(knobs=P.mlp_surrogate_task(d=3, device=CPU).knobs,
                    objectives=jt.objectives, program=prog, name=jt.name,
                    device=CPU)
    return jt, pt


def _reference_draws(monkeypatch):
    """Make the port draw the reference's numbers: each solver replays the
    reference solver's key stream, and problem sampling the reference's
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


def _hv_pair(ref_res, port_res):
    nadir = np.maximum(ref_res.nadir, port_res.nadir)
    utopia = np.minimum(ref_res.utopia, port_res.utopia)
    point = nadir + 0.1 * (nadir - utopia)
    return J.hypervolume(ref_res.F, point), P.hypervolume(port_res.F, point)


@pytest.mark.parametrize("name", ["zdt1", "sphere2", "mlp"])
def test_hv_within_band_of_reference(monkeypatch, name):
    _reference_draws(monkeypatch)
    jt, pt = _tasks(name)
    jcfg, pcfg = J.MOGDConfig(multistart=8), P.MOGDConfig(multistart=8)
    jprob, pprob = J.as_problem(jt), P.as_problem(pt)
    # fresh solvers, so each package starts its random stream at the seed
    want = J.ProgressiveFrontier(
        jprob, mogd=jcfg, solver=J.MOGDSolver(jprob, jcfg)).run(BUDGET)
    got = P.ProgressiveFrontier(
        pprob, mogd=pcfg, solver=P.MOGDSolver(pprob, pcfg, device=CPU),
        use_kernel=True, device=CPU).run(BUDGET)
    assert got.probes == want.probes
    hv_ref, hv_port = _hv_pair(want, got)
    assert hv_ref > 0.0
    assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)


@pytest.mark.parametrize("name", ["zdt1", "mlp"])
def test_solve_pf_on_own_draws_gives_a_sound_frontier(name):
    _, pt = _tasks(name)
    res = P.solve_pf(pt, n_probes=24,
                     mogd=P.MOGDConfig(steps=60, multistart=8), device=CPU)
    assert res.probes >= 24 and len(res.F) >= 2
    assert np.all(np.isfinite(res.F))
    assert res.X.shape == (len(res.F), P.as_problem(pt).dim)
    assert bool(P.pareto_mask(res.F).all())
    assert P.frontier_hypervolume(res.state) > 0.0
    idx = pt.preference.pick(res.F, res.utopia, res.nadir)
    assert 0 <= idx < len(res.F)


def test_sequential_mode_matches_reference(monkeypatch):
    """PF-AS (one middle-point probe per step) on the shared draws."""
    _reference_draws(monkeypatch)
    jt, pt = _tasks("sphere2")
    jcfg = J.MOGDConfig(steps=60, multistart=8)
    pcfg = P.MOGDConfig(steps=60, multistart=8)
    jprob, pprob = J.as_problem(jt), P.as_problem(pt)
    want = J.ProgressiveFrontier(jprob, mode="AS", mogd=jcfg,
                                 solver=J.MOGDSolver(jprob, jcfg)).run(10)
    got = P.ProgressiveFrontier(pprob, mode="AS", mogd=pcfg,
                                solver=P.MOGDSolver(pprob, pcfg, device=CPU),
                                device=CPU).run(10)
    hv_ref, hv_port = _hv_pair(want, got)
    assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)


def test_reference_solver_matches_on_shared_samples(monkeypatch):
    """The PF-S brute-force solver (small sample and refine budgets)."""
    _reference_draws(monkeypatch)
    jt, pt = _tasks("sphere2")
    box = np.array([[0.0, 0.0], [0.6, 1.2]])
    kw = dict(n_samples=512, n_refine=8, refine_steps=40, seed=3)
    want = J.grid_reference_solve(J.as_problem(jt), box, target=0, **kw)
    got = P.grid_reference_solve(P.as_problem(pt), box, target=0, **kw)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    np.testing.assert_allclose(got.f, want.f, rtol=1e-4, atol=1e-5)


def test_export_import_and_seed_round_trip():
    _, pt = _tasks("mlp")
    cfg = P.MOGDConfig(steps=30, multistart=4)
    pf = P.ProgressiveFrontier(pt, mogd=cfg, use_kernel=True, device=CPU)
    res = pf.run(n_probes=12)
    arrays, meta = P.export_pf_state(res.state)
    back = pf.import_state(arrays, meta)
    np.testing.assert_array_equal(back.store.frontier()[0], res.F)
    assert back.queue.uncertain_fraction == pytest.approx(
        res.state.queue.uncertain_fraction)
    assert back.hv == res.state.hv and back.probes == res.probes
    fresh = pf.seed(res.X)
    F_seeded, _ = fresh.store.frontier()
    assert len(F_seeded) >= 1 and fresh.hv > 0.0
    assert bool(P.pareto_mask(F_seeded).all())


# ---------------------------------------------------------------------------
# The mismatch logged in ROADMAP Queue 3: mlp_surrogate_task(seed=3) at 60
# steps and MOGD seed 1, where the port's HV lies far above the band
# ---------------------------------------------------------------------------

SEED3_CFG = dict(steps=60, multistart=8, seed=1)
# the four cells of the first PF-AP step of that run (lo, hi rows), as the
# reference computes them; the port's differ from these by < 3e-7
SEED3_CELLS = np.array([
    [[-1.26889551, -2.62088656], [-1.24573982, -2.52397716]],
    [[-1.26889551, -2.52397716], [-1.24573982, -2.42706776]],
    [[-1.24573982, -2.62088656], [-1.22258413, -2.52397716]],
    [[-1.24573982, -2.52397716], [-1.22258413, -2.42706776]],
])


def test_seed3_port_frontier_is_real_in_the_reference_model(monkeypatch):
    """The case itself: the port's frontier covers at least the reference's
    HV, and every point of it is achievable in the reference's model (its
    configuration re-evaluates there to its values)."""
    _reference_draws(monkeypatch)
    jt, pt = _tasks("mlp", mlp_seed=3)
    jcfg, pcfg = J.MOGDConfig(**SEED3_CFG), P.MOGDConfig(**SEED3_CFG)
    jprob, pprob = J.as_problem(jt), P.as_problem(pt)
    want = J.ProgressiveFrontier(
        jprob, mogd=jcfg, solver=J.MOGDSolver(jprob, jcfg)).run(BUDGET)
    got = P.ProgressiveFrontier(
        pprob, mogd=pcfg, solver=P.MOGDSolver(pprob, pcfg, device=CPU),
        use_kernel=True, device=CPU).run(BUDGET)
    hv_ref, hv_port = _hv_pair(want, got)
    assert hv_port >= (1.0 - HV_BAND) * hv_ref, (hv_port, hv_ref)
    F_ref_model = np.asarray(jprob.evaluate_batch(got.X))
    np.testing.assert_allclose(F_ref_model, got.F, rtol=1e-5, atol=1e-5)


def test_seed3_cell_divergence_is_fp32_rounding():
    """Why the frontiers part: the last cell of the first PF-AP step.

    Alone in its batch, the reference and the port descend to the same
    points (the reference's tolerance, 2e-5).  A float64 descent of the same
    cell ends far from both: this descent amplifies fp32 rounding.  In the
    four-cell batch the port's products round differently, and its fp32
    descent of that cell follows the float64 one, which makes the cell
    feasible in the port and infeasible in the reference."""
    jt, pt = _tasks("mlp", mlp_seed=3)
    jprob, pprob = J.as_problem(jt), P.as_problem(pt)
    key = jax.random.PRNGKey(SEED3_CFG["seed"])
    for _ in range(3):  # the reference solver's third dispatch
        key, sub = jax.random.split(key)
    x0s = np.asarray(jax.random.uniform(sub, (4, 8, 3)), np.float32)
    jcfg, pcfg = J.MOGDConfig(**SEED3_CFG), P.MOGDConfig(**SEED3_CFG)
    plan = pmd.plan_from_structure(pprob.program.structure)
    jparams = jax.tree.map(lambda a: a[None], jprob.program.params)

    def rows(cells):
        n = len(cells)
        return (x0s[None, cells], SEED3_CELLS[None, cells, 0],
                SEED3_CELLS[None, cells, 1], np.full((1, n, 2), -np.inf),
                np.full((1, n, 2), np.inf), np.ones((1, n, 2)))

    def port(cells, dtype):
        prep, shape = pmd._prepare(
            plan, *[torch.as_tensor(np.asarray(a, np.float32))
                    for a in rows(cells)],
            torch.zeros((1, len(cells)), dtype=torch.int64))
        folded = pmd.fold_affine(plan, tree_map(
            lambda a: a[None].to(dtype), pprob.program.params))
        out = pmd._descend_plain(plan, pcfg, folded,
                                 *[t.to(dtype) for t in prep])
        return out.reshape(shape).numpy()[0]

    ref_alone = np.asarray(j_descend_batch(
        j_plan(jprob.program.structure), jcfg, jparams,
        *[np.asarray(a, np.float32) for a in rows([3])],
        np.zeros((1, 1), np.int32), impl="xla"))[0, 0]
    port_alone = port([3], torch.float32)[0]
    exact = port([3], torch.float64)[0]
    port_batched = port([0, 1, 2, 3], torch.float32)[3]
    np.testing.assert_allclose(port_alone, ref_alone, atol=2e-5, rtol=0)
    assert np.abs(ref_alone - exact).max() > 1e-2
    np.testing.assert_allclose(port_batched, exact, atol=1e-5, rtol=0)
