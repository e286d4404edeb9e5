"""The port's probe executor and MOGD solver against the JAX reference.

Descent is compared from the reference's own starting points (the two
packages draw multistarts from different generators), on both the scan
path (autograd) and the fused path (on this host the fused kernel's plain
version), at the executor's own parity tolerance of 1e-3.  The subgradient
cases pin JAX's conventions at ties (``jnp.clip`` splits a bound's gradient
0.5/0.5; ``torch.clamp`` would pass 1.0) to ``rtol=1e-6``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.synthetic as JS
from repro.core.mogd import MOGDConfig as JMOGDConfig
from repro.exec import ProbeExecutor as JProbeExecutor
from repro.exec import ProbeRequest as JProbeRequest
from repro.exec import adam_project_descend as j_adam_project_descend
from repro.exec.executor import _eq4_loss as j_eq4_loss
import repro_torch.core.synthetic as PS
from repro_torch.core import MOGDConfig, MOGDSolver, as_problem, solve_grouped
from repro_torch.core.mogd import estimate_objective_bounds
from repro_torch.exec import (
    ProbeExecutor,
    ProbeRequest,
    adam_project_descend,
    bucket,
    pad_rows,
)
from repro_torch.exec.executor import _eq4_loss
from repro_torch.models.convert import program_from_numpy

CPU = "cpu"
FAST = MOGDConfig(steps=30, multistart=4)
ATOL_GATE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's host-side work: the suite runs
    in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _export(tree):
    if isinstance(tree, dict):
        return {k: _export(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_export(v) for v in tree)
    return np.asarray(tree)


def _boxes(k, n, seed, lo=-1.5, span=3.0):
    rng = np.random.default_rng(seed)
    los = lo + rng.random((n, k)) * 0.5 * span
    his = los + (0.3 + rng.random((n, k))) * span
    return los, his


def _paired_requests(seed, n_boxes, bound=None):
    """One JAX request and its port twin over the same weights, starts and
    boxes (an MLP workload of the reference, weights carried across)."""
    jt = JS.mlp_surrogate_task(seed=seed, d=3, arch=(16, 16), bound=bound)
    jprob = jt.compile()
    prog = program_from_numpy(jprob.program.structure,
                              _export(jprob.program.params), device=CPU)
    pprob = as_problem(PS.mlp_surrogate_task(seed=seed, d=3, arch=(16, 16),
                                             bound=bound, device=CPU))
    k = jprob.k
    rng = np.random.default_rng(100 + seed)
    x0s = rng.random((n_boxes, FAST.multistart, 3)).astype(np.float32)
    los, his = _boxes(k, n_boxes, seed)
    targets = rng.integers(0, k, size=n_boxes).astype(np.int32)
    bounds = None
    if bound is not None:
        ulo = np.array([[-np.inf if bound[0] is None else bound[0],
                         -np.inf]] * n_boxes)
        uhi = np.array([[np.inf if bound[1] is None else bound[1],
                         np.inf]] * n_boxes)
        bounds = (ulo, uhi, np.ones((n_boxes, k)))
    jcfg = JMOGDConfig(steps=FAST.steps, multistart=FAST.multistart)
    jreq = JProbeRequest(program=jprob.program, encoder=jprob.encoder,
                         cfg=jcfg, x0s=x0s, los=los, his=his,
                         targets=targets, bounds=bounds)
    preq = ProbeRequest(program=prog, encoder=pprob.encoder, cfg=FAST,
                        x0s=x0s, los=los, his=his, targets=targets,
                        bounds=bounds)
    return jreq, preq


class TestDescentParity:
    @pytest.mark.parametrize("backend,jbackend", [("jnp", "jnp"),
                                                  ("fused", "fused")])
    @pytest.mark.parametrize("seed,bound", [(0, None), (1, (None, 0.5))])
    def test_executor_descent_matches_reference(self, backend, jbackend,
                                                seed, bound):
        jreq, preq = _paired_requests(seed, 5, bound)
        jx, jf, jfeas = JProbeExecutor(mesh=None, backend=jbackend
                                       ).solve_requests([jreq])
        ex = ProbeExecutor(backend=backend, device=CPU)
        px, pf, pfeas = ex.solve_requests([preq])
        np.testing.assert_array_equal(pfeas, np.asarray(jfeas))
        np.testing.assert_allclose(px, np.asarray(jx), atol=ATOL_GATE, rtol=0)
        np.testing.assert_allclose(pf, np.asarray(jf), atol=ATOL_GATE,
                                   rtol=1e-4)
        assert ex.stats()["fused_dispatches"] == (backend == "fused")

    def test_auto_backend_routes_mlp_through_fused(self):
        _, preq = _paired_requests(2, 3)
        ex = ProbeExecutor(backend="auto", device=CPU)
        ex.solve_requests([preq])
        s = ex.stats()
        assert s["fused_structures"] == 1 and s["fused_dispatches"] == 1
        assert s["fused_fallbacks"] == 0 and s["sharded_dispatches"] == 0

    def test_parity_gate_falls_back(self, monkeypatch):
        monkeypatch.setattr(ProbeExecutor, "_parity_check",
                            lambda self, req, plan: False)
        _, preq = _paired_requests(3, 3)
        ex = ProbeExecutor(backend="auto", device=CPU)
        x, _, _ = ex.solve_requests([preq])
        s = ex.stats()
        assert s["fused_fallbacks"] == 1 and s["fused_dispatches"] == 0
        assert x.shape == (3, 3)

    def test_parity_gate_lets_kernel_errors_propagate(self, monkeypatch):
        import repro_torch.kernels.mogd_descend as md

        def broken(*a, **kw):
            raise RuntimeError("kernel build failed")

        monkeypatch.setattr(md, "descend_batch", broken)
        _, preq = _paired_requests(4, 2)
        ex = ProbeExecutor(backend="auto", device=CPU)
        with pytest.raises(RuntimeError, match="kernel build failed"):
            ex.solve_requests([preq])

    def test_closures_stay_on_scan_and_fused_rejects_them(self):
        problem = PS.make_zdt1(d=3, device=CPU)
        boxes = np.stack(_boxes(2, 2, 0, lo=0.0, span=1.0), axis=1)
        ex = ProbeExecutor(backend="auto", device=CPU)
        MOGDSolver(problem, FAST, executor=ex, device=CPU).solve(boxes)
        assert ex.stats()["fused_structures"] == 0
        fx = ProbeExecutor(backend="fused", device=CPU)
        with pytest.raises(ValueError, match="fused"):
            MOGDSolver(problem, FAST, executor=fx, device=CPU).solve(boxes)


# ---------------------------------------------------------------------------
# Grouped dispatch, bucketing, padding invariance
# ---------------------------------------------------------------------------


def _boxes_for(problem, n, seed=0):
    b = estimate_objective_bounds(problem, n=256, seed=seed)
    rng = np.random.default_rng(seed)
    lo = b[0] + rng.random((n, problem.k)) * 0.3 * (b[1] - b[0])
    hi = lo + (0.2 + 0.5 * rng.random((n, problem.k))) * (b[1] - b[0])
    return np.stack([lo, hi], axis=1)


class TestGrouping:
    def test_bucket_and_pad_rows(self):
        assert [bucket(b) for b in (1, 4, 5, 8, 9, 33)] == [1, 4, 8, 8, 16, 64]
        t = {"a": np.arange(6.0).reshape(3, 2),
             "b": torch.arange(3.0)}
        p = pad_rows(t, 2)
        assert p["a"].shape == (5, 2) and tuple(p["b"].shape) == (5,)
        np.testing.assert_array_equal(p["a"][3:], t["a"][:1].repeat(2, 0))
        assert p["b"][3:].tolist() == [0.0, 0.0]

    @pytest.mark.parametrize("backend", ["jnp", "fused"])
    def test_grouped_equals_individual(self, backend):
        pa = as_problem(PS.mlp_surrogate_task(seed=0, device=CPU))
        pb = as_problem(PS.mlp_surrogate_task(seed=1, bound=(None, 0.5),
                                              device=CPU))
        boxes_a, boxes_b = _boxes_for(pa, 3), _boxes_for(pb, 5, seed=2)

        def fresh(problem):
            return MOGDSolver(problem, FAST, device=CPU,
                              executor=ProbeExecutor(backend=backend,
                                                     device=CPU))

        ra = fresh(pa).solve(boxes_a, target=0)
        rb = fresh(pb).solve(boxes_b, target=1)
        ga, gb = fresh(pa), fresh(pb)
        assert ga.dispatch_key() == gb.dispatch_key()  # bounds are data
        shared = ProbeExecutor(backend=backend, device=CPU)
        ga.executor = gb.executor = shared
        res = solve_grouped([(ga, boxes_a, 0), (gb, boxes_b, 1)])
        assert shared.dispatches == 1
        np.testing.assert_allclose(res.x[:3], ra.x, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res.f[3:], rb.f, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res.feasible[:3], ra.feasible)
        np.testing.assert_array_equal(res.feasible[3:], rb.feasible)

    @pytest.mark.parametrize("backend", ["jnp", "fused"])
    def test_padding_invariance(self, backend):
        problem = as_problem(PS.mlp_surrogate_task(seed=5, device=CPU))
        boxes = _boxes_for(problem, 5)
        ref = MOGDSolver(problem, FAST, device=CPU, executor=ProbeExecutor(
            bucket_fn=lambda b: b, backend=backend, device=CPU)).solve(boxes)
        ex = ProbeExecutor(backend=backend, device=CPU)
        pad = MOGDSolver(problem, FAST, device=CPU, executor=ex).solve(boxes)
        assert ex.last_bucket == (1, 8) and pad.x.shape == (5, problem.dim)
        np.testing.assert_array_equal(pad.feasible, ref.feasible)
        np.testing.assert_allclose(pad.x, ref.x, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pad.f, ref.f, rtol=1e-5, atol=1e-6)

    def test_structure_sharing_and_mixed_groups(self):
        ex = ProbeExecutor(device=CPU)
        s0 = MOGDSolver(as_problem(PS.mlp_surrogate_task(seed=0, device=CPU)),
                        FAST, executor=ex, device=CPU)
        s1 = MOGDSolver(as_problem(PS.mlp_surrogate_task(seed=1, device=CPU)),
                        dataclasses.replace(FAST, seed=17), executor=ex,
                        device=CPU)
        s2 = MOGDSolver(as_problem(PS.mlp_surrogate_task(
            seed=2, arch=(16, 8), device=CPU)), FAST, executor=ex, device=CPU)
        assert s0.dispatch_key() == s1.dispatch_key()
        assert s0.dispatch_key() != s2.dispatch_key()
        with pytest.raises(ValueError, match="structure"):
            solve_grouped([(s0, _boxes_for(s0.problem, 2), 0),
                           (s2, _boxes_for(s2.problem, 2), 0)])

    def test_unsatisfiable_bound_is_infeasible(self):
        problem = as_problem(PS.mlp_surrogate_task(seed=4, bound=(None, -1e6),
                                                   device=CPU))
        res = MOGDSolver(problem, FAST, device=CPU,
                         executor=ProbeExecutor(device=CPU)).solve(
            _boxes_for(problem, 4))
        assert not res.feasible.any()


# ---------------------------------------------------------------------------
# Subgradients at ties and on the walls of [0,1]^D
# ---------------------------------------------------------------------------


class TestSubgradients:
    @pytest.mark.parametrize("fhat", [(0.0, 1.0), (1.0, 0.0), (1.0, 1.0),
                                      (0.0, 0.0), (0.5, 1.0)])
    @pytest.mark.parametrize("target", [0, 1])
    def test_eq4_grad_at_box_edges(self, fhat, target):
        lo = np.array([0.25, -1.0], np.float32)
        hi = np.array([0.75, 3.0], np.float32)
        f = (lo + np.array(fhat, np.float32) * (hi - lo)).astype(np.float32)
        # fhat is exactly 0 or 1 in fp32 at these points
        assert np.all(((f - lo) / (hi - lo))[np.array(fhat) != 0.5]
                      == np.array(fhat, np.float32)[np.array(fhat) != 0.5])
        want = np.asarray(jax.grad(
            lambda f_: j_eq4_loss(f_, jnp.asarray(lo), jnp.asarray(hi),
                                  target, 100.0, 1e-4))(jnp.asarray(f)))
        got = torch.func.grad(
            lambda f_: _eq4_loss(f_, torch.as_tensor(lo), torch.as_tensor(hi),
                                 torch.tensor(target), 100.0, 1e-4))(
            torch.as_tensor(f)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("wall", [0.0, 1.0])
    def test_descent_from_the_walls(self, wall):
        """Starts on the walls of [0,1]^D with fhat exactly 0 or 1: the
        projected descent must follow the reference's subgradients."""
        lo = np.array([0.0, 0.0, 0.0], np.float32)
        hi = np.array([1.0, 1.0, 1.0], np.float32)
        x0 = np.array([wall, wall, 0.5], np.float32)
        cfg = MOGDConfig(steps=20)
        jcfg = JMOGDConfig(steps=20)

        def jloss(x):
            f = jnp.stack([x[0], x[1] * x[2] + x[0], 1.0 - x[1]])
            return j_eq4_loss(f, jnp.asarray(lo), jnp.asarray(hi), 1, 100.0,
                              1e-4)

        def ploss(x):
            f = torch.stack([x[0], x[1] * x[2] + x[0], 1.0 - x[1]])
            return _eq4_loss(f, torch.as_tensor(lo), torch.as_tensor(hi),
                             torch.tensor(1), 100.0, 1e-4)

        want = np.asarray(j_adam_project_descend(jloss, jnp.asarray(x0),
                                                 jcfg))
        got = adam_project_descend(ploss, torch.as_tensor(x0), cfg).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Per-row params and uncertainty-weighted programs ride as data too
# ---------------------------------------------------------------------------


def _sphere_program(with_std):
    from repro_torch.exec import ParamProgram

    def apply(p, x):
        return torch.stack([torch.sum((x - p["a"]) ** 2),
                            torch.sum((x - p["b"]) ** 2)])

    def apply_std(p, x):
        return p["s"] * (1.0 + x[0]) * torch.ones(2)

    params = {"a": torch.full((3,), 0.25), "b": torch.full((3,), 0.75),
              "s": torch.tensor(0.3)}
    return ParamProgram(apply, params, ("sphere-std", 3),
                        apply_std if with_std else None)


class TestDataPaths:
    def test_per_row_params_equal_shared_params(self):
        prog = _sphere_program(False)
        enc = as_problem(PS.sphere2_task(d=3, device=CPU)).encoder
        rng = np.random.default_rng(0)
        B = 3
        x0s = rng.random((B, 4, 3)).astype(np.float32)
        los, his = _boxes(2, B, 1, lo=0.0, span=0.6)
        targets = np.array([0, 1, 0], np.int32)
        shared = ProbeRequest(program=prog, encoder=enc, cfg=FAST, x0s=x0s,
                              los=los, his=his, targets=targets)
        per_row = dataclasses.replace(shared, params_b={
            k: v[None].expand(B, *v.shape) for k, v in prog.params.items()})
        ex = ProbeExecutor(device=CPU)
        xs, fs, ok_s = ex.solve_requests([shared])
        xr, fr, ok_r = ex.solve_requests([per_row])
        assert ex.last_bucket == (4, 1)  # B groups of one row
        np.testing.assert_array_equal(ok_r, ok_s)
        np.testing.assert_allclose(xr, xs, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(fr, fs, rtol=1e-5, atol=1e-6)

    def test_std_weighted_program_equals_its_closure(self):
        from repro_torch.exec import closure_program

        prog = _sphere_program(True)
        enc = as_problem(PS.sphere2_task(d=3, device=CPU)).encoder
        rng = np.random.default_rng(1)
        B = 2
        x0s = rng.random((B, 4, 3)).astype(np.float32)
        los, his = _boxes(2, B, 2, lo=0.0, span=0.8)
        alphas = np.array([[0.5, 1.0]] * B, np.float32)
        targets = np.zeros(B, np.int32)
        req = ProbeRequest(program=prog, encoder=enc, cfg=FAST, x0s=x0s,
                           los=los, his=his, targets=targets, alphas=alphas,
                           use_std=True)
        a = torch.as_tensor(alphas[0])

        def eff(x):
            return (prog.apply(prog.params, x)
                    + a * prog.apply_std(prog.params, x))

        closed = ProbeRequest(program=closure_program(eff, "eff"),
                              encoder=enc, cfg=FAST, x0s=x0s, los=los,
                              his=his, targets=targets)
        ex = ProbeExecutor(device=CPU)
        x1, f1, ok1 = ex.solve_requests([req])
        x2, f2, ok2 = ex.solve_requests([closed])
        assert ex.stats()["fused_structures"] == 0
        np.testing.assert_array_equal(ok1, ok2)
        np.testing.assert_allclose(x1, x2, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(f1, f2, rtol=1e-5, atol=1e-6)
