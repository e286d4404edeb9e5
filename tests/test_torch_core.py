"""The port's front door and Pareto layer against the JAX reference.

Inputs are made once with numpy from a seed and handed to both packages.
Tolerances: encodings, snaps, selections, masks and frontier live sets are
compared exactly (the port compares in float32, as the reference does with
JAX x64 off); objective values at float32 rounding (``rtol=1e-5``);
carried MLP weights predict within ``2e-5``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.synthetic as JS
import repro.data.workloads as JW
from repro.core.frontier_store import FrontierStore as JFrontierStore
from repro.models.mlp import MLPRegressor as JMLPRegressor
from repro.models.mlp import MLPSpec as JMLPSpec
from repro.models.mlp import init_mlp as j_init_mlp
import repro_torch.core as P
import repro_torch.core.synthetic as PS
import repro_torch.data.workloads as PW
from repro_torch.core.frontier_store import FrontierStore
from repro_torch.models.convert import program_from_numpy, regressor_from_numpy

CPU = "cpu"


def _mixed_specs(mod):
    return [mod.continuous("c", 0.0, 2.0), mod.integer("n", 1, 8),
            mod.categorical("mode", ("slow", "fast", "turbo")),
            mod.boolean("flag")]


# ---------------------------------------------------------------------------
# Encoder, evaluation, selection, signatures
# ---------------------------------------------------------------------------


class TestEncoder:
    @pytest.mark.parametrize("space", ["mixed", "spark"])
    def test_roundtrip_and_snap_equal(self, space):
        if space == "mixed":
            je, pe = (J.SpaceEncoder(_mixed_specs(J)),
                      P.SpaceEncoder(_mixed_specs(P)))
        else:
            je = J.SpaceEncoder(JW.spark_space())
            pe = P.SpaceEncoder(PW.spark_space())
        assert pe.dim == je.dim
        X = np.random.default_rng(0).random((64, je.dim)).astype(np.float32)
        for x in X:
            dj, dp = je.decode(x), pe.decode(torch.as_tensor(x))
            assert dj == dp
            np.testing.assert_array_equal(pe.encode(dp), je.encode(dj))
        np.testing.assert_array_equal(
            pe.snap(torch.as_tensor(X)).numpy(),
            np.asarray(je.snap(jnp.asarray(X))))

    def test_validation_errors(self):
        pe = P.SpaceEncoder(_mixed_specs(P))
        good = {"c": 1.0, "n": 3, "mode": "fast", "flag": True}
        pe.encode(good)
        for bad, msg in [({**good, "x": 1}, "unknown"),
                         ({k: v for k, v in good.items() if k != "n"},
                          "missing"),
                         ({**good, "mode": "warp"}, "not in choices"),
                         ({**good, "c": 3.0}, "outside")]:
            with pytest.raises(ValueError, match=msg):
                pe.encode(bad)


class TestEvaluate:
    @pytest.mark.parametrize("name", ["zdt1", "sphere2", "dtlz2", "mixed",
                                      "batch", "streaming"])
    def test_evaluate_batch_agrees(self, name):
        if name == "zdt1":
            jp, pp = J.make_zdt1(), PS.make_zdt1(device=CPU)
        elif name == "sphere2":
            jp, pp = J.make_sphere2(), PS.make_sphere2(device=CPU)
        elif name == "dtlz2":
            jp, pp = J.make_dtlz2(k=3), PS.make_dtlz2(k=3, device=CPU)
        elif name == "mixed":
            jp, pp = J.make_mixed_problem(), PS.make_mixed_problem(device=CPU)
        elif name == "batch":
            jp = JW.batch_problem(JW.batch_suite()[5])
            pp = PW.batch_problem(PW.batch_suite()[5], device=CPU)
        else:
            jp = JW.streaming_problem(JW.streaming_suite()[3], k=3)
            pp = PW.streaming_problem(PW.streaming_suite()[3], k=3,
                                      device=CPU)
        X = np.random.default_rng(1).random((33, jp.dim)).astype(np.float32)
        want = np.asarray(jp.evaluate_batch(jnp.asarray(X)))
        got = pp.evaluate_batch(X).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_suites_are_shared_inputs(self):
        assert PW.batch_suite() == [
            PW.BatchWorkload(**w.__dict__) for w in JW.batch_suite()]
        assert len(PW.batch_suite()) == 258
        assert len(PW.streaming_suite()) == 63


class TestSelect:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_selectors_pick_same_index(self, seed):
        rng = np.random.default_rng(seed)
        F = rng.random((40, 2))
        u, n = F.min(0), F.max(0)
        w = (0.3, 0.7)
        assert P.utopia_nearest(F, u, n) == J.utopia_nearest(F, u, n)
        assert (P.weighted_utopia_nearest(F, u, n, w)
                == J.weighted_utopia_nearest(F, u, n, w))
        for lat in (5.0, 100.0, 1000.0):
            assert (P.workload_aware_wun(F, u, n, w, lat)
                    == J.workload_aware_wun(F, u, n, w, lat))
        for pref in ("un", "wun"):
            assert (P.preference_from_legacy(pref, w).pick(F, u, n)
                    == J.preference_from_legacy(pref, w).pick(F, u, n))


class TestSignature:
    def test_equal_specs_equal_signatures(self):
        a, b = PS.zdt1_task(device=CPU), PS.zdt1_task(device=CPU)
        assert a.signature() == b.signature()
        assert a.signature() != PS.zdt1_task(f2_cap=2.0,
                                             device=CPU).signature()
        assert a.signature() != PS.sphere2_task(device=CPU).signature()
        m0 = PS.mlp_surrogate_task(seed=0, device=CPU)
        assert m0.signature() == PS.mlp_surrogate_task(
            seed=0, device=CPU).signature()
        assert m0.signature() != PS.mlp_surrogate_task(
            seed=1, device=CPU).signature()

    def test_fresh_equal_specs_share_one_solver(self):
        cfg = P.MOGDConfig(steps=5, multistart=2)
        p1 = P.as_problem(PS.sphere2_task(device=CPU))
        p2 = P.as_problem(PS.sphere2_task(device=CPU))
        assert p1 is p2
        assert (p1.solver_for(cfg, device=CPU)
                is p2.solver_for(cfg, device=CPU))

    def test_preference_is_not_in_the_signature(self):
        a = PS.sphere2_task(device=CPU)
        b = PS.sphere2_task(preference=P.WeightedUtopiaNearest((0.2, 0.8)),
                            device=CPU)
        assert a.signature() == b.signature()


# ---------------------------------------------------------------------------
# Pareto primitives
# ---------------------------------------------------------------------------


class TestPareto:
    @pytest.mark.parametrize("n,k", [(60, 2), (45, 3)])
    def test_masks_and_hypervolume_agree(self, n, k):
        rng = np.random.default_rng(n)
        F = rng.random((n, k))
        F[3] = F[4]  # a duplicate pair
        valid = rng.random(n) > 0.3
        np.testing.assert_array_equal(P.pareto_mask(F).numpy(),
                                      np.asarray(J.pareto_mask(jnp.asarray(F))))
        np.testing.assert_array_equal(
            P.pareto_filter_masked(F, valid).numpy(),
            np.asarray(J.pareto_filter_masked(jnp.asarray(F),
                                              jnp.asarray(valid))))
        pts, pay = P.pareto_filter(F, np.arange(n))
        jpts, jpay = J.pareto_filter(F, np.arange(n))
        np.testing.assert_array_equal(pay, jpay)
        np.testing.assert_array_equal(pts, jpts)
        ref = np.full(k, 1.1)
        assert P.hypervolume(F, ref) == pytest.approx(
            J.hypervolume(F, ref), rel=1e-12)
        np.testing.assert_array_equal(P.crowding_distance(F),
                                      J.crowding_distance(F))
        assert P.coverage_spread(F) == J.coverage_spread(F)
        np.testing.assert_array_equal(
            P.dominates(F[:, None], F[None]).numpy(),
            np.asarray(J.dominates(jnp.asarray(F)[:, None],
                                   jnp.asarray(F)[None])))

    def test_hypervolume_2d_edge_cases(self):
        assert P.hypervolume_2d(np.zeros((0, 2)), [1, 1]) == 0.0
        F = np.array([[2.0, 2.0]])
        assert P.hypervolume_2d(F, [1, 1]) == J.hypervolume_2d(F, [1, 1])


# ---------------------------------------------------------------------------
# Frontier store: the same offer stream leaves the same live set
# ---------------------------------------------------------------------------


def _offer_stream(seed, k, n_batches=12):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        B = int(rng.integers(1, 40))
        F = rng.random((B, k)) * (1.0 + 0.1 * b)
        if B > 3:
            F[1] = F[0]  # duplicate inside the batch
            F[2, 0] = np.nan if b == 3 else F[2, 0]
        out.append((F, rng.random((B, 4))))
    return out


class TestFrontierStore:
    @pytest.mark.parametrize("use_kernel", [False, True])
    @pytest.mark.parametrize("k,seed,bounds", [
        (2, 0, None), (3, 1, None), (2, 2, [[-np.inf, 0.9], [-np.inf, np.inf]]),
    ])
    def test_same_stream_same_live_set(self, use_kernel, k, seed, bounds):
        jb = None if bounds is None else np.asarray(bounds)
        js = JFrontierStore(k, 4, capacity=8, use_kernel=use_kernel,
                            kernel_interpret=True, bounds=jb)
        ps = FrontierStore(k, 4, capacity=8, use_kernel=use_kernel,
                           bounds=jb, device=CPU)
        for F, X in _offer_stream(seed, k):
            assert ps.add(F, X) == js.add(F, X)
            pf, px = ps.frontier()
            jf, jx = js.frontier()
            np.testing.assert_array_equal(pf, jf)
            np.testing.assert_array_equal(px, jx)
        assert ps.capacity == js.capacity
        assert (ps.total_offered, ps.total_accepted, ps.total_infeasible) == (
            js.total_offered, js.total_accepted, js.total_infeasible)

    def test_state_roundtrip(self):
        ps = FrontierStore(2, 4, device=CPU)
        for F, X in _offer_stream(5, 2):
            ps.add(F, X)
        arrays, meta = ps.state_dict()
        back = FrontierStore.from_state(arrays, meta, device=CPU)
        np.testing.assert_array_equal(back.frontier()[0], ps.frontier()[0])
        F = np.array([[0.0, 0.0]])
        assert back.add(F, np.zeros((1, 4))) == ps.add(F, np.zeros((1, 4)))
        np.testing.assert_array_equal(back.frontier()[0], ps.frontier()[0])


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package
# ---------------------------------------------------------------------------


def _jax_regressor(seed, d, hidden, log_target):
    import jax

    spec = JMLPSpec(d, hidden, 1)
    rng = np.random.default_rng(seed)
    return JMLPRegressor(
        spec=spec, params=j_init_mlp(jax.random.PRNGKey(seed), spec),
        x_mean=jnp.asarray(rng.random(d) * 0.3, jnp.float32),
        x_std=jnp.asarray(0.5 + rng.random(d), jnp.float32),
        y_mean=jnp.float32(0.7), y_std=jnp.float32(1.3),
        dropout=0.1, log_target=log_target)


def _export(tree):
    if isinstance(tree, dict):
        return {k: _export(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_export(v) for v in tree)
    return np.asarray(tree)


class TestCarriedWeights:
    @pytest.mark.parametrize("log_target", [False, True])
    def test_regressor_predicts_the_same(self, log_target):
        jr = _jax_regressor(3, 13, (128, 128, 128, 128), log_target)
        pr = regressor_from_numpy(
            _export(jr.params), np.asarray(jr.x_mean), np.asarray(jr.x_std),
            np.asarray(jr.y_mean), np.asarray(jr.y_std),
            log_target=log_target, dropout=jr.dropout, device=CPU)
        X = np.random.default_rng(4).random((50, 13)).astype(np.float32)
        want = np.asarray(jr(jnp.asarray(X)))
        got = pr(torch.as_tensor(X)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        assert pr.structure_key() == jr.structure_key()

    def test_stacked_program_evaluates_the_same(self):
        jt = JS.mlp_surrogate_task(seed=2, d=3, arch=(16, 16))
        jprob = jt.compile()
        prog = program_from_numpy(jt.program.structure,
                                  _export(jt.program.params), device=CPU)
        pt = P.TaskSpec(knobs=P.mlp_surrogate_task(device=CPU).knobs,
                        objectives=jt.objectives, program=prog, device=CPU)
        assert pt.program.structure == jt.program.structure
        X = np.random.default_rng(5).random((20, 3)).astype(np.float32)
        want = np.asarray(jprob.evaluate_batch(jnp.asarray(X)))
        got = P.as_problem(pt).evaluate_batch(X).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
