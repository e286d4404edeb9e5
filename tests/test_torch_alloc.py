"""The port's probe-budget allocation plane against the JAX package's.

``alloc`` has no JAX in either package, so the same ``Candidate`` sets and
seeds must give exactly the same allocations, floors, deadline guard and
``observe`` weight updates in both (compared with ``==`` and
``assert_array_equal``).  The classes below mirror ``tests/test_alloc.py``'s
``TestFeatures``, ``TestUniformParity``, ``TestGainBandit`` and
``TestServiceWiring`` on the port, with the service on the host
(``device="cpu"``).  Their MLP tenants carry the reference's
``mlp_surrogate_task`` weights across, so both suites see the same models.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import repro.alloc as J
import repro.core.synthetic as JS
from repro_torch.alloc import (
    FEATURE_NAMES,
    SLO_URGENCY,
    Candidate,
    GainBanditPolicy,
    UniformPolicy,
    feature_matrix,
)
from repro_torch.core import MOGDConfig, Objective, TaskSpec, continuous
from repro_torch.core.synthetic import zdt1_task
from repro_torch.models.convert import program_from_numpy
from repro_torch.service import MOOService

CPU = "cpu"
FAST = MOGDConfig(steps=40, multistart=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
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


def mlp_surrogate_task(seed, d, arch):
    """The reference's ``mlp_surrogate_task`` with its weights carried
    across to a port TaskSpec on the host."""
    jt = JS.mlp_surrogate_task(seed=seed, d=d, arch=arch)
    prog = program_from_numpy(jt.program.structure,
                              _export(jt.program.params), device=CPU)
    knobs = tuple(continuous(f"x{t}", 0.0, 1.0) for t in range(d))
    objectives = tuple(Objective(o.name) for o in jt.objectives)
    return TaskSpec(knobs=knobs, objectives=objectives, program=prog,
                    name=jt.name, device=CPU)


def _cand(sid, **kw):
    kw.setdefault("batch_rects", 2)
    kw.setdefault("cap_rects", 4)
    kw.setdefault("queue_len", 50)
    kw.setdefault("uncertain_volume", 1.0)
    return Candidate(session_id=sid, **kw)


def _random_candidates(rng, n):
    """``n`` candidate field dicts drawn from ``rng`` (shared inputs)."""
    out = []
    for i in range(n):
        slack = (math.inf if rng.random() < 0.5
                 else float(rng.uniform(0.0, 1.0)))
        br = int(rng.integers(1, 5))
        out.append(dict(
            session_id=f"s{i}", batch_rects=br,
            cap_rects=br + int(rng.integers(0, 5)),
            queue_len=int(rng.integers(0, 12)),
            uncertain_volume=float(rng.uniform(0.0, 3.0)),
            uncertain_fraction=float(rng.uniform(0.0, 1.2)),
            top_rect_volume=float(rng.uniform(0.0, 1.0)),
            probes=int(rng.integers(0, 400)),
            frontier_points=int(rng.integers(0, 40)),
            gain_ema=float(rng.normal() * 0.1),
            rounds_idle=int(rng.integers(0, 6)),
            slo=str(rng.choice(["interactive", "standard", "batch", "x"])),
            deadline_slack_s=slack,
            wall_ema_s=float(rng.uniform(0.0, 0.5)),
        ))
    return out


def _both(fields):
    return ([J.Candidate(**f) for f in fields],
            [Candidate(**f) for f in fields])


# ---------------------------------------------------------------------------
class TestReferenceParity:
    def test_constants_equal(self):
        assert FEATURE_NAMES == J.FEATURE_NAMES
        assert SLO_URGENCY == J.SLO_URGENCY

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_feature_matrix_equal(self, seed):
        jc, pc = _both(_random_candidates(np.random.default_rng(seed), 7))
        np.testing.assert_array_equal(feature_matrix(pc),
                                      J.feature_matrix(jc))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_uniform_allocations_equal(self, seed):
        jc, pc = _both(_random_candidates(np.random.default_rng(seed), 6))
        assert UniformPolicy().allocate(pc) == J.UniformPolicy().allocate(jc)

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(budget_fraction=0.5, min_rects=2, epsilon=0.3, seed=5),
        dict(budget_fraction=1.0, epsilon=0.0, deadline_guard=4.0, seed=1),
    ])
    def test_bandit_allocate_and_observe_equal(self, kw):
        """Ten rounds of allocate + observe: every allocation (floors,
        deadline guard, caps, epsilon draws) and every weight update equal
        exactly."""
        rng = np.random.default_rng(11)
        jp, pp = J.GainBanditPolicy(**kw), GainBanditPolicy(**kw)
        for _ in range(10):
            jc, pc = _both(_random_candidates(rng, 5))
            assert pp.allocate(pc) == jp.allocate(jc)
            for f in jc:
                probes = int(rng.integers(0, 12))
                dhv = float(rng.normal() * 0.05)
                wall = float(rng.uniform(0.0, 0.2))
                jp.observe(f.session_id, probes, dhv, wall)
                pp.observe(f.session_id, probes, dhv, wall)
            np.testing.assert_array_equal(pp.w, jp.w)
            assert pp.updates == jp.updates
            assert pp._scale == jp._scale


# ---------------------------------------------------------------------------
class TestFeatures:
    def test_bounded_and_aligned(self):
        cands = [
            _cand("a", uncertain_volume=3.0, gain_ema=0.2, probes=100,
                  rounds_idle=5, slo="interactive", deadline_slack_s=0.1),
            _cand("b", uncertain_volume=1.0, gain_ema=0.0, probes=0,
                  slo="batch", deadline_slack_s=math.inf),
        ]
        X = feature_matrix(cands)
        assert X.shape == (2, len(FEATURE_NAMES))
        assert np.all(X >= 0.0) and np.all(X <= 1.0)
        i = FEATURE_NAMES.index("volume_share")
        assert X[0, i] == pytest.approx(0.75)
        assert X[1, i] == pytest.approx(0.25)
        j = FEATURE_NAMES.index("deadline_pressure")
        assert X[1, j] == 0.0 and X[0, j] > 0.9

    def test_empty(self):
        assert feature_matrix([]).shape == (0, len(FEATURE_NAMES))


# ---------------------------------------------------------------------------
class TestUniformParity:
    """UniformPolicy == the policy-free schedule of the port's service."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_randomized_mix_parity(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 5))
        archs = [(8,), (8, 8)]
        picks = [int(rng.integers(0, len(archs))) for _ in range(n)]
        rects = [int(rng.integers(1, 4)) for _ in range(n)]

        def build(policy):
            svc = MOOService(mogd=FAST, grid_l=2, budget_policy=policy,
                             device=CPU)
            sids = []
            for i, (p, br) in enumerate(zip(picks, rects)):
                spec = mlp_surrogate_task(seed=100 + i, d=3, arch=archs[p])
                sids.append(svc.create_session(spec, batch_rects=br))
            return svc, sids

        legacy, l_sids = build(None)
        uniform, u_sids = build(UniformPolicy())
        for ls, us in zip(l_sids, u_sids):
            assert (legacy.session_dispatch_key(ls)
                    == uniform.session_dispatch_key(us))
        remap = dict(zip(u_sids, l_sids))
        for _ in range(4):
            lo = legacy.step_sessions(l_sids, origin=None)
            uo = uniform.step_sessions(u_sids, origin=None)
            assert ({remap[s]: p for s, p in uo["per_session"].items()}
                    == lo["per_session"])
            assert (sorted(remap[s] for s in uo["exhausted"])
                    == sorted(lo["exhausted"]))
            assert uo["batches"] == lo["batches"]
        for ls, us in zip(l_sids, u_sids):
            Fl, Xl = legacy.frontier(ls)
            Fu, Xu = uniform.frontier(us)
            np.testing.assert_array_equal(Fl, Fu)
            np.testing.assert_array_equal(Xl, Xu)

    def test_uniform_allocate_is_batch_rects(self):
        cands = [_cand("a", batch_rects=3), _cand("b", batch_rects=1)]
        assert UniformPolicy().allocate(cands) == {"a": 3, "b": 1}


# ---------------------------------------------------------------------------
class TestGainBandit:
    def test_min_floor_under_one_hot_bandit(self):
        pol = GainBanditPolicy(epsilon=0.0, min_rects=1, seed=0)
        pol.w[:] = 0.0
        pol.w[FEATURE_NAMES.index("volume_share")] = 5.0  # one-hot
        cands = [_cand(f"s{i}", uncertain_volume=(100.0 if i == 0 else 0.01))
                 for i in range(6)]
        alloc = pol.allocate(cands)
        assert all(alloc[c.session_id] >= 1 for c in cands)
        assert alloc["s0"] == max(alloc.values())

    def test_floor_respects_queue_len(self):
        pol = GainBanditPolicy(epsilon=0.0, min_rects=2, seed=0)
        cands = [_cand("a", queue_len=1), _cand("b", queue_len=10)]
        alloc = pol.allocate(cands)
        assert alloc["a"] == 1
        assert alloc["b"] >= 2

    def test_deadline_guard_protects_tight_ticket(self):
        pol = GainBanditPolicy(epsilon=0.0, deadline_guard=2.0, seed=0)
        pol.w[:] = 0.0
        pol.w[FEATURE_NAMES.index("gain_share")] = 5.0
        tight = _cand("tight", batch_rects=3, gain_ema=0.0,
                      deadline_slack_s=0.05, wall_ema_s=0.1)
        hot = _cand("hot", batch_rects=3, gain_ema=1.0)
        alloc = pol.allocate([tight, hot])
        assert alloc["tight"] >= 3
        loose = _cand("loose", batch_rects=3, gain_ema=0.0,
                      deadline_slack_s=5.0, wall_ema_s=0.1)
        alloc2 = pol.allocate([loose, hot])
        assert alloc2["loose"] == 1

    def test_budget_fraction_shrinks_spend(self):
        pol = GainBanditPolicy(budget_fraction=0.5, epsilon=0.0, seed=0)
        cands = [_cand(f"s{i}", batch_rects=4, cap_rects=8)
                 for i in range(4)]
        alloc = pol.allocate(cands)
        assert sum(alloc.values()) <= int(round(0.5 * 16)) or all(
            v == 1 for v in alloc.values())
        assert sum(alloc.values()) < 16

    def test_cap_rects_is_hard(self):
        pol = GainBanditPolicy(budget_fraction=1.0, epsilon=0.0, seed=0)
        cands = [_cand("a", batch_rects=8, cap_rects=2),
                 _cand("b", batch_rects=8, cap_rects=2)]
        alloc = pol.allocate(cands)
        assert all(v <= 2 for v in alloc.values())

    def test_observe_moves_weights_toward_reward(self):
        pol = GainBanditPolicy(epsilon=0.0, lr=0.5, seed=0)
        cands = [_cand("a", gain_ema=1.0), _cand("b", gain_ema=0.0)]
        pol.allocate(cands)
        w0 = pol.w.copy()
        pol.observe("a", probes=8, hv_delta=0.5, wall_s=0.01)
        assert pol.updates == 1
        assert not np.array_equal(pol.w, w0)
        pol.observe("nope", probes=8, hv_delta=0.5, wall_s=0.01)
        pol.observe("b", probes=0, hv_delta=0.5, wall_s=0.01)
        assert pol.updates == 1

    def test_allocation_is_deterministic_for_seed(self):
        def run(seed):
            pol = GainBanditPolicy(epsilon=0.3, seed=seed)
            cands = [_cand(f"s{i}", uncertain_volume=float(i + 1))
                     for i in range(5)]
            return pol.allocate(cands)
        assert run(7) == run(7)


# ---------------------------------------------------------------------------
class TestServiceWiring:
    def test_bandit_never_triggers_fresh_compiles(self):
        svc = MOOService(mogd=FAST, grid_l=2,
                         budget_policy=GainBanditPolicy(seed=0), device=CPU)
        sids = [svc.create_session(
            mlp_surrogate_task(seed=i, d=3, arch=(8,)),
            batch_rects=3) for i in range(4)]
        for _ in range(3):
            svc.step_sessions(sids, origin=None)
        warm = svc.stats()["executor_compiles"]
        for _ in range(5):
            svc.step_sessions(sids, origin=None)
        assert svc.stats()["executor_compiles"] == warm

    def test_budget_stats_and_gain_ema(self):
        svc = MOOService(mogd=FAST, grid_l=2,
                         budget_policy=GainBanditPolicy(seed=0), device=CPU)
        sids = [svc.create_session(zdt1_task(device=CPU), batch_rects=2)
                for _ in range(2)]
        svc.step_sessions(sids, origin=None)
        b = svc.stats()["budget"]
        assert b["policy"] == "gain_bandit"
        assert b["rounds"] >= 1
        assert 0 < b["rects_granted"] <= b["rects_legacy"]
        stepped = [s for s in sids
                   if svc._sessions[s].state.probes > 2]
        assert stepped
        assert any(len(svc._sessions[s].state.gain_log) > 0
                   for s in stepped)

    def test_no_policy_stats_report_none(self):
        svc = MOOService(mogd=FAST, device=CPU)
        assert svc.stats()["budget"]["policy"] is None

    def test_context_deadline_guard_end_to_end(self):
        pol = GainBanditPolicy(epsilon=0.0, seed=0)
        pol.w[:] = 0.0
        pol.w[FEATURE_NAMES.index("gain_share")] = 5.0
        svc = MOOService(mogd=FAST, grid_l=2, budget_policy=pol, device=CPU)
        specs = [mlp_surrogate_task(seed=i, d=3, arch=(8,))
                 for i in range(3)]
        sids = [svc.create_session(s, batch_rects=2) for s in specs]
        svc.step_sessions(sids, origin=None)
        ctx = {sids[0]: {"slo": "interactive", "deadline_slack_s": 0.01,
                         "wall_ema_s": 0.05, "sheddable": True}}
        out = svc.step_sessions(sids, origin=None, context=ctx)
        lk = 2 ** 2
        if sids[0] in out["per_session"]:
            assert out["per_session"][sids[0]] >= 2 * lk
