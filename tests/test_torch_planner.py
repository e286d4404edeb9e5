"""The execution planner and its trace data in the port, against the JAX
reference: the roofline helpers, the sharding rules, plans, the plan
space, the differentiable cost model, ``plan_job``/``plan_dag``/
``replan_elastic``, dry-run harvesting and the registry's ingest bridge.

Tolerances: plans, specs, the plan space, the HLO parse and harvested rows
are compared exactly; ``PlanModel``'s objectives, terms and HBM occupancy
within 1e-5 relative (the reference's fleet constants are the port's
defaults); ``plan_job`` fed the reference's random draws gives a frontier
whose hypervolume is within ±0.5 % of the reference's.  ``logical_spec``
returns a tuple of the reference's ``PartitionSpec`` entries.  The classes
named after reference classes mirror ``tests/test_planner.py``,
``tests/test_launch.py``, ``tests/test_harvest.py``,
``tests/test_modelserver.py::TestIngestBridge`` and
``tests/test_properties.py::TestRooflinePropertes`` on the port alone.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as J
from repro.data import harvest as j_harvest, harvest_all as j_harvest_all
import repro.distributed as JD
import repro.launch.plans as JPL
import repro.launch.roofline as JR
import repro.planner as JP
import repro.planner.planner as JPP
import repro_torch.core as P
import repro_torch.planner.planner as PPP
from repro.core.problem import SpaceEncoder as JSpaceEncoder
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.problem import MOOProblem, SpaceEncoder
from repro_torch.data.harvest import DRYRUN_DIR, _resolve_root, harvest
from repro_torch.distributed import logical_spec
from repro_torch.launch.plans import Plan, apply_plan, baseline_plan, rules_for
from repro_torch.launch.roofline import (
    TPU_V5E,
    CollectiveStats,
    FleetSpec,
    model_flops_for,
    parse_collectives,
    roofline_terms,
    ssm_scan_correction,
)
from repro_torch.modelserver import (
    DRYRUN_OBJECTIVES,
    DriftConfig,
    ModelRegistry,
    TrainerConfig,
    ingest_dryrun,
)
from repro_torch.planner import (
    CHIP_COST_PER_S,
    HBM_BYTES,
    PlanModel,
    decode_plan,
    plan_dag,
    plan_job,
    plan_space,
    replan_elastic,
)

CPU = "cpu"
HV_BAND = 0.005  # ±0.5 % of the reference's HV
ARCHS = ("qwen3-4b", "grok-1-314b", "jamba-v0.1-52b", "rwkv6-3b",
         "qwen2-moe-a2.7b", "musicgen-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakeMeshMP:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


BASE = {
    "num_chips": 256, "model_parallel": 16, "fsdp": True,
    "microbatches": 1, "remat": "dots", "param_dtype": "float32",
    "state_dtype": "float32", "grad_compress": False,
    "moe_impl": "einsum", "attn_chunk": 1024, "seq_shard_all": False,
    "collective_dtype": "float32",
}
KNOBS = {
    "base": BASE,
    "small_bf16": {**BASE, "num_chips": 64, "model_parallel": 2,
                   "fsdp": False, "microbatches": 4, "remat": "full",
                   "param_dtype": "bfloat16", "state_dtype": "bfloat16",
                   "grad_compress": True, "moe_impl": "gather",
                   "seq_shard_all": True, "collective_dtype": "bfloat16"},
    "wide": {**BASE, "num_chips": 512, "model_parallel": 32,
             "microbatches": 8, "remat": "none", "attn_chunk": 4096},
}


def _soft_for(cfg_dict):
    enc = SpaceEncoder(plan_space())
    return enc.decode_soft(torch.as_tensor(enc.encode(cfg_dict),
                                           dtype=torch.float32))


def _j_soft_for(cfg_dict):
    enc = JSpaceEncoder(JP.plan_space())
    return enc.decode_soft(jnp.asarray(enc.encode(cfg_dict)))


def _reference_draws(monkeypatch):
    """The port draws the reference's numbers (``tests/test_torch_dag.py``'s
    helper): MOGD and family-solver starts from the reference solver's key
    stream, problem samples from the reference's ``PRNGKey(seed)``."""

    def replay(self, B, dim):
        key = getattr(self, "_ref_key", None)
        if key is None:
            key = jax.random.PRNGKey(self.config.seed)
        self._ref_key, sub = jax.random.split(key)
        return np.array(jax.random.uniform(
            sub, (B, self.config.multistart, dim)))

    def draw_starts(self, B):
        return replay(self, B, self.problem.dim)

    def family_starts(self, B):
        return replay(self, B, self.family.encoder.dim)

    def sample(self, generator, n):
        u = jax.random.uniform(jax.random.PRNGKey(generator.initial_seed()),
                               (n, self.dim))
        return torch.as_tensor(np.array(u), device=self.device)

    monkeypatch.setattr(P.MOGDSolver, "draw_starts", draw_starts)
    monkeypatch.setattr(P.FamilySolver, "draw_starts", family_starts)
    monkeypatch.setattr(MOOProblem, "sample", sample)


def _hv_pair(Fa, Fb):
    """Both frontiers' HV against one point past both nadirs: 10 % of the
    span, or 0.01 % of the nadir where the span is nil (a frontier of one
    point)."""
    both = np.concatenate([Fa, Fb]).astype(np.float64)
    nadir, utopia = both.max(0), both.min(0)
    point = nadir + 0.1 * np.maximum(nadir - utopia, 1e-3 * np.abs(nadir))
    return J.hypervolume(Fa, point), P.hypervolume(Fb, point)


# ---------------------------------------------------------------------------
# Cross-package: exact parts
# ---------------------------------------------------------------------------


class TestRooflineAgainstReference:
    HLO = """
  %ag = f32[16,4096,1024]{2,1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={2}
  %ar = bf16[16,4096,8192]{2,1,0} all-reduce(%y), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[16,256]{1,0} reduce-scatter(%z), replica_groups=[2,8]<=[16]
  %cp = bf16[8,128]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %a2a = (bf16[4,64]{1,0}, bf16[4,64]{1,0}) all-to-all(%p, %q), replica_groups={{0,1}}
  %ars = f32[1024]{0} all-reduce-start(%v), replica_groups=[32,8]<=[256]
  %add = f32[8]{0} add(%a, %b)
"""

    @pytest.mark.parametrize("default_group", [1, 16, 256])
    def test_parse_collectives_equal(self, default_group):
        a = parse_collectives(self.HLO, default_group)
        b = JR.parse_collectives(self.HLO, default_group)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)

    def test_constants_are_the_references(self):
        assert (TPU_V5E.peak_flops, TPU_V5E.hbm_bw, TPU_V5E.ici_bw) == (
            JR.PEAK_FLOPS, JR.HBM_BW, JR.ICI_BW)
        assert (CHIP_COST_PER_S, HBM_BYTES) == (JP.CHIP_COST_PER_S,
                                                JP.HBM_BYTES)

    @pytest.mark.parametrize("chips,flops,nbytes,wire", [
        (256, 3.9e14, 8e11, 5e10), (64, 1e9, 1e13, 0.0), (1, 0.0, 0.0, 0.0)])
    def test_roofline_terms_equal(self, chips, flops, nbytes, wire):
        cost = {"flops": flops, "bytes accessed": nbytes}
        a = roofline_terms(cost, CollectiveStats(wire_bytes=wire), chips,
                           model_flops=1e15)
        b = JR.roofline_terms(cost, JR.CollectiveStats(wire_bytes=wire),
                              chips, model_flops=1e15)
        assert a.to_dict() == b.to_dict()

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                       "decode_32k", "long_500k"])
    def test_ssm_correction_and_model_flops_equal(self, arch, shape):
        mesh = {"pod": 2, "data": 16, "model": 16}
        cfg, jcfg = get_config(arch), JC.get_config(arch)
        assert ssm_scan_correction(cfg, SHAPES[shape], mesh) == \
            JR.ssm_scan_correction(jcfg, JC.SHAPES[shape], mesh)
        assert model_flops_for(cfg, SHAPES[shape]) == \
            JR.model_flops_for(jcfg, JC.SHAPES[shape])


class TestPlansAgainstReference:
    LOGICAL = (("batch", "seq", "embed"), ("d_model", "d_ff"),
               ("vocab", "d_model"), ("layers", "d_model", "heads"),
               ("expert", "d_model", "expert_ff"), ("batch", "seq_shard"),
               ("attn_batch", "heads", None), ("d_inner", "d_state"),
               ("rwkv_heads", "kv_fused"))
    SHAPES_OF = ((256, 4096, 2560), (8192, 28672), (151936, 2560),
                 (36, 2560, 32), (60, 2048, 1408), (128, 32768),
                 (32, 24, 7), (8192, 16), (40, 1024))

    @pytest.mark.parametrize("arch", ARCHS + ("internvl2-76b",))
    @pytest.mark.parametrize("shape", ["train_4k", "decode_32k",
                                       "long_500k"])
    def test_baseline_plan_and_apply_equal(self, arch, shape):
        cfg, jcfg = get_config(arch), JC.get_config(arch)
        plan = baseline_plan(cfg, SHAPES[shape])
        jplan = JPL.baseline_plan(jcfg, JC.SHAPES[shape])
        assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
        for p, jp in ((plan, jplan),
                      (Plan(remat="full", moe_impl="gather", moe_group=256),
                       JPL.Plan(remat="full", moe_impl="gather",
                                moe_group=256))):
            got, want = apply_plan(cfg, p), JPL.apply_plan(jcfg, jp)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)

    @pytest.mark.parametrize("arch", ARCHS + ("internvl2-76b",))
    @pytest.mark.parametrize("mesh", [FakeMesh, FakeMeshMP])
    @pytest.mark.parametrize("plan_kw", [
        {}, {"fsdp": False, "seq_shard_all": True},
        {"pure_dp": True, "fsdp_span": "all"}, {"pure_dp": True}])
    def test_rules_and_specs_equal(self, arch, mesh, plan_kw):
        cfg, jcfg = get_config(arch), JC.get_config(arch)
        for shape in ("train_4k", "decode_32k"):
            rules = rules_for(cfg, SHAPES[shape], mesh(), Plan(**plan_kw))
            jrules = JPL.rules_for(jcfg, JC.SHAPES[shape], mesh(),
                                   JPL.Plan(**plan_kw))
            assert dict(rules.table) == dict(jrules.table)
            for name in JD.LOGICAL_DEFAULTS:
                assert rules.physical(name) == jrules.physical(name)
            for axes, dims in zip(self.LOGICAL, self.SHAPES_OF):
                assert logical_spec(rules, axes, dims) == tuple(
                    JD.logical_spec(jrules, axes, dims))

    def test_plan_space_and_decode_equal(self):
        assert [dataclasses.asdict(s) for s in plan_space()] == \
            [dataclasses.asdict(s) for s in JP.plan_space()]
        for knobs in KNOBS.values():
            plan, chips, tp = decode_plan(knobs)
            jplan, jchips, jtp = JP.decode_plan(knobs)
            assert (dataclasses.asdict(plan), chips, tp) == (
                dataclasses.asdict(jplan), jchips, jtp)


# ---------------------------------------------------------------------------
# Cross-package: the cost model and the planner
# ---------------------------------------------------------------------------


class TestCostModelAgainstReference:
    @pytest.mark.parametrize("arch", ["qwen3-4b", "grok-1-314b",
                                      "jamba-v0.1-52b", "rwkv6-3b",
                                      "qwen2-moe-a2.7b"])
    @pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                       "decode_32k"])
    @pytest.mark.parametrize("knobs", sorted(KNOBS))
    def test_objectives_terms_occupancy(self, arch, shape, knobs):
        m = PlanModel(get_config(arch), SHAPES[shape])
        jm = JP.PlanModel(JC.get_config(arch), JC.SHAPES[shape])
        soft, jsoft = _soft_for(KNOBS[knobs]), _j_soft_for(KNOBS[knobs])
        np.testing.assert_allclose(m.objectives(soft).numpy(),
                                   np.asarray(jm.objectives(jsoft)),
                                   rtol=1e-5)
        got = [float(t) for t in m.terms(soft)]
        want = [float(t) for t in jm.terms(jsoft)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(float(m.hbm_occupancy(soft)),
                                   float(jm.hbm_occupancy(jsoft)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m.latency(soft)),
                                   float(jm.latency(jsoft)), rtol=1e-5)

    @pytest.mark.parametrize("arch", ["qwen3-4b", "grok-1-314b"])
    def test_gradient_equals_reference(self, arch):
        """The relaxed point's latency gradient, autograd against
        ``jax.grad``, at a point inside the simplex faces."""
        x = SpaceEncoder(plan_space()).encode(BASE) * 0.9 + 0.03
        m = PlanModel(get_config(arch), SHAPES["train_4k"])
        jm = JP.PlanModel(JC.get_config(arch), JC.SHAPES["train_4k"])
        enc, jenc = SpaceEncoder(plan_space()), JSpaceEncoder(JP.plan_space())
        g = torch.func.grad(lambda v: m.objectives(enc.decode_soft(v))[0])(
            torch.as_tensor(x, dtype=torch.float32))
        jg = jax.grad(lambda v: jm.objectives(jenc.decode_soft(v))[0])(
            jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(jg).max()))

    def test_calibrate_equal(self):
        art = {"roofline": {"compute_s": 0.5, "memory_s": 0.8,
                            "collective_s": 0.3}}
        m = PlanModel(get_config("qwen3-4b"), SHAPES["train_4k"])
        jm = JP.PlanModel(JC.get_config("qwen3-4b"), JC.SHAPES["train_4k"])
        a = m.calibrate(art, _soft_for(BASE))
        b = jm.calibrate(art, _j_soft_for(BASE))
        for f in ("cal_compute", "cal_memory", "cal_collective"):
            assert isinstance(getattr(a, f), float)
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-5)


class TestPlannerAgainstReference:
    @pytest.mark.parametrize("arch,shape", [("qwen3-4b", "train_4k"),
                                            ("grok-1-314b", "train_4k"),
                                            ("rwkv6-3b", "decode_32k")])
    def test_plan_job_frontier_hv(self, monkeypatch, arch, shape):
        _reference_draws(monkeypatch)
        monkeypatch.setattr(PPP, "_PF_CACHE", {})
        monkeypatch.setattr(JPP, "_PF_CACHE", {})
        kw = dict(n_probes=8, deadline_s=None)
        want = JP.plan_job(JC.get_config(arch), shape, **kw)
        got = plan_job(get_config(arch), shape, **kw, device=CPU)
        if got.frontier_F.shape == want.frontier_F.shape:
            np.testing.assert_allclose(np.sort(got.frontier_F, axis=0),
                                       np.sort(want.frontier_F, axis=0),
                                       rtol=1e-5)
        hv_ref, hv_port = _hv_pair(want.frontier_F, got.frontier_F)
        assert hv_ref > 0.0
        assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)

    def test_restricted_chip_projection_equals_reference(self):
        """The elastic task's objective (chip weights re-expressed over the
        canonical choices) at the same relaxed points."""
        cfg, jcfg = get_config("qwen3-4b"), JC.get_config("qwen3-4b")
        spec, _ = PPP.plan_task(cfg, SHAPES["train_4k"],
                                chip_choices=[64, 128],
                                shape_name="train_4k", device=CPU)
        jspec, _ = JPP.plan_task(jcfg, JC.SHAPES["train_4k"],
                                 chip_choices=[64, 128],
                                 shape_name="train_4k")
        dim = SpaceEncoder(spec.knobs).dim
        X = np.random.default_rng(0).uniform(0.05, 0.95, (6, dim))
        got = torch.func.vmap(spec.model)(torch.as_tensor(X,
                                                          dtype=torch.float32))
        want = jax.vmap(jspec.model)(jnp.asarray(X))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    def test_plan_dag_equals_reference_composition(self, monkeypatch):
        """plan_dag on a 3-stage job: the composed frontier's HV within the
        band of the reference's, on its draws."""
        _reference_draws(monkeypatch)

        def job(mod, **kw):
            fam = mod.make_analytics_family(**kw)
            stages = [fam.stage("a", (2.0, 0.3, 0.5, 0.6)),
                      fam.stage("b", (3.0, 0.2, 0.9, 0.8)),
                      fam.stage("c", (1.0, 0.4, 0.2, 0.4))]
            return mod.JobDAG(stages, (("a", "b"), ("a", "c")), name="j3")

        mogd = dict(steps=40, multistart=4)
        want = JP.plan_dag(job(J), n_probes_per_stage=8,
                           mogd=J.MOGDConfig(**mogd))
        got = plan_dag(job(P, device=CPU), n_probes_per_stage=8,
                       mogd=P.MOGDConfig(**mogd), use_kernel=True,
                       device=CPU)
        assert set(got.stage_configs) == {"a", "b", "c"}
        assert got.probes == want.probes
        if got.frontier_F.shape == want.frontier_F.shape:
            np.testing.assert_allclose(np.sort(got.frontier_F, axis=0),
                                       np.sort(want.frontier_F, axis=0),
                                       rtol=1e-5)
        hv_ref, hv_port = _hv_pair(want.frontier_F, got.frontier_F)
        assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)


# ---------------------------------------------------------------------------
# Mirror of tests/test_planner.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    return get_config("qwen3-4b")


@pytest.fixture(scope="module")
def grok():
    return get_config("grok-1-314b")


class TestCostModel:
    def test_more_chips_faster_costlier_at_floor(self, qwen):
        m = PlanModel(qwen, SHAPES["train_4k"])
        lo = m.objectives(_soft_for({**BASE, "num_chips": 64}))
        hi = m.objectives(_soft_for({**BASE, "num_chips": 512}))
        assert hi[0] < lo[0]  # latency improves with chips

    def test_bf16_states_shrink_occupancy(self, grok):
        m = PlanModel(grok, SHAPES["train_4k"])
        occ32 = m.hbm_occupancy(_soft_for(BASE))
        occ16 = m.hbm_occupancy(_soft_for({**BASE, "state_dtype": "bfloat16",
                                           "param_dtype": "bfloat16"}))
        assert occ16 < occ32
        # grok-1 with fp32 Adam does not fit the default fleet; bf16 helps
        assert occ32 > HBM_BYTES

    def test_remat_tradeoff(self, qwen):
        m = PlanModel(qwen, SHAPES["train_4k"])
        none = m.terms(_soft_for({**BASE, "remat": "none"}))
        full = m.terms(_soft_for({**BASE, "remat": "full"}))
        assert full[0] > none[0]       # full remat costs compute
        assert m.hbm_occupancy(_soft_for({**BASE, "remat": "full"})) < \
            m.hbm_occupancy(_soft_for({**BASE, "remat": "none"}))

    def test_grad_compress_cuts_collective(self, qwen):
        m = PlanModel(qwen, SHAPES["train_4k"])
        a = m.terms(_soft_for(BASE))[2]
        b = m.terms(_soft_for({**BASE, "grad_compress": True}))[2]
        assert b < a

    def test_differentiable(self, qwen):
        m = PlanModel(qwen, SHAPES["train_4k"])
        enc = SpaceEncoder(plan_space())
        x0 = torch.as_tensor(enc.encode(BASE), dtype=torch.float32) + 0.01

        def lat(x):
            return m.objectives(enc.decode_soft(x))[0]

        g = torch.func.grad(lat)(x0)
        assert torch.isfinite(g).all()
        assert float(g.abs().sum()) > 0

    def test_calibration_matches_artifact(self, qwen):
        m = PlanModel(qwen, SHAPES["train_4k"])
        artifact = {"roofline": {"compute_s": 0.5, "memory_s": 0.8,
                                 "collective_s": 0.3}}
        soft = _soft_for(BASE)
        m2 = m.calibrate(artifact, soft)
        c, mem, n, _, _ = m2.terms(soft)
        np.testing.assert_allclose([float(c), float(mem), float(n)],
                                   [0.5, 0.8, 0.3], rtol=1e-5)

    def test_fleet_is_a_parameter(self, qwen):
        """A fleet twice as fast everywhere halves every term; its price
        scales the cost and its memory size the overflow penalty."""
        soft = _soft_for(BASE)
        m = PlanModel(qwen, SHAPES["train_4k"])
        fast = FleetSpec(peak_flops=2 * TPU_V5E.peak_flops,
                         hbm_bw=2 * TPU_V5E.hbm_bw,
                         ici_bw=2 * TPU_V5E.ici_bw,
                         chip_cost_per_s=2 * TPU_V5E.chip_cost_per_s,
                         hbm_bytes=TPU_V5E.hbm_bytes)
        m2 = dataclasses.replace(m, fleet=fast)
        for a, b in zip(m.terms(soft)[:3], m2.terms(soft)[:3]):
            np.testing.assert_allclose(float(b), float(a) / 2, rtol=1e-6)
        o, o2 = m.objectives(soft), m2.objectives(soft)
        np.testing.assert_allclose(float(o2[1]), float(o[1]), rtol=1e-5)


class TestPlanSpace:
    def test_decode_roundtrip(self):
        plan, chips, tp = decode_plan(BASE)
        assert isinstance(plan, Plan)
        assert chips == 256 and tp == 16
        assert plan.remat == "dots" and plan.fsdp is True


class TestPlanJob:
    def test_planner_returns_valid_plan(self, qwen):
        rec = plan_job(qwen, "train_4k", n_probes=8, deadline_s=None,
                       device=CPU)
        assert rec.num_chips in (64, 128, 256, 512)
        assert rec.model_parallel in (1, 2, 4, 8, 16, 32)
        assert len(rec.frontier_F) >= 1
        assert np.isfinite(rec.objectives).all()

    def test_weights_steer_recommendation(self, qwen):
        lat = plan_job(qwen, "train_4k", weights=(0.95, 0.05), n_probes=12,
                       deadline_s=None, device=CPU)
        cost = plan_job(qwen, "train_4k", weights=(0.05, 0.95), n_probes=12,
                        deadline_s=None, device=CPU)
        assert lat.objectives[0] <= cost.objectives[0] + 1e-9

    def test_elastic_respects_capacity(self, qwen):
        rec = replan_elastic(qwen, "train_4k", surviving_chips=200,
                             deadline_s=None, device=CPU)
        assert rec.num_chips <= 200

    def test_incremental_resume(self, qwen):
        rec = plan_job(qwen, "train_4k", n_probes=6, deadline_s=None,
                       device=CPU)
        rec2 = plan_job(qwen, "train_4k", n_probes=6, deadline_s=None,
                        state=rec.pf_state, device=CPU)
        assert len(rec2.frontier_F) >= len(rec.frontier_F) - 2

    def test_budget_cap_honored(self, qwen):
        free = plan_job(qwen, "train_4k", n_probes=12, deadline_s=None,
                        device=CPU)
        cap = float(np.median(free.frontier_F[:, 1]))
        capped = plan_job(qwen, "train_4k", n_probes=12, deadline_s=None,
                          objective_bounds={"cost": (None, cap)},
                          device=CPU)
        assert len(capped.frontier_F) >= 1
        assert np.all(capped.frontier_F[:, 1] <= cap * (1 + 1e-6))
        with pytest.raises(ValueError, match="unknown objectives"):
            plan_job(qwen, "train_4k", objective_bounds={"energy": (0, 1)},
                     device=CPU)

    def test_solver_cache_keys_the_device(self, qwen):
        plan_job(qwen, "train_4k", n_probes=4, deadline_s=None, device=CPU)
        keys = [k for k in PPP._PF_CACHE if k[1] == "cpu"]
        assert keys and all(len(k) == 5 for k in keys)
        problem, pf = PPP._PF_CACHE[keys[-1]]
        assert problem.device.type == "cpu" and pf.device.type == "cpu"

    @pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
    def test_default_device_is_cuda(self, qwen):
        with pytest.raises(RuntimeError):
            plan_job(qwen, "train_4k", n_probes=4)

    def test_dag_in_place_of_arch(self):
        fam = P.make_analytics_family(device=CPU)
        dag = P.JobDAG([fam.stage("a", (2.0, 0.3, 0.5, 0.6)),
                        fam.stage("b", (1.0, 0.2, 0.9, 0.8))],
                       (("a", "b"),), name="j2")
        rec = plan_job(dag, n_probes=6, deadline_s=None,
                       mogd=P.MOGDConfig(steps=30, multistart=4), device=CPU)
        assert set(rec.stage_configs) == {"a", "b"}
        assert bool(P.pareto_mask(rec.frontier_F).all())
        with pytest.raises(ValueError, match="do not apply"):
            plan_job(dag, chip_choices=[64], device=CPU)


# ---------------------------------------------------------------------------
# Mirror of tests/test_launch.py
# ---------------------------------------------------------------------------


class TestPlans:
    def test_baseline_kinds(self):
        cfg = get_config("qwen3-4b")
        tr = baseline_plan(cfg, SHAPES["train_4k"])
        assert tr.fsdp and tr.remat == "dots" and tr.param_dtype == "float32"
        de = baseline_plan(cfg, SHAPES["decode_32k"])
        assert not de.fsdp and de.param_dtype == "bfloat16"
        lo = baseline_plan(cfg, SHAPES["long_500k"])
        assert lo.seq_shard_all

    def test_apply_plan_threads_knobs(self):
        cfg = get_config("qwen2-moe-a2.7b")
        out = apply_plan(cfg, Plan(remat="full", moe_impl="gather",
                                   moe_group=256))
        assert out.remat == "full" and out.moe_impl == "gather"
        assert out.moe.group_size == 256

    def test_moe_fallback_rules(self):
        cfg = get_config("qwen2-moe-a2.7b")  # 60 experts % 16 != 0
        rules = rules_for(cfg, SHAPES["train_4k"], FakeMesh(), Plan())
        assert rules.physical("expert") == ()
        assert rules.physical("expert_ff") == ("model",)
        jam = get_config("jamba-v0.1-52b")  # 16 experts divide => EP kept
        rules2 = rules_for(jam, SHAPES["train_4k"], FakeMesh(), Plan())
        assert rules2.physical("expert") == ("model",)

    def test_head_fallback_rules(self):
        mg = get_config("musicgen-medium")  # 24 heads % 16 != 0
        rules = rules_for(mg, SHAPES["train_4k"], FakeMesh(), Plan())
        assert rules.physical("attn_batch") == ("data", "model")
        ok = get_config("qwen3-4b")  # 32 heads divide
        rules2 = rules_for(ok, SHAPES["train_4k"], FakeMesh(), Plan())
        assert rules2.physical("attn_batch") == ("data",)

    def test_pure_dp_rules(self):
        cfg = get_config("internvl2-76b")
        rules = rules_for(cfg, SHAPES["train_4k"], FakeMeshMP(),
                          Plan(pure_dp=True, fsdp_span="all"))
        assert rules.physical("batch") == ("pod", "data", "model")
        assert rules.physical("d_ff") == ()
        assert rules.physical("d_model") == ("data", "model")
        # weight spec: FSDP over data+model on the d_model dim
        spec = logical_spec(rules, ("d_model", "d_ff"), (8192, 28672))
        assert spec == (("data", "model"), None)


class TestRooflineHelpers:
    HLO = TestRooflineAgainstReference.HLO.split("  %a2a")[0]

    def test_parse_collectives(self):
        st = parse_collectives(self.HLO, default_group=256)
        assert st.counts == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "collective-permute": 1}
        ag = 16 * 4096 * 1024 * 4 * (15 / 16)
        ar = 16 * 4096 * 8192 * 2 * 2 * (3 / 4)
        rs = 16 * 256 * 4 * 7
        cp = 8 * 128 * 2
        assert np.isclose(st.wire_bytes, ag + ar + rs + cp, rtol=1e-6)

    def test_roofline_terms_bottleneck(self):
        st = CollectiveStats(wire_bytes=50e9)  # exactly 1 s of ICI
        rf = roofline_terms({"flops": 197e12 * 2, "bytes accessed": 819e9},
                            st, chips=256, model_flops=197e12 * 2 * 256)
        assert rf.compute_s == pytest.approx(2.0)
        assert rf.memory_s == pytest.approx(1.0)
        assert rf.collective_s == pytest.approx(1.0)
        assert rf.bottleneck == "compute"
        assert rf.useful_ratio == pytest.approx(1.0)

    def test_ssm_correction_only_for_ssm(self):
        mesh = {"data": 16, "model": 16}
        dense = get_config("qwen3-4b")
        assert ssm_scan_correction(dense, SHAPES["train_4k"], mesh) == (0, 0)
        rwkv = get_config("rwkv6-3b")
        f, b = ssm_scan_correction(rwkv, SHAPES["train_4k"], mesh)
        assert f > 0 and b > 0
        # decode touches the state once per layer, not per token
        f1, b1 = ssm_scan_correction(rwkv, SHAPES["decode_32k"], mesh)
        assert b1 < b / 1000

    def test_model_flops(self):
        cfg = get_config("qwen3-4b")
        tr = model_flops_for(cfg, SHAPES["train_4k"])
        pf = model_flops_for(cfg, SHAPES["prefill_32k"])
        de = model_flops_for(cfg, SHAPES["decode_32k"])
        n = cfg.param_count(active_only=True)
        assert tr == pytest.approx(6 * n * SHAPES["train_4k"].tokens)
        assert pf == pytest.approx(2 * n * SHAPES["prefill_32k"].tokens)
        assert de == pytest.approx(2 * n * 128)


class TestRooflinePropertes:
    """``tests/test_properties.py``'s roofline properties, on seeded
    draws of the same ranges."""

    @pytest.mark.parametrize("seed", range(8))
    def test_bottleneck_is_argmax(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(8):
            flops = float(rng.uniform(1e9, 1e16))
            nbytes = float(rng.uniform(1e6, 1e13))
            wire = float(rng.uniform(0, 1e13))
            rf = roofline_terms({"flops": flops, "bytes accessed": nbytes},
                                CollectiveStats(wire_bytes=wire), chips=256)
            terms = {"compute": rf.compute_s, "memory": rf.memory_s,
                     "collective": rf.collective_s}
            assert rf.bottleneck == max(terms, key=terms.get)

    @pytest.mark.parametrize("n_ops", [1, 2, 7, 64])
    def test_collective_parse_scales_with_count(self, n_ops):
        line = ("  %ar = f32[64,128]{1,0} all-reduce(%x), "
                "replica_groups=[16,16]<=[256], to_apply=%add\n")
        st_ = parse_collectives(line * n_ops, default_group=256)
        assert st_.counts.get("all-reduce", 0) == n_ops
        one = parse_collectives(line, default_group=256).wire_bytes
        assert np.isclose(st_.wire_bytes, n_ops * one)


# ---------------------------------------------------------------------------
# Mirror of tests/test_harvest.py and TestIngestBridge
# ---------------------------------------------------------------------------


def _fake_artifact(tmp_path, arch, shape, tag, terms, plan=None):
    rec = {
        "arch": arch, "shape": shape, "mesh": "16x16", "chips": 256,
        "plan": plan or {"fsdp": True, "remat": "dots",
                         "param_dtype": "float32",
                         "state_dtype": "float32", "microbatches": 1,
                         "moe_impl": "einsum", "attn_chunk": 1024,
                         "seq_shard_all": False, "pure_dp": False,
                         "grad_reduce_dtype": "float32"},
        "roofline": {"compute_s": terms[0], "memory_s": terms[1],
                     "collective_s": terms[2]},
    }
    name = f"{arch}__{shape}__16x16" + (f"__{tag}" if tag else "")
    (tmp_path / f"{name}.json").write_text(json.dumps(rec))


OPT_PLAN = {"fsdp": True, "remat": "none", "param_dtype": "bfloat16",
            "state_dtype": "bfloat16", "microbatches": 2,
            "moe_impl": "gather", "attn_chunk": 2048, "seq_shard_all": True,
            "pure_dp": True, "grad_reduce_dtype": "bfloat16"}


class TestHarvest:
    def test_root_argument_threading(self, tmp_path):
        """Explicit roots (str or Path) are honored; the cwd-relative
        default is kept when omitted."""
        assert _resolve_root(None) == DRYRUN_DIR
        assert _resolve_root(str(tmp_path)) == tmp_path
        assert _resolve_root(tmp_path) == tmp_path
        assert isinstance(_resolve_root(str(tmp_path)), pathlib.Path)
        _fake_artifact(tmp_path, "a", "train_4k", "", (1.0, 2.0, 3.0))
        X, Y, _ = harvest("a", "train_4k", directory=str(tmp_path))
        assert X.shape[0] == 1  # str roots work end-to-end

    def test_rows_and_encoding(self, tmp_path):
        _fake_artifact(tmp_path, "a", "train_4k", "", (1.0, 2.0, 3.0))
        _fake_artifact(tmp_path, "a", "train_4k", "opt", (0.5, 1.0, 1.5),
                       plan=OPT_PLAN)
        X, Y, tags = harvest("a", "train_4k", tmp_path)
        assert X.shape[0] == 2 and Y.shape == (2, 3)
        assert tags == ["baseline", "opt"]
        assert not np.allclose(X[0], X[1])  # different plans encode apart
        np.testing.assert_allclose(Y[0], [1.0, 2.0, 3.0])

    def test_rows_equal_reference(self, tmp_path):
        _fake_artifact(tmp_path, "a", "train_4k", "", (1.0, 2.0, 3.0))
        _fake_artifact(tmp_path, "a", "train_4k", "opt", (0.5, 1.0, 1.5),
                       plan=OPT_PLAN)
        _fake_artifact(tmp_path, "b", "decode_32k", "x", (0.1, 0.2, 0.3))
        for (X, Y, tags), (JX, JY, jtags) in zip(
                (harvest("a", "train_4k", tmp_path),
                 harvest("b", "decode_32k", tmp_path)),
                (j_harvest("a", "train_4k", tmp_path),
                 j_harvest("b", "decode_32k", tmp_path))):
            np.testing.assert_array_equal(X, JX)
            np.testing.assert_array_equal(Y, JY)
            assert tags == jtags
        from repro_torch.data import harvest_all

        got, want = harvest_all(tmp_path), j_harvest_all(tmp_path)
        assert sorted(got) == sorted(want) == [("a", "train_4k"),
                                               ("b", "decode_32k")]

    def test_surrogate_fits_harvested_terms(self, tmp_path):
        from repro_torch.models import TrainConfig, fit_mlp

        rng = np.random.default_rng(0)
        for i in range(12):
            remat = ["none", "dots", "full"][i % 3]
            mem = {"none": 1.0, "dots": 2.0, "full": 3.0}[remat]
            _fake_artifact(
                tmp_path, "a", "train_4k", f"v{i}",
                (1.0, mem + 0.01 * rng.normal(), 1.0),
                plan={"fsdp": True, "remat": remat,
                      "param_dtype": "float32", "state_dtype": "float32",
                      "microbatches": 1, "moe_impl": "einsum",
                      "attn_chunk": 1024, "seq_shard_all": False,
                      "pure_dp": False, "grad_reduce_dtype": "float32"})
        X, Y, _ = harvest("a", "train_4k", tmp_path)
        reg = fit_mlp(X, Y[:, 1], hidden=(32, 32),
                      config=TrainConfig(max_epochs=150, val_frac=0.25),
                      device=CPU)
        pred = reg(torch.as_tensor(X, dtype=torch.float32)).detach().numpy()
        # surrogate recovers the remat -> memory-term relationship
        assert np.corrcoef(pred, Y[:, 1])[0, 1] > 0.9


class TestIngestBridge:
    def test_ingest_dryrun_from_explicit_root(self, tmp_path):
        rec = {
            "arch": "a", "shape": "train_4k", "mesh": "16x16",
            "plan": {"fsdp": True, "remat": "dots",
                     "param_dtype": "float32", "state_dtype": "float32",
                     "microbatches": 1, "moe_impl": "einsum",
                     "attn_chunk": 1024, "seq_shard_all": False,
                     "pure_dp": False, "grad_reduce_dtype": "float32"},
            "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                         "collective_s": 3.0},
        }
        (tmp_path / "a__train_4k__16x16.json").write_text(json.dumps(rec))
        rec2 = dict(rec, roofline={"compute_s": 0.5, "memory_s": 1.0,
                                   "collective_s": 1.5})
        rec2["plan"] = dict(rec["plan"], remat="none")
        (tmp_path / "a__train_4k__16x16__opt.json").write_text(
            json.dumps(rec2))
        reg = ModelRegistry(
            trainer=TrainerConfig(hidden=(24, 24), max_epochs=30, seed=0),
            drift=DriftConfig(window=16, min_obs=8, mult=3.0, floor=0.1),
            trim_on_drift=16, device=CPU)
        sig, n = ingest_dryrun(reg, "a", "train_4k", root=tmp_path)
        assert n == 2
        info = reg.info(sig)
        assert info["traces"] == 2 and info["version"] == 0
        assert tuple(DRYRUN_OBJECTIVES) == ("compute_s", "memory_s",
                                            "collective_s")
        # idempotent registration, appending rows
        sig2, n2 = ingest_dryrun(reg, "a", "train_4k", root=tmp_path)
        assert sig2 == sig and reg.info(sig)["traces"] == 4
        # the empty cell registers without rows
        sig3, n3 = ingest_dryrun(reg, "none", "train_4k", root=tmp_path)
        assert n3 == 0 and sig3 != sig
