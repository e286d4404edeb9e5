"""The port's distribution layer against the JAX package, on the CPU.

* Logical specs, int8 quantization and the probe partitioning policy: the
  cases of ``tests/test_distributed.py::{TestLogicalSpec, TestQuantize}``
  and ``tests/test_mogd_descend.py::TestPartitionPolicy``, with the
  reference's answers computed beside the port's.
* Spec trees, DTensor placements and the logical-axes trees:
  ``spec_tree`` of every architecture's parameters equal to the
  reference's (the reference's block leaves carry a leading ``"layers"``
  dim, replicated, that the port's per-unit leaves do not);
  ``param_axes``, ``cache_axes`` and ``input_specs`` equal to the
  reference's leaf for leaf, in shape and dtype.
* The probe mesh in the executor (``tests/test_executor.py::
  TestMeshPath``): a one-device mesh is a no-op (rtol 1e-6); an 8-shard
  host mesh ``(cpu,)*8`` gives the unsharded result within 1e-5 (x and
  f), feasibility equal, on the row axis (one session's boxes) and on the
  group axis (many tenants coalesced).
* Eight gloo ranks in subprocesses (``tests/torch_dist_ranks.py``) hold
  the contracts of ``TestMultiDevice`` and ``tests/test_serving_sharded.
  py`` port against port: the compressed all-reduce at relative error
  < 0.03 with a nonzero residual; a qwen3-4b smoke train step sharded
  against unsharded (loss and parameters within 5e-2); mistral-nemo
  prefill and decode, rwkv6-3b and Jamba prefill within 0.05 x the logit
  scale (Jamba in bf16 with its MoE layers once its routing choices are
  pinned to the unsharded run's; the flips are counted).  The port's unsharded step is held to the reference's at
  ``tests/test_torch_training.py``'s fp32 parity tolerances.
* The sharded MoE on the ``(2, 4)`` mesh (``MOE_CASES``): Jamba (4
  experts) and qwen2-moe (8) on the EP route, qwen2-moe under the
  ``expert=(), expert_ff=("model",)`` override on the TP route, and the
  capacity-drop config on both routes through the scatter/gather
  dispatch.  From the reference's weights (written as numpy here,
  converted by ``nn.convert`` in each rank), fp32 prefill and decode
  logits within 1e-5 relative of the port's unsharded call and within
  0.05 x the scale of the reference's unsharded logits; each rank holds
  E/4 experts (EP) or ``expert_ff``/4 (TP); one sharded MoE call's only
  collective is the all-reduce of its output (no all-gather of an expert
  weight).  qwen2-moe train steps on both routes at the qwen3-4b step's
  bars, the expert weights' placements kept.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import nn as rnn
from repro import training as rtraining
from repro.distributed import logical_spec as r_logical_spec
from repro.distributed import quantize_int8 as r_quantize_int8
from repro.distributed import ShardingRules as RRules
from repro.distributed import spec_tree as r_spec_tree
from repro.distributed.sharding import (
    choose_probe_partition as r_choose_probe_partition,
)
from repro.launch import plans as rplans
from repro_torch import configs as pconfigs
from repro_torch import nn as pnn
from repro_torch import training as ptraining
from repro_torch.core import MOGDConfig
from repro_torch.core.mogd import (
    MOGDSolver,
    estimate_objective_bounds,
    solve_grouped,
)
from repro_torch.core.synthetic import make_zdt1, mlp_surrogate_task
from repro_torch.distributed import (
    ProbeMesh,
    ShardingRules,
    choose_probe_partition,
    dequantize_int8,
    logical_spec,
    named_sharding_tree,
    probe_mesh,
    quantize_int8,
    spec_tree,
)
from repro_torch.exec import ProbeExecutor
from repro_torch.launch import plans as pplans
from repro_torch.nn.convert import params_from_numpy
from repro_torch.nn.moe import expert_capacity

CPU = "cpu"
FAST = MOGDConfig(steps=40, multistart=4)
RANKS = os.path.join(os.path.dirname(__file__), "torch_dist_ranks.py")


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(mesh_cls=FakeMesh, **over):
    return (ShardingRules(mesh_cls()).with_overrides(**over),
            RRules(mesh_cls()).with_overrides(**over))


# ---------------------------------------------------------------------------
# Logical specs (tests/test_distributed.py::TestLogicalSpec)
# ---------------------------------------------------------------------------


class TestLogicalSpec:
    @pytest.mark.parametrize("axes,shape,want", [
        (("d_model", "d_ff"), (1024, 4096), (None, "model")),
        # 60 experts on a 16-wide axis => replicate
        (("expert", None, None), (60, 4, 4), (None, None, None))])
    def test_divisible_and_fallback(self, axes, shape, want):
        p, r = _both()
        got = logical_spec(p, axes, shape)
        assert got == want == tuple(r_logical_spec(r, axes, shape))

    def test_axis_used_once(self):
        p, r = _both(d_model=("data",), d_model_out=("data",))
        spec = logical_spec(p, ("d_model", "d_model_out"), (256, 256))
        assert spec == ("data", None)  # second use of data blocked
        assert spec == tuple(r_logical_spec(
            r, ("d_model", "d_model_out"), (256, 256)))

    @pytest.mark.parametrize("batch,want", [
        (64, (("pod", "data"), None)),
        (1, (None, None))])  # batch=1 (long_500k): replicated
    def test_multi_axis_batch(self, batch, want):
        p, r = _both(FakePodMesh)
        got = logical_spec(p, ("batch", None), (batch, 7))
        assert got == want == tuple(r_logical_spec(r, ("batch", None),
                                                   (batch, 7)))


class TestQuantize:
    def test_roundtrip_small(self):
        x = np.linspace(-3, 3, 128).astype(np.float32)
        q, s = quantize_int8(torch.tensor(x))
        rt = dequantize_int8(q, s).numpy()
        assert np.abs(rt - x).max() <= float(s) * 0.5 + 1e-6
        rq, rs = r_quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)


# ---------------------------------------------------------------------------
# The partitioning policy (tests/test_mogd_descend.py::TestPartitionPolicy)
# ---------------------------------------------------------------------------


class TestPartitionPolicy:
    @pytest.mark.parametrize("n,g,r,want", [
        (1, 8, 32, (None, 8, 32)),      # one device: no axis
        (4, 8, 2, ("group", 8, 2)),     # many tenants shard groups
        (8, 1, 64, ("row", 1, 64)),     # one tenant shards rows
        (4, 1, 5, ("row", 1, 8)),
        (2, 4, 4, ("group", 4, 4))])    # a tie prefers the group axis
    def test_policy(self, n, g, r, want):
        assert choose_probe_partition(n, g, r) == want
        assert r_choose_probe_partition(n, g, r) == want

    @pytest.mark.parametrize("n,g,r", [(4, 6, 10), (8, 1, 3), (2, 5, 5),
                                       (8, 16, 64)])
    def test_idempotent_on_own_output(self, n, g, r):
        axis, gp, rp = choose_probe_partition(n, g, r)
        assert choose_probe_partition(n, gp, rp) == (axis, gp, rp)

    def test_single_device_executor_defaults_unsharded(self):
        # mesh="auto" on a host: no mesh, no sharded dispatches
        ex = ProbeExecutor(device=CPU)
        assert ex.mesh is None
        task = make_zdt1(d=3, device=CPU)
        MOGDSolver(task, MOGDConfig(steps=25, multistart=2), device=CPU,
                   executor=ex).solve(_boxes(task, 2))
        assert ex.stats()["sharded_dispatches"] == 0

    def test_probe_mesh_raises_past_the_devices(self):
        # more devices than exist (on a host without CUDA, any)
        with pytest.raises((ValueError, RuntimeError)):
            probe_mesh(n_devices=torch.cuda.device_count() + 1)
        assert probe_mesh(n_devices=3, device=CPU).shape == {"probe": 3}


# ---------------------------------------------------------------------------
# The probe mesh in the executor (tests/test_executor.py::TestMeshPath)
# ---------------------------------------------------------------------------


def _boxes(problem, n: int, seed: int = 0) -> np.ndarray:
    b = estimate_objective_bounds(problem, n=256, seed=seed)
    rng = np.random.default_rng(seed)
    lo = b[0] + rng.random((n, problem.k)) * 0.3 * (b[1] - b[0])
    return np.stack([lo, lo + 0.5 * (b[1] - b[0])], axis=1)


class TestMeshPath:
    def test_single_device_mesh_is_noop(self):
        zdt1 = make_zdt1(device=CPU)
        boxes = _boxes(zdt1, 5)
        plain = MOGDSolver(zdt1, FAST, device=CPU,
                           executor=ProbeExecutor(mesh=None, device=CPU))
        mesh = probe_mesh(n_devices=1, device=CPU)
        ex = ProbeExecutor(mesh=mesh, device=CPU)
        shard = MOGDSolver(zdt1, FAST, device=CPU, executor=ex)
        r0, r1 = plain.solve(boxes), shard.solve(boxes)
        np.testing.assert_allclose(r1.x, r0.x, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r1.feasible, r0.feasible)
        assert ex.sharded_dispatches == 0

    def test_eight_shard_mesh_parity_rows(self):
        """One session's boxes (G = 1): the row axis."""
        cfg = MOGDConfig(steps=30, multistart=4)
        problem = make_zdt1(d=4, device=CPU)
        boxes = _boxes(problem, 6)
        plain = MOGDSolver(problem, cfg, device=CPU,
                           executor=ProbeExecutor(mesh=None, device=CPU))
        mesh = ProbeMesh([CPU] * 8)
        ex = ProbeExecutor(mesh=mesh, device=CPU)
        sharded = MOGDSolver(problem, cfg, device=CPU, executor=ex)
        r0, r1 = plain.solve(boxes), sharded.solve(boxes)
        assert len(mesh.devices) == 8
        assert (r0.feasible == r1.feasible).all()
        assert np.abs(r0.x - r1.x).max() < 1e-5
        assert np.abs(r0.f - r1.f).max() < 1e-5
        assert ex.sharded_dispatches == 1 and ex.last_shard_axis == "row"

    def test_eight_shard_mesh_parity_groups(self):
        """Twelve MLP-surrogate tenants coalesced (the fused descend's
        plain version): the group axis, each shard its own params."""
        cfg = MOGDConfig(steps=20, multistart=2)
        tasks = [mlp_surrogate_task(seed=i, d=3, arch=(8, 8), k=2,
                                    device=CPU).compile() for i in range(12)]
        out = []
        for mesh in (None, ProbeMesh([CPU] * 8)):
            ex = ProbeExecutor(mesh=mesh, device=CPU)
            solvers = [MOGDSolver(t, cfg, device=CPU, executor=ex)
                       for t in tasks]
            out.append(solve_grouped([(s, _boxes(t, 2, i), 0) for i, (s, t)
                                      in enumerate(zip(solvers, tasks))]))
        r0, r1 = out
        assert ex.last_shard_axis == "group" and ex.sharded_dispatches == 1
        assert ex.stats()["fused_dispatches"] == 1
        assert ex.last_bucket[0] % 8 == 0
        assert (r0.feasible == r1.feasible).all()
        assert np.abs(r0.x - r1.x).max() < 1e-5
        assert np.abs(r0.f - r1.f).max() < 1e-5

    def test_plan_buckets_divisible_by_the_mesh(self):
        ex = ProbeExecutor(mesh=ProbeMesh([CPU] * 4), device=CPU)
        assert ex.plan_buckets(3, 1) == (4, 1)
        assert ex.plan_buckets(1, 5) == (1, 8)


# ---------------------------------------------------------------------------
# Spec trees, placements and the logical-axes trees, all ten architectures
# ---------------------------------------------------------------------------


def _walk(port, ref, stacked: bool, fn):
    """``fn(port leaf, reference leaf, stacked)`` over the port's tree,
    the reference's ``blocks`` stacked over units."""
    if isinstance(port, dict):
        for k in port:
            _walk(port[k], ref[k], stacked or k == "blocks", fn)
    elif isinstance(port, list) and stacked and isinstance(ref, dict):
        for unit in port:
            _walk(unit, ref, True, fn)
    else:
        fn(port, ref, stacked)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_param_axes_and_specs_equal_the_reference(arch):
    rc, pc = rconfigs.get_config(arch), pconfigs.get_config(arch)
    r_params, r_axes = rnn.abstract_params(rc)
    p_params, p_axes = pnn.abstract_params(pc), pnn.param_axes(pc)
    shape = rconfigs.SHAPES["train_4k"]

    def same_axes(p, r, stacked):
        assert (("layers",) + p if stacked else p) == r

    _walk(p_axes, r_axes, False, same_axes)
    for mesh in (FakeMesh, FakePodMesh):
        plan = rplans.baseline_plan(rc, shape)
        rr = rplans.rules_for(rc, shape, mesh(), plan)
        pr = pplans.rules_for(pc, shape, mesh(),
                              pplans.baseline_plan(pc, shape))
        assert dict(pr.table) == dict(rr.table)
        r_specs = r_spec_tree(rr, r_params, r_axes)
        p_specs = spec_tree(pr, p_params, p_axes)
        p_place = named_sharding_tree(pr, p_params, p_axes)

        def same_spec(p, r, stacked):
            assert ((None,) + p if stacked else p) == tuple(r)

        def placed(leaf, spec, place):
            names = mesh.axis_names
            for i, pl in enumerate(place):
                dims = [d for d, e in enumerate(spec) if e is not None
                        and names[i] in ((e,) if isinstance(e, str) else e)]
                assert (pl.is_shard() and [pl.dim] == dims) or (
                    pl.is_replicate() and not dims)

        _walk(p_specs, r_specs, False, same_spec)
        _each(p_params, p_specs, p_place, placed)


def _each(params, specs, places, fn):
    """``fn(leaf, spec, placements)`` over the port's parameter leaves."""
    if isinstance(params, dict):
        for k in params:
            _each(params[k], specs[k], places[k], fn)
    elif isinstance(params, list):
        for p, s, q in zip(params, specs, places):
            _each(p, s, q, fn)
    else:
        fn(params, specs, places)


@pytest.mark.parametrize("shape", list(rconfigs.SHAPES))
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_input_specs_and_cache_axes_equal_the_reference(arch, shape):
    rc, pc = rconfigs.get_config(arch), pconfigs.get_config(arch)
    rs, ps = rconfigs.SHAPES[shape], pconfigs.SHAPES[shape]
    ri, pi = rconfigs.input_specs(rc, rs), pconfigs.input_specs(pc, ps)
    assert sorted(ri) == sorted(pi)

    def same_leaf(p, r, stacked):
        assert p.device.type == "meta"
        want = tuple(r.shape[1:]) if stacked else tuple(r.shape)
        assert tuple(p.shape) == want
        assert str(p.dtype).split(".")[-1] == str(r.dtype)

    _walk(pi["batch"], ri["batch"], False, same_leaf)
    if "cache" in ri:
        _walk({"blocks": pi["cache"]}, {"blocks": ri["cache"]}, False,
              same_leaf)
        _walk({"blocks": pconfigs.cache_axes(pc, ps)},
              {"blocks": rconfigs.cache_axes(rc, rs)}, False,
              lambda p, r, st: (("layers",) + p) == r or pytest.fail(
                  f"cache axes {p} != {r}"))
        assert tuple(pi["pos"].shape) == () and pi["pos"].dtype == torch.int32


# ---------------------------------------------------------------------------
# Eight gloo ranks (TestMultiDevice and TestShardedServingParity, port
# against port)
# ---------------------------------------------------------------------------


sys.path.insert(0, os.path.dirname(RANKS))
from torch_dist_ranks import (  # noqa: E402
    MOE_CASES,
    moe_case_cfg,
    moe_case_tokens,
)


def _write_moe_refs(d) -> dict:
    """Per ``MOE_CASES`` case: the reference's seed-0 weights written to
    ``d`` as a numpy tree, and its unsharded fp32 prefill and decode
    logits."""
    refs = {}
    for case in MOE_CASES:
        rc = moe_case_cfg(rconfigs, case)
        rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
        with open(d / f"{case}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, rp), f)
        toks, last = moe_case_tokens(case, rc.vocab)
        S = toks.shape[1]
        lg, cache = rnn.prefill(rp, rc, {"tokens": jnp.asarray(toks)},
                                max_seq=S + 4)
        dl, _ = rnn.decode_step(rp, rc, cache, {"tokens": jnp.asarray(last)},
                                jnp.int32(S))
        refs[case] = {"prefill": np.asarray(lg, np.float32),
                      "decode": np.asarray(dl, np.float32)}
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    refs = _write_moe_refs(d)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, RANKS, str(r), "8", str(d)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(8)]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    out = json.loads((d / "result.json").read_text())
    for case, ref in refs.items():
        for call, want in ref.items():
            out["moe"][case][f"{call}_ref"] = want
            out["moe"][case][f"{call}_got"] = np.load(
                d / f"{case}_{call}.npy")
    return out


class TestMultiDevice:
    def test_compressed_psum_accuracy(self, ranks):
        # int8 quantization: relative error bounded by ~1/127 per element
        assert ranks["psum_rel_err"] < 0.03

    def test_error_feedback_nonzero(self, ranks):
        assert ranks["resid_norm"] > 0

    def test_sharded_training_parity(self, ranks):
        assert abs(ranks["loss_plain"] - ranks["loss_sharded"]) < 5e-2
        assert ranks["param_delta_max"] < 5e-2
        assert ranks["placements_kept"]


def test_sharded_driver_matches_one_device(ranks):
    """``launch.train --model-parallel 2`` on the eight ranks against the
    same run on one device: every loss within 5e-2."""
    from repro_torch.launch import train

    from torch_dist_ranks import DRIVER_ARGS

    want = train.main(DRIVER_ARGS)["losses"]
    got = ranks["driver_losses"]
    assert len(got) == len(want) == 3
    assert max(abs(a - b) for a, b in zip(got, want)) < 5e-2


class TestShardedServingParity:
    @pytest.mark.parametrize("case,key", [
        ("mistral", "prefill_max_diff"), ("mistral", "decode_max_diff"),
        ("rwkv", "prefill_max_diff"), ("jamba_fp32", "prefill_max_diff"),
        ("jamba_dense_bf16", "prefill_max_diff"),
        ("jamba_moe_bf16", "pinned_max_diff")])
    def test_logits_match(self, ranks, case, key):
        r = ranks[case]
        assert r[key] <= 0.05 * max(r["logit_scale"], 1.0)

    def test_jamba_bf16_moe_gap_is_routing_flips(self, ranks):
        """Jamba in its configured bf16 with its MoE layers: wherever the
        sharded prefill misses the bar, some routed token's top-k set
        differs from the unsharded run's, and pinning every MoE call's
        choices to the unsharded run's brings it within the bar
        (``test_logits_match``).  Each sharded MoE call's groups are
        matched to the unsharded run's by their router logits; the match
        must be unambiguous."""
        r = ranks["jamba_moe_bf16"]
        assert r["moe_calls"] == r["compare_calls"] == r["pinned_calls"] > 0
        assert r["pinned_match_max_dist"] < r["match_margin"] / 2
        if r["prefill_max_diff"] > 0.05 * max(r["logit_scale"], 1.0):
            assert r["flipped_tokens"] > 0
        assert 0 <= r["flipped_tokens"] <= r["routed_tokens"]


class TestShardedMoE:
    """The sharded MoE on the (2, 4) mesh (``MOE_CASES``)."""

    @pytest.mark.parametrize("call", ["prefill", "decode"])
    @pytest.mark.parametrize("case", list(MOE_CASES))
    def test_matches_the_unsharded_port(self, ranks, case, call):
        """The logits within 1e-5 relative, and the decode cache's
        per-expert loads equal (over capacity in the drop cases)."""
        r = ranks["moe"][case]
        assert r[f"{call}_rel"] <= 1e-5
        assert r["counts_equal"]
        if case.startswith("drops"):
            assert r["max_load"] > expert_capacity(
                moe_case_cfg(pconfigs, case).moe)

    @pytest.mark.parametrize("call", ["prefill", "decode"])
    @pytest.mark.parametrize("case", list(MOE_CASES))
    def test_matches_the_reference(self, ranks, case, call):
        r = ranks["moe"][case]
        got, want = r[f"{call}_got"], r[f"{call}_ref"]
        assert got.shape == want.shape
        scale = float(np.abs(r["prefill_ref"]).max())
        assert np.abs(got - want).max() <= 0.05 * max(scale, 1.0)

    @pytest.mark.parametrize("case", list(MOE_CASES))
    def test_local_shards_and_collectives(self, ranks, case):
        """Each rank holds E/4 experts (EP) or expert_ff/4 (TP); one
        sharded MoE call, laid out as the residual stream, all-reduces
        its output and gathers no expert weight."""
        r = ranks["moe"][case]
        E, D, F = r["global_w1"]
        tp = bool(MOE_CASES[case][3])
        assert r["local_w1"] == ([E, D, F // 4] if tp else [E // 4, D, F])
        assert r["local_w2"] == ([E, F // 4, D] if tp else [E // 4, F, D])
        assert r["call_collectives"] == ["all-reduce"]
        assert r["call_weight_gathers"] == 0
        assert r["call_rel"] <= 1e-5

    @pytest.mark.parametrize("route", ["ep", "tp"])
    def test_train_step(self, ranks, route):
        """The qwen2-moe smoke step in fp32 compute at ``check_train``'s
        bars, and every parameter's gradient (the router, the experts'
        ``w1``/``w2``/``w3`` and the shared expert among them) within
        1e-4 relative of the unsharded step's: a first Adam step moves
        each parameter by about lr whatever its gradient, so the
        parameter bar alone would not see a wrongly reduced gradient."""
        r = ranks["moe_train"][route]
        assert abs(r["loss_plain"] - r["loss_sharded"]) < 5e-2
        assert r["param_delta_max"] < 5e-2
        assert r["placements_kept"]
        moe = {p.rsplit("/", 1)[1] for p in r["grad_rel"] if "/moe/" in p}
        assert moe >= {"router", "w1", "w2", "w3", "shared_w1",
                       "shared_w2", "shared_w3", "shared_gate"}
        assert max(r["grad_rel"].values()) <= 1e-4, r["grad_rel"]
        assert abs(r["grad_norm_sharded"] - r["grad_norm_plain"]) <= \
            1e-4 * r["grad_norm_plain"]


def test_unsharded_step_matches_the_reference():
    """The gloo case's unsharded qwen3-4b smoke step (lr 1e-2, its batch)
    against the reference's, fp32 compute, from the reference's weights."""
    rc = rconfigs.get_smoke("qwen3-4b").replace(compute_dtype="float32")
    pc = pconfigs.get_smoke("qwen3-4b").replace(compute_dtype="float32")
    rp, _ = rnn.init_params(jax.random.PRNGKey(1), rc)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    toks = np.arange(4 * 32, dtype=np.int32).reshape(4, 32) % rc.vocab
    radam = rtraining.AdamConfig(lr=1e-2)
    _, _, rm = jax.jit(rtraining.make_train_step(
        rc, rtraining.TrainStepConfig(adam=radam)))(
        rp, rtraining.adam_init(rp, radam), {"tokens": jnp.asarray(toks)})
    padam = ptraining.AdamConfig(lr=1e-2)
    _, _, pm = ptraining.make_train_step(
        pc, ptraining.TrainStepConfig(adam=padam))(
        pp, ptraining.adam_init(pp, padam), {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-4)
