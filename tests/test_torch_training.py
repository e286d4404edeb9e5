"""The port's LM training path against the JAX package, on the CPU.

Weights come from the reference's ``init_params`` and are carried across
by ``repro_torch.nn.convert`` (its Adam state by ``opt_state_from_numpy``);
batches are made once with numpy and handed to both packages.  Kernel
wrappers take their plain versions here (CPU tensors).

Tolerances:

* ``adam_update`` on the same trees: 1e-6 relative to each leaf's largest
  entry (fp32 and bf16 moments, weight decay, a clip that binds, three
  steps); the moment update ``b1 mu + (1 - b1) g`` cancels, so an entry
  far below its leaf's largest carries the absolute rounding of the
  larger terms (the two packages sum the gradient norm in another order).
* one ``make_train_step`` step in fp32 compute, all ten smoke configs,
  against ``jax.jit`` of the reference's: loss and accuracy at 1e-5,
  ``grad_norm`` at 1e-4 relative, the first moment (0.1 x the clipped
  gradient) at 1e-4 of its leaf's largest entry; the updated parameters at
  1e-5 where the gradient exceeds 1e-3 of its leaf's largest entry, and
  within 2 lr elsewhere: Adam's first step moves a parameter by lr times
  the sign of its gradient, so a near-zero gradient whose sign the two
  packages round differently steps the other way (ROADMAP Queue 3 item 1).
* in bf16 compute (qwen3-4b and rwkv6-3b, one per mixer kind with a
  kernel apart from Jamba's, which the fp32 cases cover), against the
  reference with ``scan_layers=False`` (the port's plain loop over layers;
  Queue 3 item 4) at ``tests/test_archs.py``'s 2e-2: loss, accuracy and
  ``grad_norm`` (relative); the updated parameters under the fp32 rule
  with the gradient threshold at 2e-2.  The gradient itself (the first
  moment) is held per leaf at 5e-2 relative L2: bf16 rounding alone moves
  it that far, since the reference's own bf16 gradients differ from its
  fp32 ones by 1-5.5 % a leaf and its scanned from its unrolled by up to
  2 % (qwen3-4b and rwkv6-3b smoke, this batch); the port's sit 0.5-2.8 %
  from the unrolled reference's.
* ``microbatches=2``: the fp32 bars.
* a 10-step loss trajectory (qwen3-4b smoke, fp32, MarkovCorpus batches
  shared by both packages): every loss within 1e-4.
"""

from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as JR
from repro import configs as rconfigs
from repro import nn as rnn
from repro import training as rtraining
from repro.data.lm_data import MarkovCorpus as JMarkovCorpus
from repro.launch import train as rtrain
from repro.runtime.elastic import ElasticController as JElasticController
from repro.runtime.elastic import simulate_failures as j_simulate_failures
from repro_torch import configs as pconfigs
from repro_torch import nn as pnn
from repro_torch import training as ptraining
from repro_torch.data.lm_data import MarkovCorpus, TokenLoader
from repro_torch.launch import train as ptrain
from repro_torch.nn.convert import (
    opt_state_from_numpy,
    params_from_numpy,
    stack_blocks,
)
from repro_torch.runtime import (
    CheckpointManager,
    ElasticController,
    FailureEvent,
    StragglerMonitor,
    simulate_failures,
)

ADAM_TOL = 1e-6
LOSS_TOL, GNORM_TOL, MU_TOL, PARAM_TOL, G_FLOOR = 1e-5, 1e-4, 1e-4, 1e-5, 1e-3
BF16_TOL, BF16_G_FLOOR, BF16_GRAD_REL = 2e-2, 2e-2, 5e-2
TRAJ_TOL = 1e-4
LR = 1e-3
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A port tree (blocks as a list) as the reference's layout in float32
    numpy, leaves in the reference's order."""
    if isinstance(tree, dict) and "blocks" in tree:
        tree = stack_blocks(tree)
    return [np.asarray(t.detach().float().numpy()) if t.is_floating_point()
            else t.numpy() for t in jax.tree.leaves(tree)]


def _ref_np(tree):
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# Mirrors of tests/test_pipeline.py::TestData, and the corpus's draws
# ---------------------------------------------------------------------------


class TestData:
    def test_corpus_learnable_structure(self):
        c = MarkovCorpus(vocab=128, seed=0)
        rng = np.random.default_rng(0)
        toks = c.sample(rng, 4, 256)
        assert toks.shape == (4, 256)
        assert toks.min() >= 0 and toks.max() < 128
        # successor entropy is bounded: next token comes from 8 choices
        pairs = set()
        for row in toks:
            pairs.update(zip(row[:-1], row[1:]))
        succ = {}
        for a, b in pairs:
            succ.setdefault(a, set()).add(b)
        assert max(len(v) for v in succ.values()) <= 8

    def test_loader_prefetch_and_shapes(self):
        c = MarkovCorpus(vocab=64, seed=1)
        loader = TokenLoader(c, batch=2, seq=32, prefetch=2, seed=2)
        b1 = next(loader)
        b2 = next(loader)
        assert b1["tokens"].shape == (2, 32)
        assert not np.array_equal(b1["tokens"], b2["tokens"])
        loader.close()

    @pytest.mark.parametrize("vocab,seed,sample_seed", [
        (64, 1, 2), (512, 0, 1), (151936, 3, 4)])
    def test_corpus_draws_equal_the_reference(self, vocab, seed,
                                              sample_seed):
        mine, ref = MarkovCorpus(vocab, seed=seed), JMarkovCorpus(vocab,
                                                                  seed=seed)
        np.testing.assert_array_equal(mine.successors, ref.successors)
        got = mine.sample(np.random.default_rng(sample_seed), 3, 40)
        want = ref.sample(np.random.default_rng(sample_seed), 3, 40)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)

    def test_loader_places_tensors_on_the_device_asked_for(self):
        c = MarkovCorpus(vocab=64, seed=1)
        host = TokenLoader(c, batch=2, seq=16, seed=2)
        dev = TokenLoader(c, batch=2, seq=16, device="cpu", seed=2)
        a, b = next(host), next(dev)
        host.close()
        dev.close()
        assert isinstance(a["tokens"], np.ndarray)
        assert isinstance(b["tokens"], torch.Tensor)
        assert b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(b["tokens"].numpy(), a["tokens"])


# ---------------------------------------------------------------------------
# Mirrors of tests/test_runtime.py::{TestStraggler, TestElastic}
# ---------------------------------------------------------------------------


class TestStraggler:
    def test_detects_slow_host(self):
        mon = StragglerMonitor(n_hosts=8, patience=2)
        base = np.full(8, 1.0)
        verdicts = []
        for _ in range(4):
            times = base.copy()
            times[3] = 2.5  # persistent straggler
            verdicts = mon.observe(times)
        assert any(v.host == 3 for v in verdicts)
        assert mon.slowdown() > 1.5

    def test_no_false_positive_on_noise(self):
        rng = np.random.default_rng(0)
        mon = StragglerMonitor(n_hosts=8, patience=3)
        flagged = []
        for _ in range(20):
            flagged += mon.observe(rng.normal(1.0, 0.02, size=8))
        assert not flagged

    def test_evict_threshold(self):
        mon = StragglerMonitor(n_hosts=4, patience=1, z_evict=5.0)
        times = np.array([1.0, 1.0, 1.0, 50.0])
        v = mon.observe(times)
        assert v and v[0].action == "evict"


class TestElastic:
    def test_failure_sim_reproducible(self):
        a = simulate_failures(1000, seed=42)
        b = simulate_failures(1000, seed=42)
        assert [e.step for e in a] == [e.step for e in b]
        assert all(0 < e.step < 1000 for e in a)
        # and the reference's timeline, event for event
        assert [(e.step, e.kind, e.chips_delta) for e in a] == [
            (e.step, e.kind, e.chips_delta)
            for e in j_simulate_failures(1000, seed=42)]

    def test_controller_replans_and_restores(self):
        calls = {}

        class Rec:
            num_chips = None

        def replan(chips):
            calls["chips"] = chips
            r = Rec()
            r.num_chips = chips
            return r

        def rebuild(rec):
            calls["rebuilt"] = rec.num_chips
            return ("step_fn", "shardings")

        def restore(sh):
            calls["restored_with"] = sh
            return {"params": 1}

        logs = []
        for cls in (ElasticController, JElasticController):
            ctl = cls(total_chips=256, replan=replan, rebuild=rebuild,
                      restore=restore)
            step_fn, state = ctl.handle(FailureEvent(10, "node_loss", -8))
            assert calls["chips"] == 248
            assert ctl.log[-1]["downtime_s"] >= 0
            assert state == {"params": 1}
            ctl.handle(FailureEvent(20, "node_join", +8))
            assert ctl.total_chips == 256
            logs.append([(e["chips"], e["replan_chips"]) for e in ctl.log])
        assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


def _adam_trees(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "blocks": {"w": (3, 4, 6), "b": (3, 6)},
              "z": (11,)}

    def draw(scale):
        return {k: ({kk: (rng.normal(size=s) * scale).astype(np.float32)
                     for kk, s in v.items()} if isinstance(v, dict) else
                    (rng.normal(size=v) * scale).astype(np.float32))
                for k, v in shapes.items()}

    params = draw(1.0)
    grads = [draw(grad_scale) for _ in range(3)]
    return params, grads


def _to_torch(tree):
    return jax.tree.map(torch.tensor, tree)


@pytest.mark.parametrize("state_dtype,weight_decay,grad_scale", [
    ("float32", 0.0, 1e-2),     # the clip does not bind (norm < 1)
    ("float32", 0.0, 3.0),      # the clip binds
    ("float32", 0.1, 3.0),      # and decoupled weight decay
    ("bfloat16", 0.0, 3.0),     # bf16 moments
    ("bfloat16", 0.05, 1e-2),
])
def test_adam_update_matches_the_reference(state_dtype, weight_decay,
                                           grad_scale):
    """Three updates from ``adam_init`` on the same numpy trees: params,
    both moments, the count and the gradient norm at 1e-6 relative (the
    leaves to their largest entry); the inputs are left as they were."""
    params, grads = _adam_trees(0, grad_scale)
    rc = rtraining.AdamConfig(lr=1e-2, weight_decay=weight_decay,
                              state_dtype=state_dtype)
    pc = ptraining.AdamConfig(lr=1e-2, weight_decay=weight_decay,
                              state_dtype=state_dtype)
    rp, ro = jax.tree.map(jnp.asarray, params), None
    ro = rtraining.adam_init(rp, rc)
    pp = _to_torch(params)
    po = ptraining.adam_init(pp, pc)
    assert po["count"].dtype == torch.int32 and po["count"].ndim == 0
    for g in grads:
        rp, ro, rn = rtraining.adam_update(jax.tree.map(jnp.asarray, g), ro,
                                           rp, rc)
        before = [t.clone() for t in jax.tree.leaves(pp)]
        pg = _to_torch(g)
        pp2, po2, pn = ptraining.adam_update(pg, po, pp, pc)
        for t, was in zip(jax.tree.leaves(pp), before):
            assert torch.equal(t, was)
        pp, po = pp2, po2
        np.testing.assert_allclose(float(pn), float(rn), rtol=ADAM_TOL)
        for got, want in ((pp, rp), (po["mu"], ro["mu"]),
                          (po["nu"], ro["nu"])):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
                want = np.asarray(b, np.float32)
                np.testing.assert_allclose(
                    a.float().numpy(), want, rtol=ADAM_TOL,
                    atol=ADAM_TOL * np.abs(want).max())
        assert int(po["count"]) == int(ro["count"])
    if grad_scale > 1:
        assert float(pn) > pc.grad_clip  # the clip bound


# ---------------------------------------------------------------------------
# The train step against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, port cfg, reference params, port params) per arch
    and config overrides, the port's carried from the reference's seed-0
    init."""
    store = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in store:
            rc = rconfigs.get_smoke(arch).replace(**kw)
            pc = pconfigs.get_smoke(arch).replace(
                **{k: v for k, v in kw.items() if k != "scan_layers"})
            rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
            pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
            store[key] = (rc, pc, rp, pp)
        return store[key]

    return get


def _batch(cfg, batch=B, seq=S, seed=0):
    """The same batch for both packages (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        e = (rng.normal(size=(batch, seq, cfg.d_model)) * 0.3).astype(
            np.float32)
        lab = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
        return ({"embeds": jnp.asarray(e, jnp.bfloat16),
                 "labels": jnp.asarray(lab)},
                {"embeds": torch.tensor(e).to(torch.bfloat16),
                 "labels": torch.tensor(lab)})
    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks)}


@functools.lru_cache(maxsize=None)
def _ref_step(rc, microbatches):
    """The reference's jitted step, compiled once per config (its compile
    is most of a parity case's time)."""
    return jax.jit(rtraining.make_train_step(
        rc, rtraining.TrainStepConfig(adam=rtraining.AdamConfig(lr=LR),
                                      microbatches=microbatches)))


def _steps(rc, pc, rp, pp, batches, microbatches=1):
    """The reference's jitted step and the port's over the same batches
    from the same state; returns both sides' (params, opt, metrics) lists
    and the last step's."""
    radam = rtraining.AdamConfig(lr=LR)
    padam = ptraining.AdamConfig(lr=LR)
    rstep = _ref_step(rc, microbatches)
    pstep = ptraining.make_train_step(
        pc, ptraining.TrainStepConfig(adam=padam, microbatches=microbatches))
    ro = rtraining.adam_init(rp, radam)
    po = opt_state_from_numpy(jax.tree.map(np.asarray, ro), "cpu")
    out = []
    for rb, pb in batches:
        rp, ro, rm = rstep(rp, ro, rb)
        pp, po, pm = pstep(pp, po, pb)
        out.append(((rp, ro, rm), (pp, po, pm)))
    return out


def _check_step(ref, port, tol, g_floor, mu_rel_l2=None):
    (rp, ro, rm), (pp, po, pm) = ref, port
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=GNORM_TOL if mu_rel_l2 is None else tol)
    assert float(pm["tokens"]) == float(rm["tokens"])
    assert int(po["count"]) == int(ro["count"])
    leaves = zip(_np(pp), _ref_np(rp), _np(po["mu"]), _ref_np(ro["mu"]))
    for got_p, want_p, got_mu, want_mu in leaves:
        assert got_p.shape == want_p.shape
        top = np.abs(want_mu).max()
        if mu_rel_l2 is None:
            np.testing.assert_allclose(got_mu, want_mu, rtol=0,
                                       atol=MU_TOL * top)
        elif top > 0:
            err = np.linalg.norm(got_mu - want_mu) / np.linalg.norm(want_mu)
            assert err <= mu_rel_l2, err
        big = np.abs(want_mu) > g_floor * top
        np.testing.assert_allclose(got_p[big], want_p[big], rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
        assert np.all(np.abs(got_p - want_p) <= 2 * LR + PARAM_TOL)


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_train_step_fp32_matches_the_reference(carried, arch):
    rc, pc, rp, pp = carried(arch, compute_dtype="float32")
    ((ref, port),) = _steps(rc, pc, rp, pp, [_batch(rc)])
    assert float(port[2]["grad_norm"]) > 0
    _check_step(ref, port, LOSS_TOL, G_FLOOR)


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b"])
def test_train_step_bf16_matches_the_unrolled_reference(carried, arch):
    rc, pc, rp, pp = carried(arch, scan_layers=False)
    assert pc.cdtype() == torch.bfloat16
    ((ref, port),) = _steps(rc, pc, rp, pp, [_batch(rc)])
    _check_step(ref, port, BF16_TOL, BF16_G_FLOOR, mu_rel_l2=BF16_GRAD_REL)


def test_microbatches_match_the_reference(carried):
    rc, pc, rp, pp = carried("qwen3-4b", compute_dtype="float32")
    ((ref, port),) = _steps(rc, pc, rp, pp, [_batch(rc, batch=4, seed=3)],
                            microbatches=2)
    _check_step(ref, port, LOSS_TOL, G_FLOOR)


def test_loss_trajectory_matches_the_reference(carried):
    """Ten steps from MarkovCorpus batches (the driver's source, seeds 0 and
    1) in fp32: the losses agree step for step and descend."""
    rc, pc, rp, pp = carried("qwen3-4b", compute_dtype="float32")
    corpus, rng = MarkovCorpus(rc.vocab, seed=0), np.random.default_rng(1)
    batches = []
    for _ in range(10):
        toks = corpus.sample(rng, 4, S)
        batches.append(({"tokens": jnp.asarray(toks)},
                        {"tokens": torch.tensor(toks)}))
    out = _steps(rc, pc, rp, pp, batches)
    got = [float(port[2]["loss"]) for _, port in out]
    want = [float(ref[2]["loss"]) for ref, _ in out]
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_TOL)
    assert got[-1] < got[0]


def test_a_multi_device_mesh_is_refused():
    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 1}

    from repro_torch.distributed import ShardingRules

    cfg = pconfigs.get_smoke("qwen3-4b")
    one = ShardingRules(type("One", (), {"axis_names": ("data",),
                                         "shape": {"data": 1}})())
    assert callable(ptraining.make_train_step(cfg, rules=one))
    # the train step takes a mesh of more than one device (sharded runs:
    # tests/test_torch_distributed.py); the driver refuses one only where
    # no process group runs to lay it over
    assert callable(ptraining.make_train_step(cfg,
                                              rules=ShardingRules(Mesh())))
    with pytest.raises(ValueError, match="process group"):
        ptrain.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1",
                     "--model-parallel", "2", "--device", "cpu"])


def test_train_step_config_fields_are_read(carried):
    """``compute_dtype`` other than the model's raises (the model config
    decides the cast); ``grad_reduce_dtype`` is applied, as the
    reference's gradient pin, when one-device ``rules`` and
    ``param_axes`` are both given, and not otherwise."""
    from repro_torch.distributed import ShardingRules
    from repro_torch.exec import tree_map
    from repro_torch.training.adam import adam_update
    from repro_torch.training.train_step import grads_of

    _, pc, _, pp = carried("qwen3-4b", compute_dtype="float32")
    with pytest.raises(ValueError, match="compute_dtype"):
        ptraining.make_train_step(
            pc, ptraining.TrainStepConfig(compute_dtype="bfloat16"))
    one = ShardingRules(type("One", (), {"axis_names": ("data",),
                                         "shape": {"data": 1}})())
    adam = ptraining.AdamConfig(lr=LR)
    opt = ptraining.adam_init(pp, adam)
    _, batch = _batch(pc)
    grads, _ = grads_of(pp, pc, batch)
    for axes, want_dt in ((None, torch.float32), ({}, torch.bfloat16)):
        ts = ptraining.TrainStepConfig(adam=adam, compute_dtype="float32",
                                       grad_reduce_dtype="bfloat16")
        got, _, m = ptraining.make_train_step(pc, ts, rules=one,
                                              param_axes=axes)(pp, opt, batch)
        pinned = tree_map(lambda g: g.to(want_dt), grads)
        want, _, gnorm = adam_update(pinned, opt, pp, adam)
        assert torch.equal(m["grad_norm"], gnorm)
        for a, b in zip(_np(got), _np(want)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Abstract trees (the dry-run's): shapes and dtypes, no allocation
# ---------------------------------------------------------------------------


def _stack_meta(units):
    first = units[0]
    if isinstance(first, dict):
        return {k: _stack_meta([u[k] for u in units]) for k in first}
    return (len(units), *first.shape), first.dtype, all(
        u.is_meta for u in units)


def _described(tree):
    """A port tree -> {path: (reference shape, dtype name, meta)} with the
    block leaves stacked over units."""
    if isinstance(tree, list):
        tree = _stack_meta(tree)
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, tuple):
            out[path] = (tuple(t[0]), str(t[1]).split(".")[-1], t[2])
        else:
            out[path] = (tuple(t.shape), str(t.dtype).split(".")[-1],
                         t.is_meta)

    if isinstance(tree, dict) and isinstance(tree.get("blocks"), list):
        tree = {**tree, "blocks": _stack_meta(tree["blocks"])}
    walk(tree, ())
    return out


def _ref_described(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(p.key for p in path): (tuple(s.shape), str(s.dtype), True)
            for path, s in flat}


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_abstract_trees_match_the_reference(arch):
    rc, pc = rconfigs.get_config(arch), pconfigs.get_config(arch)
    params = pnn.abstract_params(pc)
    assert _described(params) == _ref_described(rnn.abstract_params(rc)[0])
    for sd in ("float32", "bfloat16"):
        mine = ptraining.abstract_opt_state(
            params, ptraining.AdamConfig(state_dtype=sd))
        want = rtraining.abstract_opt_state(
            rnn.abstract_params(rc)[0],
            rtraining.AdamConfig(state_dtype=sd))
        for k in ("mu", "nu"):
            assert _described(mine[k]) == _ref_described(want[k])
        assert mine["count"].is_meta and mine["count"].dtype == torch.int32
        assert tuple(mine["count"].shape) == want["count"].shape == ()
    cache = pnn.abstract_cache(pc, 2, 64)
    assert _described(cache) == _ref_described(rnn.abstract_cache(rc, 2,
                                                                   64)[0])


# ---------------------------------------------------------------------------
# The train driver: tests/test_pipeline.py::TestTrainDriver's contract
# ---------------------------------------------------------------------------


def _drive(ckpt, steps, *extra):
    return ptrain.main([
        "--arch", "qwen3-4b", "--smoke", "--steps", str(steps), "--batch",
        "4", "--seq", "64", "--ckpt", str(ckpt), "--ckpt-every", "6",
        "--log-every", "50", "--device", "cpu", *extra])


class TestTrainDriver:
    def test_loss_descends_and_resumes(self, tmp_path):
        r1 = _drive(tmp_path, 12)
        assert len(r1["losses"]) == 12
        assert np.isfinite(r1["losses"]).all()
        assert np.mean(r1["losses"][-3:]) < np.mean(r1["losses"][:3])
        r2 = _drive(tmp_path, 16)
        assert len(r2["losses"]) == 4  # resumed at step 12
        assert np.isfinite(r2["losses"]).all()
        assert r1["slowdown"] == pytest.approx(1.0)  # one host

    def test_resume_restores_the_saved_state_bit_for_bit(self, tmp_path):
        r1 = _drive(tmp_path, 12)
        saved = r1["state"]
        state, manifest = ptrain.restore_train_state(
            CheckpointManager(tmp_path), saved)
        assert manifest["step"] == 12
        got, want = jax.tree.leaves(state), jax.tree.leaves(saved)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Train checkpoints across the two packages
# ---------------------------------------------------------------------------


class TestCrossPackageCheckpoint:
    def test_reference_checkpoint_resumes_in_the_port(self, tmp_path):
        """The reference's ``save_checkpoint`` of its seed-0 init and Adam
        state (step 6) resumes in the port's driver: the restored leaves
        equal the reference's bit for bit, and the driver trains on from
        step 6."""
        cfg = rconfigs.get_smoke("qwen3-4b")
        rp, _ = rnn.init_params(jax.random.PRNGKey(0), cfg)
        ro = rtraining.adam_init(rp, rtraining.AdamConfig(lr=1e-3))
        ro = {"mu": jax.tree.map(lambda a: a + 1e-3, ro["mu"]),
              "nu": jax.tree.map(lambda a: a + 1e-4, ro["nu"]),
              "count": jnp.int32(6)}
        JR.save_checkpoint(tmp_path, 6, {"params": rp, "opt": ro})
        like = {"params": pnn.init_params(pconfigs.get_smoke("qwen3-4b"),
                                          seed=1, device="cpu")}
        like["opt"] = ptraining.adam_init(like["params"],
                                          ptraining.AdamConfig())
        state, manifest = ptrain.restore_train_state(
            CheckpointManager(tmp_path), like)
        assert manifest["step"] == 6
        got = jax.tree.leaves(stack_blocks(state["params"])) + \
            jax.tree.leaves(stack_blocks(state["opt"]["mu"])) + \
            jax.tree.leaves(stack_blocks(state["opt"]["nu"])) + \
            [state["opt"]["count"]]
        want = jax.tree.leaves(rp) + jax.tree.leaves(ro["mu"]) + \
            jax.tree.leaves(ro["nu"]) + [ro["count"]]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.numpy(), b)
        r = _drive(tmp_path, 9)
        assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
        assert int(r["state"]["opt"]["count"]) == 9

    def test_port_checkpoint_loads_in_the_reference(self, tmp_path):
        """A train checkpoint the port's driver writes (fp32 moments) loads
        in the reference's ``load_checkpoint`` under its own tree, leaf for
        leaf equal to the port's state."""
        r = _drive(tmp_path, 6)
        cfg = rconfigs.get_smoke("qwen3-4b")
        rp, _ = rnn.init_params(jax.random.PRNGKey(1), cfg)
        like = {"params": rp,
                "opt": rtraining.adam_init(rp, rtraining.AdamConfig())}
        loaded, manifest = JR.load_checkpoint(tmp_path, like)
        assert manifest["step"] == 6
        mine = r["state"]
        got = jax.tree.leaves(loaded)
        # the reference's order: dict keys sorted (opt before params)
        want = ([mine["opt"]["count"]]
                + jax.tree.leaves(stack_blocks(mine["opt"]["mu"]))
                + jax.tree.leaves(stack_blocks(mine["opt"]["nu"]))
                + jax.tree.leaves(stack_blocks(mine["params"])))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        written = json.loads(next(tmp_path.glob("step_*")).joinpath(
            "manifest.json").read_text())
        assert "params/blocks/l0/attn/wq" in written["leaves"]


def test_reference_driver_flags_are_kept():
    """The port's driver takes every flag of the reference's (plus
    ``--device``)."""
    import inspect

    src = inspect.getsource(rtrain.main)
    flags = {line.split('"')[1] for line in src.splitlines()
             if "ap.add_argument(" in line}
    mine = inspect.getsource(ptrain.main)
    for flag in flags:
        assert f'"{flag}"' in mine, flag
    assert '"--device", default="cuda"' in mine
