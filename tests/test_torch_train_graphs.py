"""The LM train step as a CUDA graph (``training.GraphTrainStep``).

``GraphTrainStep`` owns the train state (parameters, both Adam moments,
the step count) and updates it in place; on the card its first call runs
eagerly and every later call replays the step's graph.  Here, without a
card, through the stand-in of ``tests/_graph_stand_in.py`` (a capture
refuses the operations a CUDA capture refuses; a replay runs the step
again from the static buffers), at the smoke configs of one model of each
mixer kind (qwen3-4b attention, rwkv6-3b WKV, Jamba's scan, attention and
MoE, qwen2-moe's MoE):

* the capture refuses no operation, and N calls (one eager, then
  replays) equal N steps of ``make_train_step`` from the same state bit
  for bit: parameters, both moments, ``count`` and every metric; with
  ``microbatches=2`` too;
* the state's storage does not move between replays;
* the wrappers' counts equal the eager route's: the plain versions count
  here as the kernels and their recomputes do on the card, and a
  backward run on another thread than its forward counts into the
  forward's tally (CUDA backward runs on autograd's device thread);
* ``launch.train.main`` on the graph route gives the eager route's
  losses and resumes from its checkpoint to the eager route's state, bit
  for bit;
* qwen3-4b's smoke config in fp32 against the reference's
  ``jax.jit(make_train_step(...))``: each of three calls from the same
  state as the reference's step, at ``tests/test_torch_training.py``'s
  one-step tolerances.

The ``cuda`` cases need the card (skipped here from a fixture): replays
equal eager steps bit for bit and count the eager route's launches.  The
file imports JAX only inside the reference case, so on the card it runs
on its own::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_train_graphs.py
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from _graph_stand_in import cuda_device, eager as _eager, stand_in  # noqa: F401
from repro_torch import training as ptraining
from repro_torch.configs import get_smoke
from repro_torch.exec import tree_map
from repro_torch.kernels import graphs, platform, ref, rwkv6_wkv
from repro_torch.launch import train as ptrain
from repro_torch.nn import init_params
from repro_torch.nn.model import tree_leaves

CPU = torch.device("cpu")
ARCHS = ("qwen3-4b", "rwkv6-3b", "jamba-v0.1-52b", "qwen2-moe-a2.7b")
LR = 1e-3
B, S, STEPS = 2, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counts():
    platform.reset_launches()
    yield
    platform.reset_launches()


@pytest.fixture
def host_counts(monkeypatch):
    """The plain versions count on the host as on the card: a forward
    into ``PLAIN_ON_CUDA`` (the kernel's launch, here), a backward's
    recompute into ``PLAIN_BACKWARD_ON_CUDA``."""
    for name in ("flash_attention", "rwkv6_wkv", "mamba_scan"):
        plain = getattr(ref, name)

        def counted(*args, counts=platform.PLAIN_ON_CUDA, _plain=plain,
                    _name=name, **kwargs):
            counts[_name] += 1
            return _plain(*args, counts=counts, **kwargs)

        monkeypatch.setattr(ref, name, counted)


def _state(arch, device=CPU, seed=0, **over):
    cfg = get_smoke(arch).replace(**over)
    params = init_params(cfg, seed=seed, device=device)
    opt = ptraining.adam_init(params, ptraining.AdamConfig(lr=LR))
    return cfg, params, opt


def _clone(tree):
    return tree_map(torch.clone, tree)


def _batches(cfg, n=STEPS, batch=B, seq=S, device=CPU, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.tensor(rng.integers(
        0, cfg.vocab, (batch, seq)).astype(np.int32), device=device)}
        for _ in range(n)]


def _same(got, want):
    """Every leaf equal bit for bit (dtype and shape too)."""
    g, w = list(tree_leaves(got)), list(tree_leaves(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _eager_steps(cfg, params, opt, batches, ts):
    """``make_train_step``'s steps from the given state: (state, metrics
    of each step)."""
    step = ptraining.make_train_step(cfg, ts)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        metrics.append(m)
    return {"params": params, "opt": opt}, metrics


def _graph_steps(cfg, params, opt, batches, ts):
    step = ptraining.GraphTrainStep(cfg, params, opt, ts)
    return step, [step(b) for b in batches]


def _ts(microbatches=1):
    return ptraining.TrainStepConfig(adam=ptraining.AdamConfig(lr=LR),
                                     microbatches=microbatches)


# ---------------------------------------------------------------------------
# The step's graph against make_train_step
# ---------------------------------------------------------------------------


class TestGraphTrainStep:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_replays_equal_eager_steps(self, stand_in, arch):
        cfg, params, opt = _state(arch)
        batches = _batches(cfg)
        want, want_m = _eager_steps(cfg, _clone(params), _clone(opt),
                                    batches, _ts())
        step, got_m = _graph_steps(cfg, params, opt, batches, _ts())
        assert step.captured is not None and step.captured.nodes > 0
        routes = platform.route_counts()
        assert (routes["train:eager"], routes["train:graph"]) == (
            1, STEPS - 1)
        assert graphs.CAPTURE_S["train"] > 0
        _same(step.state, want)
        assert int(step.opt["count"]) == STEPS
        for g, w in zip(got_m, want_m):
            assert set(g) == set(w) == {"loss", "accuracy", "tokens",
                                        "grad_norm"}
            for k in w:
                assert torch.equal(g[k], w[k]), k

    @pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b"])
    def test_microbatches(self, stand_in, arch):
        cfg, params, opt = _state(arch, compute_dtype="float32")
        batches = _batches(cfg, batch=4)
        want, want_m = _eager_steps(cfg, _clone(params), _clone(opt),
                                    batches, _ts(2))
        step, got_m = _graph_steps(cfg, params, opt, batches, _ts(2))
        assert platform.route_counts()["train:graph"] == STEPS - 1
        _same(step.state, want)
        for g, w in zip(got_m, want_m):
            assert all(torch.equal(g[k], w[k]) for k in w)

    def test_state_storage_does_not_move(self, stand_in):
        cfg, params, opt = _state("rwkv6-3b")
        step = ptraining.GraphTrainStep(cfg, params, opt, _ts())
        ptrs = [t.data_ptr() for t in tree_leaves(step.state)]
        for b in _batches(cfg, n=4):
            step(b)
            assert [t.data_ptr() for t in tree_leaves(step.state)] == ptrs
        assert step.state["params"] is params and step.state["opt"] is opt
        assert [g().replays for g in stand_in.graphs if g() is not None] \
            == [3]

    def test_metrics_outlive_later_replays(self, stand_in):
        cfg, params, opt = _state("qwen3-4b")
        step = ptraining.GraphTrainStep(cfg, params, opt, _ts())
        got = [step(b) for b in _batches(cfg, n=4)]
        assert len({float(m["loss"]) for m in got}) == 4

    @pytest.mark.parametrize("arch", ARCHS)
    def test_counts_equal_the_eager_route(self, stand_in, host_counts,
                                          arch):
        cfg, params, opt = _state(arch)
        batches = _batches(cfg)
        _eager_steps(cfg, _clone(params), _clone(opt), batches, _ts())
        want = (platform.plain_on_cuda_counts(),
                platform.plain_backward_on_cuda_counts())
        assert want[0] and want[0] == want[1]  # one recompute a forward
        platform.reset_launches()
        _graph_steps(cfg, params, opt, batches, _ts())
        assert (platform.plain_on_cuda_counts(),
                platform.plain_backward_on_cuda_counts()) == want

    def test_a_step_that_syncs_with_the_host_raises(self, stand_in,
                                                    monkeypatch):
        cfg, params, opt = _state("qwen3-4b")
        loss_fn = ptraining.train_step.loss_fn

        def syncing(*args, **kwargs):
            loss, metrics = loss_fn(*args, **kwargs)
            return loss * float(metrics["tokens"] > 0), metrics

        monkeypatch.setattr(ptraining.train_step, "loss_fn", syncing)
        step = ptraining.GraphTrainStep(cfg, params, opt, _ts())
        b = _batches(cfg, n=2)
        step(b[0])  # the eager first step
        with pytest.raises(RuntimeError, match="qwen3-4b-smoke train step"):
            step(b[1])

    def test_host_route_runs_every_step_eagerly(self, stand_in):
        cfg, params, opt = _state("qwen3-4b")
        batches = _batches(cfg)
        want, _ = _eager_steps(cfg, _clone(params), _clone(opt), batches,
                               _ts())
        step = _eager(stand_in, lambda: _graph_steps(
            cfg, params, opt, batches, _ts())[0])
        assert step.captured is None
        assert platform.route_counts() == {"train:eager": STEPS}
        _same(step.state, want)

    def test_backward_counts_into_its_forwards_tally(self, host_counts):
        """A backward run on another thread than its forward (autograd's
        device thread, on the card) counts into the tally the forward
        counted into."""
        g = torch.Generator().manual_seed(0)
        r, k, v = (torch.randn(1, 4, 2, 16, generator=g,
                               requires_grad=True) for _ in range(3))
        w = torch.rand(1, 4, 2, 16, generator=g)
        u = torch.randn(2, 16, generator=g)
        with platform.deferred_counts() as tally:
            y, _ = rwkv6_wkv.rwkv6_wkv(r, k, v, w, u)
        grads = []
        worker = threading.Thread(target=lambda: grads.append(
            torch.autograd.grad(y.sum(), (r, k, v))))
        worker.start()
        worker.join()
        assert len(grads) == 1
        assert not platform.plain_backward_on_cuda_counts()
        assert {(c is platform.PLAIN_BACKWARD_ON_CUDA, key, n)
                for c, key, n in tally} >= {(True, "rwkv6_wkv", 1)}


# ---------------------------------------------------------------------------
# The driver on the graph route
# ---------------------------------------------------------------------------


def _drive(ckpt, steps):
    return ptrain.main([
        "--arch", "rwkv6-3b", "--smoke", "--steps", str(steps), "--batch",
        "2", "--seq", "16", "--ckpt", str(ckpt), "--ckpt-every", "3",
        "--log-every", "50", "--device", "cpu"])


class TestDriverOnTheGraphRoute:
    def test_losses_and_resume_equal_the_eager_route(self, stand_in,
                                                     tmp_path):
        got = [_drive(tmp_path / "graph", n) for n in (3, 6)]
        assert platform.route_counts()["train:graph"] == (3 - 1) + (3 - 1)
        want = _eager(stand_in, lambda: [_drive(tmp_path / "eager", n)
                                         for n in (3, 6)])
        assert "train:eager" not in platform.route_counts() or \
            platform.route_counts()["train:eager"] == 2
        for g, w in zip(got, want):
            assert len(g["losses"]) == len(w["losses"]) == 3
            assert g["losses"] == w["losses"]
        _same(got[1]["state"], want[1]["state"])


# ---------------------------------------------------------------------------
# Against the reference's jax.jit(make_train_step(...))
# ---------------------------------------------------------------------------


def test_replays_match_the_jitted_reference(stand_in):
    """qwen3-4b's smoke config in fp32 from the reference's seed-0
    weights: each of three calls (one eager, two replays) against the
    reference's jitted step from the same state (the port's, carried
    across before each step) at ``tests/test_torch_training.py``'s
    one-step tolerances."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from test_torch_training import (
        G_FLOOR,
        LOSS_TOL,
        _batch,
        _check_step,
        _np,
        _ref_step,
    )

    from repro import configs as rconfigs
    from repro import nn as rnn
    from repro import training as rtraining
    from repro_torch.nn.convert import opt_state_from_numpy, params_from_numpy

    rc = rconfigs.get_smoke("qwen3-4b").replace(compute_dtype="float32")
    pc = get_smoke("qwen3-4b").replace(compute_dtype="float32")
    rp, _ = rnn.init_params(jax.random.PRNGKey(0), rc)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    ro = rtraining.adam_init(rp, rtraining.AdamConfig(lr=LR))
    po = opt_state_from_numpy(jax.tree.map(np.asarray, ro), "cpu")
    rstep = _ref_step(rc, 1)
    step = ptraining.GraphTrainStep(pc, pp, po, _ts())

    def carried(port_tree, like):
        # copies: a float32 leaf's numpy view shares the port's buffer,
        # which the next call overwrites in place
        leaves = jax.tree.leaves(like)
        return jax.tree.unflatten(jax.tree.structure(like), [
            jnp.array(np.array(a), dtype=w.dtype)
            for a, w in zip(_np(port_tree), leaves)])

    for seed in range(STEPS):
        rp = carried(step.params, rp)
        ro = {"mu": carried(step.opt["mu"], ro["mu"]),
              "nu": carried(step.opt["nu"], ro["nu"]),
              "count": jnp.asarray(int(step.opt["count"]), jnp.int32)}
        rb, pb = _batch(rc, seed=seed)
        rp, ro, rm = jax.block_until_ready(rstep(rp, ro, rb))
        pm = step(pb)
        _check_step((rp, ro, rm), (step.params, step.opt, pm), LOSS_TOL,
                    G_FLOOR)
    assert platform.route_counts()["train:graph"] == STEPS - 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_replays_equal_eager_steps(self, cuda_device, arch):
        """Two eager steps from one state agree bit for bit (the control),
        and so do the graph route's calls and ``make_train_step``'s, with
        the same launch counts, no plain forward on the card and one
        recompute a mixer layer and step."""
        cfg, params, opt = _state(arch, device=cuda_device)
        batches = _batches(cfg, device=cuda_device)
        control, _ = _eager_steps(cfg, _clone(params), _clone(opt),
                                  batches[:1], _ts())
        platform.reset_launches()
        want, want_m = _eager_steps(cfg, _clone(params), _clone(opt),
                                    batches, _ts())
        torch.cuda.synchronize(cuda_device)
        counts = (platform.launch_counts(),
                  platform.plain_backward_on_cuda_counts())
        first, _ = _eager_steps(cfg, _clone(params), _clone(opt),
                                batches[:1], _ts())
        _same(first, control)
        platform.reset_launches()
        step, got_m = _graph_steps(cfg, params, opt, batches, _ts())
        torch.cuda.synchronize(cuda_device)
        assert (platform.launch_counts(),
                platform.plain_backward_on_cuda_counts()) == counts
        assert not platform.plain_on_cuda_counts()
        routes = platform.route_counts()
        assert (routes["train:eager"], routes["train:graph"]) == (
            1, STEPS - 1)
        _same(step.state, want)
        for g, w in zip(got_m, want_m):
            assert all(torch.equal(g[k], w[k]) for k in w)

    def test_driver_replays_every_step_after_the_first(self, cuda_device,
                                                       tmp_path):
        out = _drive_on(tmp_path, cuda_device)
        assert platform.route_counts()["train:graph"] == 5
        assert np.isfinite(out["losses"]).all()


def _drive_on(ckpt, device):
    platform.reset_launches()
    return ptrain.main([
        "--arch", "rwkv6-3b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt", str(ckpt), "--ckpt-every", "3",
        "--log-every", "50", "--device", str(device)])
