"""The probe executor's programs as CUDA graphs, captured once per bucket.

On a CUDA device the executor runs a bucket's first dispatch eagerly (the
warm-up), captures the program as a CUDA graph and replays it at every
later dispatch (``exec.executor._Graph``).  On this host there is no card:

* CPU dispatches build no graph, and run the eager closure as before.
* The graph's bookkeeping is held here through a stand-in for the graph
  (``torch.cuda.CUDAGraph`` and the stream calls replaced with
  ``monkeypatch``, and the executor told to capture on the host): copy-in,
  one replay a dispatch, the launch counts deferred at capture and added
  at each replay, two threads capturing once, LRU eviction.  The stand-in's
  capture refuses the operations a CUDA capture refuses on a host sync
  (``HOST_SYNC``: a constant copied from the host, a number read back),
  so the programs of the card's paths are held here to be capturable.
* The step counter gives the Adam steps of the per-step ``torch.tensor``
  bit for bit.

The ``cuda`` cases need the card (skipped here from a fixture): a replay
equals the eager program bit for bit on ZDT1, a GP program, a ``use_std``
program and the fused Spark structure, a second dispatch is a replay, the
descend launches are the kernels that ran, two threads get the answers
they get alone, and a capture that syncs with the host raises.  This file
imports no JAX, so on the card it runs on its own::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_exec_graphs.py
"""

from __future__ import annotations

import contextlib
import gc
import math
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.core.synthetic as PS
from repro_torch.core import MOGDConfig, MOGDSolver, as_problem
from repro_torch.core.dag import make_analytics_family
from repro_torch.data.workloads import (
    batch_problem,
    batch_suite,
    streaming_problem,
    streaming_suite,
)
from repro_torch.distributed import ProbeMesh
from repro_torch.exec import (
    ProbeExecutor,
    ProbeRequest,
    closure_program,
    stack_programs,
)
from repro_torch.exec import executor as executor_mod
from repro_torch.exec.executor import adam_project_descend, step_counter
from repro_torch.kernels import platform
from repro_torch.kernels.mogd_descend import _adam_update
from repro_torch.models import MLPRegressor, MLPSpec, init_mlp
from repro_torch.models.gp import fit_gp

CPU = "cpu"
FAST = MOGDConfig(steps=4, multistart=2)
# what a CUDA capture refuses: a constant built from host data (an
# upload), a number read back, and the ops whose output size the host
# must read
HOST_SYNC = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
             "nonzero", "masked_select", "_unique2", "unique_dim",
             "unique_consecutive", "equal", "is_nonzero"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's host-side work: the suite runs
    in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counts():
    platform.reset_launches()
    yield
    platform.reset_launches()


# ---------------------------------------------------------------------------
# The stand-in for a CUDA graph
# ---------------------------------------------------------------------------


class _RefuseHostSync(TorchDispatchMode):
    """Raise on the operations a CUDA stream capture cannot record."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_SYNC:
            raise RuntimeError(f"operation not permitted when stream is "
                               f"capturing: {func}")
        return func(*args, **(kwargs or {}))


class _Stream:
    def __init__(self, device=None):
        self.device = device

    def wait_stream(self, other):
        pass


class StandIn:
    """The graph objects and what they saw."""

    def __init__(self):
        self.graphs = []  # weak references to every graph made
        self.capture_delay = 0.0
        self.during_capture = None  # called inside each capture
        self.on = True  # the executor captures on the host

    def graph_type(self):
        stand_in = self

        class Graph:
            def __init__(self):
                self.replays = 0
                self.rerun = None
                self.mode = None
                stand_in.graphs.append(weakref.ref(self))

            def capture_begin(self, pool=None, capture_error_mode="global"):
                assert capture_error_mode == "thread_local"
                time.sleep(stand_in.capture_delay)
                if stand_in.during_capture is not None:
                    stand_in.during_capture()
                self.mode = _RefuseHostSync()
                self.mode.__enter__()

            def capture_end(self):
                self.mode.__exit__(None, None, None)

            def replay(self):
                self.replays += 1
                if self.rerun is not None:
                    self.rerun()

            def pool(self):
                return (0, id(self))

        return Graph


@pytest.fixture
def stand_in(monkeypatch):
    """Host dispatches take the graph path through the stand-in; a replay
    recomputes the program from the static inputs into the static outputs
    (what the captured kernels do on the card)."""
    s = StandIn()
    monkeypatch.setattr(executor_mod, "_captures", lambda device: s.on)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", s.graph_type())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream(device))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(executor_mod, "_pool_bytes", lambda graph, dev: 0)
    monkeypatch.setattr(executor_mod, "_SIDE_STREAMS", {})
    first = executor_mod._Graph._first

    def armed_first(self, params, rows, on_compile):
        out = first(self, params, rows, on_compile)

        def rerun():
            outs = self.fn(self.inputs[0], *self.inputs[1])
            for dst, src in zip(self.outputs, outs):
                dst.copy_(src)

        self.graph.rerun = rerun
        return out

    monkeypatch.setattr(executor_mod._Graph, "_first", armed_first)
    return s


def _graphs(ex):
    return [g for prog in ex._programs.values() for g in prog.graphs.values()]


def _eager(s: StandIn, fn):
    """``fn()`` with the executor's host path: no graph."""
    s.on = False
    try:
        return fn()
    finally:
        s.on = True


def _zdt1_solver(ex, cfg=FAST):
    return MOGDSolver(PS.make_zdt1(d=4, device=CPU), cfg, executor=ex,
                      device=CPU)


def _request(solver, B: int, seed: int, target: int = 0):
    rng = np.random.default_rng(seed)
    k = solver.problem.k
    x0s = rng.random((B, solver.config.multistart,
                      solver.problem.dim)).astype(np.float32)
    los = np.full((B, k), -1e3)
    his = np.full((B, k), 1e3)
    return solver._request(x0s, los, his, target)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# The step counter
# ---------------------------------------------------------------------------


class TestStepCounter:
    @pytest.mark.parametrize("steps", [1, 7, 120, 1000])
    def test_adam_steps_equal_per_step_tensors(self, steps):
        cfg = MOGDConfig(steps=steps)
        ts = step_counter(steps, CPU)
        assert ts.shape == (steps,) and ts.dtype == torch.float32
        g = torch.Generator().manual_seed(steps)
        x, m, v, grad = (torch.rand((5, 13), generator=g) for _ in range(4))
        for i in sorted({0, min(1, steps - 1), steps // 2, steps - 1}):
            want = _adam_update(x, m, v, grad, torch.tensor(
                i + 1.0, dtype=torch.float32), cfg)
            got = _adam_update(x, m, v, grad, ts[i], cfg)
            for a, b in zip(got, want):
                assert torch.equal(a, b)

    def test_descent_equals_the_per_step_tensor_loop(self):
        cfg = MOGDConfig(steps=40)
        target = torch.tensor([0.3, 0.8, 0.1])

        def loss(x):
            return torch.sum((x - target) ** 2) + torch.sin(3.0 * x).sum()

        x0 = torch.rand((6, 3), generator=torch.Generator().manual_seed(0))
        got = torch.func.vmap(
            lambda x: adam_project_descend(loss, x, cfg))(x0)

        def old(x0_):  # the loop before the step counter
            grad_fn = torch.func.grad(loss)
            x, m, v = x0_, torch.zeros_like(x0_), torch.zeros_like(x0_)
            for step in range(cfg.steps):
                t = torch.tensor(step + 1.0, dtype=torch.float32)
                g = grad_fn(x)
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                x, m, v = _adam_update(x, m, v, g, t, cfg)
            return x

        assert torch.equal(got, torch.func.vmap(old)(x0))


# ---------------------------------------------------------------------------
# The host: no graph
# ---------------------------------------------------------------------------


class TestHost:
    def test_cpu_dispatch_builds_no_graph(self):
        ex = ProbeExecutor(device=CPU)
        solver = _zdt1_solver(ex)
        req = _request(solver, 3, 0)
        first = ex.solve_requests([req])
        second = ex.solve_requests([req])
        _same(first, second)
        assert ex._programs and not _graphs(ex)
        assert not any(r.startswith("exec:") for r in platform.ROUTES)
        assert ex.stats()["compiles"] == 1 and ex.dispatches == 2

    def test_deferred_counts_go_to_the_tally_of_this_thread_only(self):
        seen = {}

        def other():
            platform.LAUNCHES["other"] += 1

        with platform.deferred_counts() as tally:
            platform.LAUNCHES["k"] += 1
            platform.ROUTES["k:r"] += 2
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            seen.update(platform.launch_counts())
        assert not t.is_alive()
        assert seen == {"other": 1}
        assert sorted((k, n) for _, k, n in tally) == [("k", 1), ("k:r", 2)]
        platform.add_counts(tally)
        platform.add_counts(tally)
        assert platform.launch_counts() == {"other": 1, "k": 2}
        assert platform.route_counts() == {"k:r": 4}


# ---------------------------------------------------------------------------
# The graph's bookkeeping, through the stand-in
# ---------------------------------------------------------------------------


def _counting_solver(ex):
    """A closure program whose every evaluation counts one launch of a
    kernel ``"stand_in"`` by route ``"stand_in:r"``, as a wrapper would."""
    def fn(x):
        platform.LAUNCHES["stand_in"] += 1
        platform.ROUTES["stand_in:r"] += 1
        return torch.stack([x[0], torch.sum((x - 0.5) ** 2)])

    problem = PS.make_zdt1(d=3, device=CPU)
    problem = PS.MOOProblem(specs=problem.specs, objectives=fn, k=2,
                            device=CPU)
    return MOGDSolver(problem, FAST, executor=ex, device=CPU)


class TestGraphBookkeeping:
    def test_first_dispatch_warms_up_and_captures(self, stand_in):
        ex = ProbeExecutor(device=CPU)
        req = _request(_zdt1_solver(ex), 3, 0)
        got = ex.solve_requests([req])
        want = _eager(stand_in, lambda: ProbeExecutor(
            device=CPU).solve_requests([req]))
        _same(got, want)
        (g,) = _graphs(ex)
        assert g.graph is not None and g.graph.replays == 0
        assert platform.route_counts() == {"exec:eager": 1}
        assert len(stand_in.graphs) == 1

    def test_replays_copy_inputs_in_and_equal_the_eager_program(
            self, stand_in):
        ex = ProbeExecutor(device=CPU)
        ref = ProbeExecutor(device=CPU)
        solver = _zdt1_solver(ex)
        for i in range(4):
            req = _request(solver, 3, i, target=i % 2)
            got = ex.solve_requests([req])
            _same(got, _eager(stand_in, lambda: ref.solve_requests([req])))
            (g,) = _graphs(ex)
            Rp = g.inputs[1][0].shape[1]
            np.testing.assert_array_equal(
                g.inputs[1][0][0, :3].numpy(), req.x0s)
            assert torch.equal(g.inputs[1][-1][0, :3],
                               torch.full((3,), i % 2))
            assert Rp == 4 and g.graph.replays == i
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 3}
        assert g.graph.replays == 3 and g.pool_bytes == 0
        assert 0.0 <= g.instantiate_s <= g.capture_s

    def test_launch_counts_deferred_at_capture_and_added_per_replay(
            self, stand_in):
        ref = ProbeExecutor(device=CPU)
        req = _request(_counting_solver(ref), 2, 0)
        _eager(stand_in, lambda: ref.solve_requests([req]))
        n = platform.LAUNCHES["stand_in"]  # one run's launches
        assert n > 0
        platform.reset_launches()

        def other_thread():  # counts while this thread captures
            t = threading.Thread(
                target=lambda: platform.LAUNCHES.update({"other": 1}))
            t.start()
            t.join(timeout=10)

        stand_in.during_capture = other_thread
        ex = ProbeExecutor(device=CPU)
        solver = _counting_solver(ex)
        ex.solve_requests([_request(solver, 2, 1)])
        # the warm-up ran; the capture ran nothing
        assert platform.launch_counts() == {"stand_in": n, "other": 1}
        (g,) = _graphs(ex)
        g.graph.rerun = None  # a replay runs no Python: count it alone
        for replays in (1, 2, 3):
            ex.solve_requests([_request(solver, 2, 1 + replays)])
            assert platform.launch_counts() == {
                "stand_in": n * (1 + replays), "other": 1}
            assert platform.route_counts() == {
                "stand_in:r": n * (1 + replays), "exec:eager": 1,
                "exec:graph": replays}

    def test_one_compile_span_a_capture(self, stand_in):
        from repro_torch.obs import Observability

        ex = ProbeExecutor(device=CPU, obs=Observability(trace=True))
        solver = _zdt1_solver(ex)
        for seed in range(3):
            ex.solve_requests([_request(solver, 3, seed)])
        spans = ex.obs.tracer.spans()
        compiles = [sp for sp in spans if sp.name == "exec.compile"]
        dispatches = [sp for sp in spans if sp.name == "exec.dispatch"]
        assert len(compiles) == 1 and len(dispatches) == 3
        (c,) = compiles
        assert c.args["bucket"] == [1, 4] and "capture_s" in c.args
        # the build, warm-up and capture lie inside the first dispatch's call
        assert c.t1 <= dispatches[0].t1

    def test_two_threads_on_one_bucket_capture_once(self, stand_in):
        stand_in.capture_delay = 0.2
        ex = ProbeExecutor(device=CPU)
        ref = ProbeExecutor(device=CPU)
        solver = _zdt1_solver(ex)
        reqs = [_request(solver, 3, seed) for seed in (10, 11)]
        got = [None, None]

        def run(i):
            got[i] = ex.solve_requests([reqs[i]])

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(stand_in.graphs) == 1
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 1}
        for i in (0, 1):
            _same(got[i], _eager(
                stand_in, lambda: ref.solve_requests([reqs[i]])))

    def test_lru_eviction_drops_the_graph(self, stand_in):
        ex = ProbeExecutor(device=CPU, max_programs=1)
        solver = _zdt1_solver(ex)
        ex.solve_requests([_request(solver, 1, 0)])  # bucket (1, 1)
        key_a = next(iter(ex._programs))
        graph_a = stand_in.graphs[0]
        assert graph_a() is not None
        ex.solve_requests([_request(solver, 8, 1)])  # bucket (1, 8)
        assert key_a not in ex._programs and len(ex._programs) == 1
        gc.collect()
        assert graph_a() is None
        ex.solve_requests([_request(solver, 1, 2)])  # built anew
        assert platform.route_counts() == {"exec:eager": 3}
        assert ex.stats()["compiles"] == 3

    def test_mesh_shards_on_one_device_share_one_graph(self, stand_in):
        ex = ProbeExecutor(mesh=ProbeMesh([CPU] * 2), device=CPU)
        ref = ProbeExecutor(mesh=ProbeMesh([CPU] * 2), device=CPU)
        solver = _zdt1_solver(ex)
        for seed in (0, 1):
            req = _request(solver, 4, seed)
            _same(ex.solve_requests([req]),
                  _eager(stand_in, lambda: ref.solve_requests([req])))
        assert ex.sharded_dispatches == 2
        (g,) = _graphs(ex)
        assert g.graph.replays == 3  # the first shard warmed up, captured
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 3}

    def test_a_capture_that_syncs_with_the_host_raises(self, stand_in):
        def fn(x):  # a constant uploaded from the host at every call
            return torch.stack([x[0], x[1] + x.new_tensor(0.5)])

        ex = ProbeExecutor(device=CPU)
        problem = PS.make_zdt1(d=3, device=CPU)
        problem = PS.MOOProblem(specs=problem.specs, objectives=fn, k=2,
                                device=CPU)
        solver = MOGDSolver(problem, FAST, executor=ex, device=CPU)
        req = _request(solver, 2, 0)
        for _ in range(2):  # no eager answer in the graph's place, ever
            with pytest.raises(RuntimeError) as err:
                ex.solve_requests([req])
            msg = str(err.value)
            assert "CUDA graph capture of structure" in msg
            assert "test_torch_exec_graphs.py" in msg and "new_tensor" in msg
        assert platform.route_counts() == {"exec:eager": 2}
        assert ex.dispatches == 0


# ---------------------------------------------------------------------------
# The programs of the card's paths capture
# ---------------------------------------------------------------------------


def _mlp_regressor(seed, D, dropout=0.0, device=CPU):
    spec = MLPSpec(D, (16, 16), 1)
    gen = torch.Generator().manual_seed(seed)
    return MLPRegressor(
        spec=spec, params=init_mlp(gen, spec, device=device),
        x_mean=torch.full((D,), 0.5, device=device),
        x_std=torch.full((D,), 0.29, device=device),
        y_mean=torch.tensor(math.log(2.0), device=device),
        y_std=torch.tensor(0.5, device=device),
        dropout=dropout, log_target=True)


def _gp_regressor(seed, D, device=CPU):
    rng = np.random.default_rng(seed)
    X = rng.random((24, D))
    y = 1.0 + np.sin(3.0 * X).sum(1)
    return fit_gp(X, y, log_target=True, device=device)


def _std_program(name, D, device=CPU):
    """Two regressors' stacked program with its std (MC dropout or GP)."""
    regs = ([_mlp_regressor(s, D, 0.1, device) for s in (0, 1)]
            if name == "mlp_use_std"
            else [_gp_regressor(s, D, device) for s in (0, 1)])
    return stack_programs([r.as_program() for r in regs])


def _std_request(program, encoder, B, seed):
    rng = np.random.default_rng(seed)
    D = encoder.dim
    return ProbeRequest(
        program=program, encoder=encoder, cfg=FAST,
        x0s=rng.random((B, FAST.multistart, D)).astype(np.float32),
        los=np.full((B, 2), -1e3), his=np.full((B, 2), 1e3),
        targets=np.zeros(B, np.int32),
        alphas=np.full((B, 2), 0.5, np.float32), use_std=True)


def _case(name):
    """``(executor kwargs, request maker)`` for one program of a card path."""
    if name in ("mlp_use_std", "gp_use_std"):
        enc = as_problem(PS.mlp_surrogate_task(d=4, device=CPU)).encoder
        prog = _std_program(name, enc.dim)
        return {}, lambda ex, seed: _std_request(prog, enc, 2, seed)
    if name == "mlp_scan":  # the stacked-MLP structure on the scan path
        problem = as_problem(PS.mlp_surrogate_task(d=4, arch=(16, 16),
                                                   device=CPU))
        return {"backend": "jnp"}, lambda ex, seed: _request(
            MOGDSolver(problem, FAST, executor=ex, device=CPU), 2, seed)
    if name == "plan_model":
        from repro_torch.configs import get_config
        from repro_torch.nn import SHAPES
        from repro_torch.planner.planner import plan_task

        spec, _ = plan_task(get_config("qwen3-4b"), SHAPES["train_4k"],
                            device=CPU)
        problem = as_problem(spec)
    elif name == "zdt1":
        problem = PS.make_zdt1(d=6, device=CPU)
    elif name == "mixed":
        problem = PS.make_mixed_problem(device=CPU)
    elif name == "batch_closure":
        problem = batch_problem(batch_suite()[0], device=CPU)
    elif name == "streaming_closure":
        problem = streaming_problem(streaming_suite()[0], k=3, device=CPU)
    elif name == "etl_stage":
        fam = make_analytics_family(device=CPU)
        problem = as_problem(fam.stage("extract", (3.0, 0.4, 0.3, 0.6)).task)
    else:
        raise KeyError(name)
    return {}, lambda ex, seed: _request(
        MOGDSolver(problem, FAST, executor=ex, device=CPU), 2, seed)


CASES = ["zdt1", "mixed", "batch_closure", "streaming_closure", "etl_stage",
         "plan_model", "mlp_scan", "mlp_use_std", "gp_use_std"]


class TestCardPathsCapture:
    @pytest.mark.parametrize("name", CASES)
    def test_program_captures_and_replays_as_eager(self, stand_in, name):
        kwargs, make = _case(name)
        ex = ProbeExecutor(device=CPU, **kwargs)
        ref = ProbeExecutor(device=CPU, **kwargs)
        for seed in (0, 1, 2):
            req = make(ex, seed)
            _same(ex.solve_requests([req]),
                  _eager(stand_in, lambda: ref.solve_requests([req])))
        (g,) = _graphs(ex)
        assert g.graph.replays == 2
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 2}

    def test_oriented_program_fills_its_signs_on_the_device(self, stand_in):
        from repro_torch.exec import orient_program

        base = closure_program(lambda x: torch.stack([x[0], x[1]]), "pair")
        prog = orient_program(base, (1.0, -1.0))
        enc = as_problem(PS.sphere2_task(d=3, device=CPU)).encoder
        ex = ProbeExecutor(device=CPU)
        ref = ProbeExecutor(device=CPU)
        for seed in (0, 1):
            rng = np.random.default_rng(seed)
            req = ProbeRequest(
                program=prog, encoder=enc, cfg=FAST,
                x0s=rng.random((2, 2, enc.dim)).astype(np.float32),
                los=np.full((2, 2), -1e3), his=np.full((2, 2), 1e3),
                targets=np.zeros(2, np.int32))
            got = ex.solve_requests([req])
            _same(got, _eager(stand_in, lambda: ref.solve_requests([req])))
            np.testing.assert_array_equal(got[1][:, 1], -got[0][:, 1])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip on hosts without one (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (CUDA unavailable here)")
    return torch.device("cuda", 0)


def _spark_request(dev, seed, G=64, R=4, S=16, steps=120):
    """The Spark task's paper-shape structure: G groups (tenants) of R boxes
    of S starts, two MLPs (13 -> (128,)*4 -> 1) with random weights."""
    from repro_torch.data.workloads import spark_space
    from repro_torch.exec import tree_map

    D = 13
    regs = []
    for j, y_mean in enumerate((math.log(60.0), math.log(2.0))):
        spec = MLPSpec(D, (128,) * 4, 1)
        gen = torch.Generator().manual_seed(1000 * seed + j)
        regs.append(MLPRegressor(
            spec=spec, params=init_mlp(gen, spec, device=dev),
            x_mean=torch.full((D,), 0.5, device=dev),
            x_std=torch.full((D,), 0.29, device=dev),
            y_mean=torch.tensor(y_mean, device=dev),
            y_std=torch.tensor(0.5, device=dev), dropout=0.0,
            log_target=True))
    prog = stack_programs([r.as_program() for r in regs])
    from repro_torch.core.problem import SpaceEncoder

    enc = SpaceEncoder(list(spark_space()))
    rng = np.random.default_rng(seed)
    B = G * R
    params_b = tree_map(lambda a: a[None].expand(B, *a.shape).clone(),
                        prog.params)
    cfg = MOGDConfig(steps=steps, multistart=S)
    lo = rng.uniform(0.5, 5.0, (B, 2))
    return ProbeRequest(
        program=prog, encoder=enc, cfg=cfg,
        x0s=rng.random((B, S, D)).astype(np.float32), los=lo,
        his=lo + rng.uniform(1.0, 50.0, (B, 2)),
        targets=rng.integers(0, 2, B).astype(np.int32), params_b=params_b)


def _card_request(name, ex, dev, seed):
    if name == "zdt1":
        return _request(MOGDSolver(PS.make_zdt1(d=6, device=dev),
                                   MOGDConfig(steps=120, multistart=8),
                                   executor=ex, device=dev), 8, seed)
    if name in ("gp_use_std", "mlp_use_std"):
        enc = as_problem(PS.mlp_surrogate_task(d=4, device=CPU)).encoder
        return _std_request(_std_program(name, enc.dim, dev), enc, 4, seed)
    return _spark_request(dev, seed, G=8)


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("name", ["zdt1", "gp_use_std", "mlp_use_std",
                                      "spark_fused"])
    def test_replay_equals_the_eager_program(self, cuda_device, name):
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        for seed in (0, 1, 2):
            req = _card_request(name, ex, cuda_device, seed)
            got = ex.solve_requests([req])
            # a fresh executor's first dispatch is the eager program
            want = ProbeExecutor(device=cuda_device,
                                 mesh=None).solve_requests([req])
            _same(got, want)
        (g,) = _graphs(ex)
        assert g.capture_s > 0 and g.pool_bytes > 0
        assert platform.route_counts()["exec:graph"] == 2
        if name == "spark_fused":
            assert ex.fused_dispatches == 3

    def test_second_dispatch_is_a_replay(self, cuda_device):
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        solver = MOGDSolver(PS.make_zdt1(d=6, device=cuda_device), FAST,
                            executor=ex, device=cuda_device)
        ex.solve_requests([_request(solver, 3, 0)])
        assert platform.route_counts() == {"exec:eager": 1}
        ex.solve_requests([_request(solver, 3, 1)])
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 1}

    def test_descend_launches_count_the_kernels_that_ran(self, cuda_device):
        ex = ProbeExecutor(device=cuda_device, mesh=None, backend="fused")
        for seed in range(4):
            ex.solve_requests([_spark_request(cuda_device, seed, G=4)])
        assert platform.launch_counts()["descend_batch"] == 4
        assert platform.route_counts() == {
            "descend_batch:resident": 4, "exec:eager": 1, "exec:graph": 3}

    def test_two_threads_get_the_answers_they_get_alone(self, cuda_device):
        reqs = [_spark_request(cuda_device, seed, G=4) for seed in (5, 6)]
        alone = []
        for req in reqs:
            ex = ProbeExecutor(device=cuda_device, mesh=None)
            ex.solve_requests([req])  # warm-up and capture
            alone.append(ex.solve_requests([req]))  # a replay
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        got = [None, None]

        def run(i):
            for _ in range(3):
                got[i] = ex.solve_requests([reqs[i]])

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for i in (0, 1):
            _same(got[i], alone[i])
        assert len(_graphs(ex)) == 1

    def test_a_capture_that_syncs_with_the_host_raises(self, cuda_device):
        def fn(x):
            return torch.stack([x[0], x[1] + x.new_tensor(0.5)])

        problem = PS.make_zdt1(d=3, device=cuda_device)
        problem = PS.MOOProblem(specs=problem.specs, objectives=fn, k=2,
                                device=cuda_device)
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        solver = MOGDSolver(problem, FAST, executor=ex, device=cuda_device)
        with pytest.raises(RuntimeError, match="CUDA graph capture of"):
            ex.solve_requests([_request(solver, 2, 0)])
        assert ex.dispatches == 0
        # the card still serves a capturable program afterwards
        ok = MOGDSolver(PS.make_zdt1(d=3, device=cuda_device), FAST,
                        executor=ex, device=cuda_device)
        for seed in (0, 1):
            ex.solve_requests([_request(ok, 2, seed)])
        assert platform.route_counts()["exec:graph"] == 1
