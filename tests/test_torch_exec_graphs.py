"""The probe executor's programs as CUDA graphs, captured once per bucket.

On a CUDA device the executor captures a bucket's program at its first
dispatch, after one warm-up whose result nobody sees, and answers every
dispatch, the first included, with replays (``exec.executor._Graph``): on
the scan route one Adam step captured over the descent's state and
replayed ``cfg.steps`` times, then a captured score; on the fused route
one graph for the whole program.  Batched evaluation
(``ProbeExecutor.eval_batch`` and ``MOOProblem.evaluate_batch``) is a
graph per structure and row bucket from the bucket's second call on.  On
this host there is no card:

* CPU dispatches build no graph, and run the eager closure as before.
* The graphs' bookkeeping is held here through the stand-in of
  ``tests/_graph_stand_in.py`` (its capture refuses what a CUDA capture
  refuses on a host sync): copy-in, the replays a dispatch, the launch
  counts deferred at capture and added at each replay (the step graph's
  ``cfg.steps`` times), two threads capturing once, LRU eviction, the
  fused route's one graph; batched evaluation's row buckets, padded and
  sliced, run eagerly at their first call and captured at their second,
  and two threads on one bucket each getting its own rows.
* The step counter gives the Adam steps of the per-step ``torch.tensor``
  bit for bit, and so does the in-place counter of the step graph.

The ``cuda`` cases need the card (skipped here from a fixture): a replay
equals the eager program bit for bit on ZDT1, a GP program, a ``use_std``
program, ``PlanModel`` and the fused Spark structure, and so do batched
evaluations; every dispatch is a replay, the descend launches are the
kernels that ran, two threads get the answers they get alone, and a
capture that syncs with the host raises.  This file imports no JAX, so on
the card it runs on its own::

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_exec_graphs.py
"""

from __future__ import annotations

import gc
import math
import sys
import threading

import numpy as np
import pytest
import torch

import repro_torch.core.synthetic as PS
from _graph_stand_in import cuda_device, eager as _eager, stand_in  # noqa: F401
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
from repro_torch.exec import tree_map
from repro_torch.exec.executor import adam_project_descend, step_counter
from repro_torch.kernels import graphs as graphs_mod
from repro_torch.kernels import platform
from repro_torch.kernels.mogd_descend import _adam_update
from repro_torch.models import MLPRegressor, MLPSpec, init_mlp
from repro_torch.models.gp import fit_gp

CPU = "cpu"
FAST = MOGDConfig(steps=4, multistart=2)


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


def _graphs(ex):
    return [g for prog in ex._programs.values() for g in prog.graphs.values()]


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

    @pytest.mark.parametrize("steps", [1, 7, 120, 1000])
    def test_in_place_counter_equals_step_counter(self, steps):
        """The step graph's counter: an fp32 0-d tensor from 1, ``t += 1``
        in place after each step."""
        want = step_counter(steps, CPU)
        t = torch.ones(())
        for i in range(steps):
            assert torch.equal(t, want[i])
            t.add_(1.0)

    def test_in_place_counter_is_exact_up_to_2_pow_24(self):
        t = torch.tensor(float(2 ** 24 - 8))
        for n in range(2 ** 24 - 8, 2 ** 24 + 1):
            assert torch.equal(t, torch.tensor(float(n)))
            t.add_(1.0)

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
        """The first dispatch: one warm-up, the step and score captured,
        and its answer a replay (the step graph ``cfg.steps`` times)."""
        ex = ProbeExecutor(device=CPU)
        req = _request(_zdt1_solver(ex), 3, 0)
        got = ex.solve_requests([req])
        want = _eager(stand_in, lambda: ProbeExecutor(
            device=CPU).solve_requests([req]))
        _same(got, want)
        (g,) = _graphs(ex)
        assert sorted(g.pieces) == ["score", "step"]
        assert g.pieces["step"].graph.replays == FAST.steps
        assert g.pieces["score"].graph.replays == 1
        assert g.steps_a_replay == 1
        assert 0 < g.nodes["step"] and 0 < g.nodes["score"]
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 1}
        assert len(stand_in.graphs) == 2

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
            assert Rp == 4 and g.pieces["score"].graph.replays == i + 1
            assert g.pieces["step"].graph.replays == (i + 1) * FAST.steps
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 4}
        assert g.pool_bytes == 0
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
        # the warm-up's and the captures' counts went nowhere; the first
        # dispatch's replays added the tallies (one other thread a capture)
        assert platform.launch_counts() == {"stand_in": n, "other": 2}
        for replays in (1, 2, 3):
            ex.solve_requests([_request(solver, 2, 1 + replays)])
            assert platform.launch_counts() == {
                "stand_in": n * (1 + replays), "other": 2}
            assert platform.route_counts() == {
                "stand_in:r": n * (1 + replays), "exec:eager": 1,
                "exec:graph": 1 + replays}

    def test_step_tally_added_steps_times_a_dispatch(self, stand_in):
        cfg = MOGDConfig(steps=7, multistart=2)
        ex = ProbeExecutor(device=CPU)
        solver = _counting_solver(ex)
        solver.config = cfg
        ex.solve_requests([_request(solver, 2, 0)])
        (g,) = _graphs(ex)
        step = sum(n for _, key, n in g.pieces["step"].tally
                   if key == "stand_in")
        score = sum(n for _, key, n in g.pieces["score"].tally
                    if key == "stand_in")
        assert step > 0 and score > 0
        assert platform.LAUNCHES["stand_in"] == cfg.steps * step + score
        assert g.pieces["step"].graph.replays == cfg.steps

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
        assert sorted(c.args["nodes"]) == ["score", "step"]
        assert c.args["steps_a_replay"] == 1
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
        assert len(stand_in.graphs) == 2  # one step, one score
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 2}
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
        assert platform.route_counts() == {"exec:eager": 3, "exec:graph": 3}
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
        assert g.pieces["score"].graph.replays == 4  # 2 dispatches, 2 shards
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 4}

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

    def test_fused_program_is_one_graph(self, stand_in, monkeypatch):
        """The fused route: the whole program one ``graphs.CallGraph``,
        captured once after one warm-up, every dispatch a replay of it.
        The descent's plain version stands in for the kernel, opaque to
        the capture as a CUDA kernel's launch is."""
        from torch.utils._python_dispatch import _disable_current_modes

        import repro_torch.kernels.mogd_descend as md

        plain = md.descend_batch

        def kernel(*args, **kwargs):
            with _disable_current_modes():
                return plain(*args, **kwargs)

        monkeypatch.setattr(md, "descend_batch", kernel)
        problem = as_problem(PS.mlp_surrogate_task(d=4, arch=(16, 16),
                                                   device=CPU))
        ex = ProbeExecutor(device=CPU, backend="fused")
        ref = ProbeExecutor(device=CPU, backend="fused")
        for seed in (0, 1, 2):
            req = _request(MOGDSolver(problem, FAST, executor=ex,
                                      device=CPU), 2, seed)
            _same(ex.solve_requests([req]),
                  _eager(stand_in, lambda: ref.solve_requests([req])))
        (g,) = _graphs(ex)
        assert ex.fused_dispatches == 3 and list(g.pieces) == ["program"]
        assert g.program.captured is g.pieces["program"]
        assert g.inputs is g.program.inputs
        assert g.pieces["program"].graph.replays == 3
        assert g.steps_a_replay == FAST.steps
        assert len(stand_in.graphs) == 1
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 3}

    def test_capture_seconds_by_route(self, stand_in):
        stand_in.capture_delay = 0.01
        ex = ProbeExecutor(device=CPU)
        ex.solve_requests([_request(_zdt1_solver(ex), 3, 0)])
        (g,) = _graphs(ex)
        assert dict(graphs_mod.CAPTURE_S) == {"exec": g.capture_s}
        assert g.capture_s >= 0.02  # two captures


# ---------------------------------------------------------------------------
# Batched evaluation: a graph a structure and row bucket
# ---------------------------------------------------------------------------


def _rows(N, D, seed):
    return torch.rand((N, D), generator=torch.Generator().manual_seed(seed))


def _padded(X, Np):
    return torch.cat([X, X[:1].expand(Np - X.shape[0], X.shape[1])])


class TestBatchedEvaluation:
    @pytest.mark.parametrize("N", [1, 3, 5, 8])
    def test_eval_batch_pads_to_its_bucket_and_slices(self, stand_in, N):
        """A bucket's first call runs eagerly on the padded rows, its
        second is captured and replayed: both the same bits."""
        prog = _mlp_program(4)
        ex = ProbeExecutor(device=CPU)
        X = _rows(N, 4, N)
        first = ex.eval_batch(prog, X)
        (rows,) = ex._evals.values()
        assert not rows.graphs
        got = ex.eval_batch(prog, X)
        want = _eager(stand_in, lambda: ex.eval_batch(prog, X))
        assert got.shape == want.shape == (N, 2)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        Np = executor_mod.bucket(N)
        assert list(rows.graphs) == [Np]
        static_x = rows.graphs[Np].leaves[-1]
        assert torch.equal(static_x, _padded(X, Np))  # row 0 repeated
        # the replay is the eager program on the padded rows, bit for bit
        full = _eager(stand_in, lambda: ex.eval_batch(prog, _padded(X, Np)))
        assert torch.equal(got, full[:N]) and torch.equal(first, got)
        assert platform.route_counts() == {
            "eval:first": 1, "eval:eager": 1, "eval:graph": 1}

    def test_a_bucket_is_captured_once_and_replayed(self, stand_in):
        prog = _mlp_program(4)
        ex = ProbeExecutor(device=CPU)
        for N in (3, 4, 5, 2, 8, 3):  # buckets 4, 4, 8, 2, 8, 4
            ex.eval_batch(prog, _rows(N, 4, N))
        (rows,) = ex._evals.values()
        assert sorted(rows.graphs) == [4, 8] and rows.seen == {2, 4, 8}
        assert platform.route_counts() == {
            "eval:first": 3, "eval:eager": 2, "eval:graph": 3}
        assert ex.eval_compiles == 1
        assert len(stand_in.graphs) == 2

    def test_a_one_shot_evaluation_captures_nothing(self, stand_in):
        """Calls in buckets of their own run eagerly on the padded rows:
        no warm-up, no capture, no graph memory held."""
        problem = PS.make_zdt1(d=6, device=CPU)
        for N in (3, 100, 1000):
            X = _rows(N, 6, N)
            got = problem.evaluate_batch(X)
            Np = executor_mod.bucket(N)
            full = _eager(stand_in, lambda: problem.evaluate_batch(
                _padded(X, Np)))
            assert torch.equal(got, full[:N])
        assert not problem._batch_rows.graphs and not stand_in.graphs
        assert platform.route_counts() == {"eval:first": 3}
        assert not graphs_mod.CAPTURE_S

    def test_eval_batch_of_no_rows_keeps_one_dummy_row(self, stand_in):
        prog = _mlp_program(4)
        ex = ProbeExecutor(device=CPU)
        for _ in range(2):
            out = ex.eval_batch(prog, torch.zeros((0, 4)))
            assert out.shape == (0, 2)
        (rows,) = ex._evals.values()
        assert list(rows.graphs) == [1]
        assert torch.equal(rows.graphs[1].leaves[-1], torch.zeros((1, 4)))

    @pytest.mark.parametrize("N", [3, 16, 100])
    def test_evaluate_batch_of_a_closure_problem(self, stand_in, N):
        problem = PS.make_zdt1(d=6, device=CPU)
        X = _rows(N, 6, N)
        first = problem.evaluate_batch(X)
        got = problem.evaluate_batch(X)
        want = _eager(stand_in, lambda: problem.evaluate_batch(X))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        Np = executor_mod.bucket(N)
        assert list(problem._batch_rows.graphs) == [Np]
        full = _eager(stand_in, lambda: problem.evaluate_batch(
            _padded(X, Np)))
        assert torch.equal(got, full[:N]) and torch.equal(first, got)
        assert problem.evaluate_batch(X[:0]).shape == (0, 2)
        assert platform.route_counts() == {
            "eval:first": 1, "eval:eager": 1, "eval:graph": 1}
        assert graphs_mod.CAPTURE_S["eval"] > 0.0

    def test_a_batched_evaluation_that_syncs_with_the_host_raises(
            self, stand_in):
        def fn(x):
            return torch.stack([x[0], x[1] + x.new_tensor(0.5)])

        base = PS.make_zdt1(d=3, device=CPU)
        problem = PS.MOOProblem(specs=base.specs, objectives=fn, k=2,
                                device=CPU)
        X = _rows(3, 3, 0)
        problem.evaluate_batch(X)  # the bucket's first call: eager
        for _ in range(2):  # its capture raises, with no eager answer
            with pytest.raises(RuntimeError) as err:
                problem.evaluate_batch(X)
            assert "CUDA graph capture of the batch function" in str(
                err.value)
            assert "new_tensor" in str(err.value)
        assert platform.route_counts() == {"eval:first": 1, "eval:eager": 2}

    @pytest.mark.parametrize("route", ["eval_batch", "evaluate_batch"])
    def test_two_threads_on_one_bucket_get_their_own_rows(
            self, stand_in, route):
        """Two threads replay one bucket with rows of their own, many
        times: each gets the answer it gets alone (the outputs are read
        under the graph's lock, before another replay overwrites them)."""
        if route == "eval_batch":
            prog = _mlp_program(4)
            ex = ProbeExecutor(device=CPU)

            def call(X):
                return ex.eval_batch(prog, X)
        else:
            problem = PS.make_zdt1(d=4, device=CPU)

            def call(X):
                return problem.evaluate_batch(X)

        Xs = [_rows(6, 4, seed) for seed in (1, 2)]
        alone = [_eager(stand_in, lambda: call(X)) for X in Xs]
        call(Xs[0])
        call(Xs[0])  # the bucket's graph
        bad = []

        def run(i):
            for _ in range(200):
                if not torch.equal(call(Xs[i]), alone[i]):
                    bad.append(i)

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert platform.route_counts()["eval:graph"] == 401


class TestCallGraph:
    def test_outputs_are_read_under_the_lock(self, stand_in):
        g = graphs_mod.CallGraph(lambda x: (x * 2.0, x + 1.0),
                                 torch.device(CPU), "test", "a test")
        x = torch.arange(4.0)
        held = []

        def read(out):
            held.append(g.lock.locked())
            return out[0][:2].clone()

        assert torch.equal(g(x, read=read), torch.tensor([0.0, 2.0]))
        outs = g(x + 1.0)  # the default read: a clone of each output
        assert torch.equal(outs[0], (x + 1.0) * 2.0)
        assert torch.equal(outs[1], x + 2.0)
        static = g.captured.outputs
        assert all(o.data_ptr() != s.data_ptr()
                   for o, s in zip(outs, static))
        g(x)
        assert torch.equal(outs[0], (x + 1.0) * 2.0)  # not overwritten
        assert held == [True]
        assert platform.route_counts() == {"test:eager": 1, "test:graph": 3}


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


def _mlp_program(D, device=CPU):
    """Two MLP regressors' stacked program (no std)."""
    return stack_programs([_mlp_regressor(s, D, device=device).as_program()
                           for s in (0, 1)])


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
        assert g.pieces["score"].graph.replays == 3
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 3}

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


def _spark_program(dev, seed):
    """The Spark task's paper-shape program: two MLPs (13 -> (128,)*4 ->
    1) with random weights."""
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
    return stack_programs([r.as_program() for r in regs])


def _spark_request(dev, seed, G=64, R=4, S=16, steps=120):
    """The Spark task's paper-shape structure: G groups (tenants) of R boxes
    of S starts."""
    from repro_torch.core.problem import SpaceEncoder
    from repro_torch.data.workloads import spark_space

    D = 13
    prog = _spark_program(dev, seed)
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
    if name == "plan_model":
        return _request(MOGDSolver(_plan_problem(dev),
                                   MOGDConfig(steps=80, multistart=8),
                                   executor=ex, device=dev), 4, seed)
    return _spark_request(dev, seed, G=8)


_PLANS = {}  # device -> qwen3-4b's plan problem at train_4k


def _plan_problem(dev):
    if dev not in _PLANS:
        from repro_torch.configs import get_config
        from repro_torch.nn import SHAPES
        from repro_torch.planner.planner import plan_task

        spec, _ = plan_task(get_config("qwen3-4b"), SHAPES["train_4k"],
                            device=dev)
        _PLANS[dev] = as_problem(spec)
    return _PLANS[dev]


def _same_tensors(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("name", ["zdt1", "gp_use_std", "mlp_use_std",
                                      "spark_fused", "plan_model"])
    def test_replay_equals_the_eager_program(self, cuda_device, name):
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        other = ProbeExecutor(device=cuda_device, mesh=None)
        for seed in (0, 1, 2):
            req = _card_request(name, ex, cuda_device, seed)
            got = ex.solve_requests([req])
            _same(got, ex.solve_requests([req]))  # again: the same bits
            (g,) = _graphs(ex)
            params, rows = tree_map(torch.clone, g.inputs)
            want = tuple(o.cpu() for o in g.fn(params, *rows))
            _same_tensors(g(params, rows), want)  # replay against eager
            if seed == 0:  # another executor's first dispatch
                _same(other.solve_requests([req]), got)
        assert g.capture_s > 0 and g.pool_bytes > 0
        assert platform.route_counts()["exec:eager"] == 2
        if name == "spark_fused":
            assert ex.fused_dispatches == 6 and list(g.pieces) == ["program"]
        else:
            assert sorted(g.pieces) == ["score", "step"]
            assert g.steps_a_replay == 1

    def test_second_dispatch_is_a_replay(self, cuda_device):
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        solver = MOGDSolver(PS.make_zdt1(d=6, device=cuda_device), FAST,
                            executor=ex, device=cuda_device)
        ex.solve_requests([_request(solver, 3, 0)])
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 1}
        ex.solve_requests([_request(solver, 3, 1)])
        assert platform.route_counts() == {"exec:eager": 1, "exec:graph": 2}

    def test_descend_launches_count_the_kernels_that_ran(self, cuda_device):
        ex = ProbeExecutor(device=cuda_device, mesh=None, backend="fused")
        for seed in range(4):
            ex.solve_requests([_spark_request(cuda_device, seed, G=4)])
        assert platform.launch_counts()["descend_batch"] == 4
        assert platform.route_counts() == {
            "descend_batch:resident": 4, "exec:eager": 1, "exec:graph": 4}

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
        assert platform.route_counts()["exec:graph"] == 2

    @pytest.mark.parametrize("N", [3, 100, 1000])
    def test_eval_batch_replay_equals_eager(self, cuda_device, N):
        prog = _spark_program(cuda_device, 0)
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        X = _rows(N, 13, N).to(cuda_device)
        first = ex.eval_batch(prog, X)  # eager, on the padded rows
        got = ex.eval_batch(prog, X)  # captured and replayed
        (rows,) = ex._evals.values()
        (graph,) = rows.graphs.values()
        leaves = [t.clone() for t in graph.leaves]
        Np = executor_mod.bucket(N)
        assert torch.equal(leaves[-1], _padded(X, Np))
        params = ex._params_to(prog.params)
        with torch.no_grad():
            padded = rows.fn(params, leaves[-1])
            alone = rows.fn(params, X)
        assert torch.equal(got, padded[:N]) and torch.equal(first, got)
        torch.testing.assert_close(got, alone, rtol=1e-6, atol=0.0)
        assert platform.route_counts() == {
            "eval:first": 1, "eval:eager": 1, "eval:graph": 1}

    @pytest.mark.parametrize("N", [3, 100, 1000])
    def test_evaluate_batch_replay_equals_eager(self, cuda_device, N):
        problem = PS.make_zdt1(d=6, device=cuda_device)
        X = _rows(N, 6, N).to(cuda_device)
        first = problem.evaluate_batch(X)
        got = problem.evaluate_batch(X)
        Np = executor_mod.bucket(N)
        with torch.no_grad():
            padded = problem._batch_fn(_padded(X, Np))
            alone = problem._batch_fn(X)
        assert torch.equal(got, padded[:N]) and torch.equal(first, got)
        torch.testing.assert_close(got, alone, rtol=1e-6, atol=0.0)
        assert platform.route_counts() == {
            "eval:first": 1, "eval:eager": 1, "eval:graph": 1}

    def test_two_threads_on_one_eval_bucket_get_their_own_rows(
            self, cuda_device):
        prog = _spark_program(cuda_device, 0)
        ex = ProbeExecutor(device=cuda_device, mesh=None)
        Xs = [_rows(1000, 13, seed).to(cuda_device) for seed in (1, 2)]
        # the bucket's first call (eager), then its second (the capture)
        alone = [ex.eval_batch(prog, X) for X in Xs]
        bad = []

        def run(i):
            for _ in range(200):
                if not torch.equal(ex.eval_batch(prog, Xs[i]), alone[i]):
                    bad.append(i)

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert platform.route_counts()["eval:graph"] == 401
