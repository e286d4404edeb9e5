"""The port's twins of the serving-plane examples ``adaptive_tuning``,
``budget_tuning``, ``warm_restart``, ``trace_serving`` and ``serve_moo``, on
the CPU, held to the reference examples.

The reference side runs the reference example's own ``main`` and reads
what it prints where the example has a ``main`` and prints what is
compared (``adaptive_tuning``, ``budget_tuning``, ``warm_restart``);
otherwise it calls the reference's APIs with the example's arguments
(``trace_serving``, whose full metric names it does not print, and
``serve_moo``, which works at module level).  What is held, by twin:

* ``adaptive_tuning``: exactly, the registry's event sequence (kinds and
  versions) and where each event falls among the shifted batches, drift
  included.  Trained weights decide when a retrain's candidate is
  promoted, so this run replays the reference's draws in ``fit_mlp`` (its
  initial weights and dropout masks) and in MOGD; run as a user runs it
  (its own draws), the contract: drift on a shifted batch, versions
  promoted in order, the frontier invalidated once and re-solved warm.
* ``budget_tuning``: the example's own ``assert`` (the routed spend under
  the uniform one); the bandit's grants, round by round and tenant by
  tenant, equal to the reference's, the deadline-guarded tenant's its full
  ``batch_rects`` from the second round on; ``stats()["budget"]``'s
  ``rounds`` and ``rects_legacy`` exactly.  Its own draws: the grants and
  counters held do not depend on them.
* ``warm_restart``: ``vault_snapshots``, ``vault_restores``,
  ``vault_seeds`` and ``vault_tombstones`` exactly, and generation 2's
  first ``recommend`` from disk with 0 executor dispatches, equal to
  generation 1's.  Its own draws, for the same reason.
* ``trace_serving``: the set of Prometheus metric names exactly, and the
  set of span names exactly but for the port's one addition,
  ``exec.parity_gate`` (the fused-descent parity gate's span, which the
  reference does not record); every breakdown sums to its e2e within
  1e-6 s; the trace file is JSON.
* ``serve_moo``: clock-free facts only (the reference sheds every ticket
  on a host where its first compile outlasts the 5 s SLO): every ticket in
  a final state, ``admitted + rejected`` equal to the tickets submitted,
  4 sessions as the reference's, the burst rejected at submit.  No
  deadline is asserted.

Each twin ends with ``{"launches": {}, "plain_on_cuda": {}}`` here: on the
host every wrapper takes its plain version and launches nothing.  No size
is cut: every run is at the example's own settings.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.service as JSV
import repro_torch.core as P
import repro_torch.models.train as PT
from repro.core.problem import SpaceEncoder as JSpaceEncoder
from repro.core.synthetic import mlp_surrogate_task as j_mlp_surrogate_task
from repro.alloc import GainBanditPolicy as JGainBanditPolicy
from repro.frontdesk import FrontDesk as JFrontDesk
from repro.models.mlp import MLPSpec as JMLPSpec
from repro.models.mlp import init_mlp as j_init_mlp
from repro.obs import Observability as JObservability
from repro_torch.alloc import GainBanditPolicy
import repro_torch.frontdesk.plane as PLANE
from repro_torch.core.problem import MOOProblem
from repro_torch.frontdesk import DONE, REJECTED, SHED

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
NO_LAUNCHES = {"launches": {}, "plain_on_cuda": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def own_tmp(monkeypatch, tmp_path):
    """Temporary files and directories of the examples go under
    ``tmp_path``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def load(rel: str):
    """A script as a module (its ``__main__`` block is not run)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_draws(monkeypatch):
    """Make the port draw the reference's numbers: every MOGD solver
    replays the reference solver's key stream, and problem sampling the
    reference's ``PRNGKey(seed)`` uniforms (``tests/test_torch_pf.py``'s
    helper)."""

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


def _reference_training(monkeypatch):
    """Make ``fit_mlp`` draw the reference's numbers: the He-init from
    ``split(PRNGKey(seed))[1]`` and each step's dropout masks from the
    reference's key chain (one split a step, one a hidden layer, a
    Bernoulli keep mask of the layer's shape)."""
    forward = PT.mlp_forward
    chains = {}

    def init_mlp(generator, spec, device=None):
        key = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))[1]
        layers = j_init_mlp(key, JMLPSpec(in_dim=spec.in_dim,
                                          hidden=spec.hidden,
                                          out_dim=spec.out_dim))
        return [{k: torch.as_tensor(np.array(v), device=device)
                 for k, v in layer.items()} for layer in layers]

    def mlp_forward(params, x, *, dropout=0.0, generator=None, masks=None):
        if generator is None or dropout <= 0.0:
            return forward(params, x, dropout=dropout, generator=generator,
                           masks=masks)
        chain = chains.get(id(generator))
        if chain is None or chain[0] is not generator:
            # the fit's drop generator is seeded seed + 1; the reference's
            # chain starts at PRNGKey(seed), past the init split
            key = jax.random.split(
                jax.random.PRNGKey(generator.initial_seed() - 1))[0]
            chain = chains[id(generator)] = [generator, key]
        chain[1], sub = jax.random.split(chain[1])
        keep = []
        for layer in params[:-1]:
            sub, draw = jax.random.split(sub)
            keep.append(torch.as_tensor(np.array(jax.random.bernoulli(
                draw, 1.0 - dropout, (x.shape[0], layer["w"].shape[1])))))
        return forward(params, x, dropout=dropout, masks=keep)

    monkeypatch.setattr(PT, "init_mlp", init_mlp)
    monkeypatch.setattr(PT, "mlp_forward", mlp_forward)


def _lines(capsys) -> list[str]:
    return capsys.readouterr().out.strip().splitlines()


# ---------------------------------------------------------------------------
# 7. examples/adaptive_tuning.py
# ---------------------------------------------------------------------------


def _timeline(lines) -> list[str]:
    """The registry's events in print order, with one ``batch`` mark after
    each shifted batch's ``recommend``."""
    out = []
    for line in lines:
        if "[event]" in line:
            out.append(line.strip())
        elif line.strip().startswith("recommend (never blocks)"):
            out.append("batch")
    return out


class TestAdaptiveTuning:
    def test_events_equal_the_reference_examples(self, monkeypatch, capsys):
        load("examples/adaptive_tuning.py").main()
        want = _timeline(_lines(capsys))
        _reference_training(monkeypatch)
        _reference_draws(monkeypatch)
        out = load("examples/torch_adaptive_tuning.py").main(["--device",
                                                              CPU])
        lines = _lines(capsys)
        assert json.loads(lines[-1]) == NO_LAUNCHES
        assert _timeline(lines) == want
        assert "[event] drift v2" in want  # the shift is seen

    def test_runs_as_a_user_runs_it(self, capsys):
        out = load("examples/torch_adaptive_tuning.py").main(["--device",
                                                              CPU])
        assert json.loads(_lines(capsys)[-1]) == NO_LAUNCHES
        kinds = [k for k, _ in out["events"]]
        assert kinds.count("drift") >= 1 and out["drift_batches"]
        versions = [v for k, v in out["events"] if k == "version"]
        assert versions == list(range(1, len(versions) + 1))
        assert len(versions) >= 3  # v1, the explicit retrain, post-drift
        assert out["stale"][out["drift_batches"][0]]
        assert out["stats"]["frontier_invalidations"] == 1
        assert out["stats"]["warm_resolves"] == 1
        assert out["stats"]["stale_sessions"] == 0
        assert np.isfinite(out["true_f"]).all()


# ---------------------------------------------------------------------------
# 8. examples/budget_tuning.py
# ---------------------------------------------------------------------------


def _spy_grants(monkeypatch, policy_cls) -> list:
    """Record each round's grants of ``policy_cls.allocate``: session id ->
    rectangles granted."""
    grants = []
    allocate = policy_cls.allocate

    def spy(self, candidates):
        decided = allocate(self, candidates)
        grants.append({c.session_id: decided.get(c.session_id,
                                                 c.batch_rects)
                       for c in candidates})
        return decided

    monkeypatch.setattr(policy_cls, "allocate", spy)
    return grants


class TestBudgetTuning:
    def test_budget_equals_the_reference_examples(self, monkeypatch,
                                                  capsys):
        """The bandit's grants, round by round, equal the reference's; the
        deadline-guarded tenant keeps its full ``batch_rects`` from the
        second round on (both packages grant it 1 in the first)."""
        want_grants = _spy_grants(monkeypatch, JGainBanditPolicy)
        load("examples/budget_tuning.py").main()
        ref = next(line for line in _lines(capsys)
                   if line.startswith("budget: "))
        want = dict(re.findall(r"(\w+)=(\w+)", ref))
        grants = _spy_grants(monkeypatch, GainBanditPolicy)
        out = load("examples/torch_budget_tuning.py").main(["--device", CPU])
        assert json.loads(_lines(capsys)[-1]) == NO_LAUNCHES
        b = out["budget"]
        assert b["policy"] == want["policy"] == "gain_bandit"
        assert b["rounds"] == int(want["rounds"]) == len(grants)
        assert b["rects_legacy"] == int(want["legacy"])
        # the example's assert: the routed schedule spends less
        assert sum(out["spent"]) < out["legacy"] * 4
        assert grants == want_grants
        assert all(g["sess-3"] == 3 for g in grants[1:])


# ---------------------------------------------------------------------------
# 9. examples/warm_restart.py
# ---------------------------------------------------------------------------


def _ints(pattern: str, text: str) -> tuple:
    return tuple(int(v) for v in re.search(pattern, text).groups())


class TestWarmRestart:
    def test_vault_counters_equal_the_reference_examples(self, own_tmp,
                                                         capsys):
        load("examples/warm_restart.py").main()
        text = "\n".join(_lines(capsys))
        want = {"snapshots": _ints(r"vault snapshots: (\d+)", text)[0],
                "gen2": _ints(r"restores=(\d+) executor_dispatches=(\d+)",
                              text),
                "tombstones": _ints(r"tombstones: (\d+)", text)[0],
                "gen3": _ints(r"restores=(\d+) seeds=(\d+)", text)}
        out = load("examples/torch_warm_restart.py").main(["--device", CPU])
        assert json.loads(_lines(capsys)[-1]) == NO_LAUNCHES
        assert out["gen1"]["stats"]["vault_snapshots"] == want["snapshots"]
        st2 = out["gen2"]["stats"]
        assert (st2["vault_restores"], st2["executor_dispatches"]) == want[
            "gen2"] == (1, 0)
        np.testing.assert_array_equal(out["gen2"]["objectives"],
                                      out["gen1"]["objectives"])
        assert out["drift"]["stats"]["vault_tombstones"] == want[
            "tombstones"]
        assert out["drift"]["surviving"] is None
        st3 = out["gen3"]["stats"]
        assert (st3["vault_restores"], st3["vault_seeds"]) == want["gen3"]
        assert out["drift_after"] is not None
        # the twin removes its vault; the reference example leaves its own
        assert len(list(own_tmp.glob("vault_demo_*"))) == 1


# ---------------------------------------------------------------------------
# 10. examples/trace_serving.py
# ---------------------------------------------------------------------------


def _metric_names(prom: str) -> set[str]:
    return {line.split("{")[0].split()[0] for line in prom.splitlines()
            if line and not line.startswith("#")}


def _j_trace_serving() -> tuple:
    """``examples/trace_serving.py:25-37`` on the reference: (span names,
    Prometheus text)."""
    obs = JObservability(trace=True)
    svc = JSV.MOOService(mogd=J.MOGDConfig(steps=24, multistart=4),
                         batch_rects=2, grid_l=2, obs=obs)
    with JFrontDesk(svc, capacity=32) as desk:
        tickets = [desk.submit(spec=j_mlp_surrogate_task(seed=i % 4),
                               n_probes=8, slo="batch") for i in range(12)]
        desk.drain(timeout=60.0)
    assert all(t.ok for t in tickets)
    return ({s.name for s in obs.tracer.spans()},
            obs.metrics.to_prometheus())


class TestTraceServing:
    def test_names_equal_the_reference_examples(self, own_tmp, capsys):
        out = load("examples/torch_trace_serving.py").main(["--device", CPU])
        path = Path(out["trace"])
        assert path.parent == own_tmp
        assert json.loads(_lines(capsys)[-1]) == NO_LAUNCHES
        want_spans, want_prom = _j_trace_serving()
        assert set(out["span_names"]) - {"exec.parity_gate"} == want_spans
        assert "exec.parity_gate" in out["span_names"]
        assert _metric_names(out["prometheus"]) == _metric_names(want_prom)
        assert all(t.ok for t in out["tickets"])
        for b in out["breakdowns"]:
            assert abs(b["accounted_s"] - b["e2e_s"]) < 1e-6
        events = json.loads(path.read_text())["traceEvents"]
        assert {e["name"] for e in events if e["ph"] == "X"} == set(
            out["span_names"])


# ---------------------------------------------------------------------------
# 11. examples/serve_moo.py
# ---------------------------------------------------------------------------


def _j_serve_moo_sessions() -> int:
    """``examples/serve_moo.py:34-67`` on the reference: the sessions the
    twelve standard tickets open."""
    specs = [J.integer("cores", 4, 64), J.continuous("mem_fraction", 0.2, 0.9)]
    enc = JSpaceEncoder(specs)

    def make_task(scale):
        import jax.numpy as jnp

        def objectives(x):
            cfg = enc.decode_soft(x)
            lat = scale * 120.0 / cfg["cores"] ** 0.9 + 2.0 * (1 - cfg["mem_fraction"])
            cost = cfg["cores"] * 0.02 * (1.0 + 0.1 * cfg["mem_fraction"])
            return jnp.stack([lat, cost])

        return JSV.TaskSpec(knobs=specs,
                            objectives=(JSV.Objective("latency_s"),
                                        JSV.Objective("cost_usd")),
                            model=objectives, preference=JSV.UtopiaNearest(),
                            name="etl")

    svc = JSV.MOOService(mogd=J.MOGDConfig(steps=32, multistart=4),
                         batch_rects=1)
    with JFrontDesk(svc, capacity=16) as desk:
        tickets = [desk.submit(spec=make_task(1.0 + s), slo="standard",
                               n_probes=8)
                   for s in range(4) for _consumer in range(3)]
        for t in tickets:
            t.wait(timeout=60.0)
        return desk.stats()["sessions"]


class TestServeMoo:
    def test_clock_free_facts_equal_the_reference_examples(self, capsys):
        out = load("examples/torch_serve_moo.py").main(["--device", CPU])
        assert json.loads(_lines(capsys)[-1]) == NO_LAUNCHES
        assert out["first"]["sessions"] == _j_serve_moo_sessions() == 4
        every = [*out["tickets"], out["vip"], *out["burst"]]
        assert all(t.state in (DONE, SHED, REJECTED) for t in every)
        final = out["final"]
        assert final["admitted"] + final["rejected"] == len(every)
        # every rejection is the burst's, made at submit
        assert out["burst_rejected"] == final["rejected"] > 0

    def test_every_standard_ticket_shed_keeps_the_flow(self, monkeypatch,
                                                       capsys):
        """Where every standard ticket misses its deadline (as on a card
        whose first dispatches outlast the 5 s SLO) the twin reports their
        latencies at shedding and goes on, where the reference's ``min()``
        over finished tickets raises: here a standard deadline of 1 µs."""
        monkeypatch.setitem(PLANE.SLO_CLASSES, "standard",
                            dataclasses.replace(
                                PLANE.SLO_CLASSES["standard"],
                                deadline_s=1e-6))
        out = load("examples/torch_serve_moo.py").main(["--device", CPU])
        lines = _lines(capsys)
        assert json.loads(lines[-1]) == NO_LAUNCHES
        assert all(t.state == SHED for t in out["tickets"])
        assert any(line.startswith("ticket latency: none completed; all 12 "
                                   "shed") for line in lines)

