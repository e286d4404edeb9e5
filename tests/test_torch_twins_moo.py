"""The port's twins of ``scripts/smoke_core.py`` and of the MOO examples
``quickstart``, ``moo_service``, ``multistage_job``, ``tune_spark_analytics``
and ``plan_tpu_job``, on the CPU, held to the reference examples.

The reference side calls the reference's APIs with each example's
arguments; it imports no example that works at module level (it rebuilds
``quickstart.py``'s and ``moo_service.py``'s closures in JAX here).  The
port's random draws differ from the reference's by design (torch
generators against JAX keys), so a frontier is compared on the reference's
draws: every MOGD and family solver replays the reference solver's key
stream, problem sampling the reference's ``PRNGKey(seed)`` uniforms, and
``fit_mlp`` the reference's initial weights and dropout masks.  Tolerances:

* hypervolumes within ±0.5 % of the reference's (the band of
  ``tests/test_torch_pf.py``), against one point past both nadirs, or the
  example's own point for ZDT1;
* surrogate predictions within 1e-4 relative (``tests/test_torch_models.py``'s
  band for trained weights);
* counters, names, orders and operators exactly.

Each twin is also run as a user runs it (``main(["--device", "cpu"])``,
its own draws) and must end with ``{"launches": {}, "plain_on_cuda": {}}``:
on the host every wrapper takes its plain version and launches nothing.
No size is cut: every run is at the example's own settings.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as J
import repro.data as JDATA
import repro.models as JM
import repro.planner as JP
import repro.planner.planner as JPP
import repro.service as JSV
import repro_torch.core as P
import repro_torch.models.train as PT
import repro_torch.planner.planner as PPP
from repro.core.problem import SpaceEncoder as JSpaceEncoder
from repro.models.mlp import MLPSpec as JMLPSpec
from repro.models.mlp import init_mlp as j_init_mlp
from repro_torch.configs import get_config
from repro_torch.core.problem import MOOProblem
from repro_torch.data import batch_problem

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
HV_BAND = 0.005  # ±0.5 % of the reference's HV
FIT_RTOL = 1e-4
NO_LAUNCHES = {"launches": {}, "plain_on_cuda": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: its tensors are small, and the
    suite runs in parallel worker processes that idle threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(rel: str):
    """A script as a module (its ``__main__`` block is not run)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_draws(monkeypatch):
    """Make the port draw the reference's numbers: every MOGD and family
    solver replays the reference solver's key stream, and problem sampling
    the reference's ``PRNGKey(seed)`` uniforms (``tests/test_torch_dag.py``'s
    helper)."""

    def replay(self, B, dim):
        key = getattr(self, "_ref_key", None)
        if key is None:
            key = jax.random.PRNGKey(self.config.seed)
        self._ref_key, sub = jax.random.split(key)
        return np.array(jax.random.uniform(
            sub, (B, self.config.multistart, dim)))

    def mogd_starts(self, B):
        return replay(self, B, self.problem.dim)

    def family_starts(self, B):
        return replay(self, B, self.family.encoder.dim)

    def sample(self, generator, n):
        u = jax.random.uniform(jax.random.PRNGKey(generator.initial_seed()),
                               (n, self.dim))
        return torch.as_tensor(np.array(u), device=self.device)

    monkeypatch.setattr(P.MOGDSolver, "draw_starts", mogd_starts)
    monkeypatch.setattr(P.FamilySolver, "draw_starts", family_starts)
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


def _within_band(hv_port, hv_ref):
    assert hv_ref > 0.0
    assert abs(hv_port - hv_ref) <= HV_BAND * hv_ref, (hv_port, hv_ref)


def _same_hv(want_F, got_F):
    """Both frontiers' HV against one point past both nadirs (10 % of the
    span, or 0.1 % of the nadir where the span is nil) within the band."""
    both = np.concatenate([want_F, got_F]).astype(np.float64)
    nadir, utopia = both.max(0), both.min(0)
    point = nadir + 0.1 * np.maximum(nadir - utopia, 1e-3 * np.abs(nadir))
    _within_band(P.hypervolume(got_F, point), J.hypervolume(want_F, point))


def _fresh_reference(script: str) -> dict:
    """Run ``script`` on the reference in a new interpreter (JAX on the
    CPU) and return the JSON object it prints last."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
               if p)}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# 1. scripts/smoke_core.py
# ---------------------------------------------------------------------------


class TestSmokeCore:
    def test_pf_ws_nc_on_reference_draws(self, monkeypatch):
        """PF-AP 60 probes (100 steps, 8 starts), WS 10 and NC 10 on ZDT1:
        HV at (1.2, 1.2) within ±0.5 % of the reference's each, PF-AP's
        probes equal."""
        _reference_draws(monkeypatch)
        twin = load("scripts/torch_smoke_core.py")
        got = twin.run(CPU)
        prob = load("scripts/smoke_core.py").make_zdt1()
        pf = J.solve_pf(prob, mode="AP", n_probes=60,
                        mogd=J.MOGDConfig(steps=100, multistart=8), grid_l=2)
        assert got["pf"]["probes"] == pf.probes
        want = {"pf": pf.F, "ws": J.weighted_sum(prob, n_probes=10).F,
                "nc": J.normalized_constraints(prob, n_probes=10).F}
        for name, F in want.items():
            _within_band(got[name]["hv"],
                         J.hypervolume_2d(F, np.array([1.2, 1.2])))
        # NSGA-II on its own draws (numpy's generator): a sound frontier
        evo = got["evo"]["F"]
        assert len(evo) and np.isfinite(evo).all()
        assert bool(P.pareto_mask(evo).all())
        # phase 5d's ZDT1 check: PF-AP covers WS
        assert got["pf"]["hv"] >= got["ws"]["hv"]

    def test_runs_as_a_user_runs_it(self, capsys):
        out = load("scripts/torch_smoke_core.py").main(["--device", CPU])
        assert _last_line(capsys) == NO_LAUNCHES
        assert out["pf"]["probes"] >= 60
        assert out["pf"]["hv"] >= out["ws"]["hv"] > 0.0
        for key in ("pf", "ws", "nc", "evo"):
            assert bool(P.pareto_mask(out[key]["F"]).all())


# ---------------------------------------------------------------------------
# 2. examples/quickstart.py
# ---------------------------------------------------------------------------


def _j_quickstart_problem():
    """``examples/quickstart.py:24-45`` in JAX (the example works at module
    level, so it is rebuilt here)."""
    specs = [J.integer("cores", 4, 64),
             J.continuous("memory_fraction", 0.2, 0.9),
             J.categorical("serializer", ("java", "kryo")),
             J.boolean("compress")]
    enc = JSpaceEncoder(specs)

    def objectives(x):
        cfg = enc.decode_soft(x)
        cores = cfg["cores"]
        kryo = cfg["serializer"][..., 1]
        lat = 300.0 / cores ** 0.9 * (1.0 - 0.15 * kryo) \
            + 2.0 * (1.0 - cfg["memory_fraction"]) + 0.5 * cfg["compress"]
        cost = cores * (1.0 + 0.2 * cfg["compress"]) * 0.02
        return jnp.stack([lat, cost])

    return J.MOOProblem(specs=specs, objectives=objectives, k=2,
                        names=("latency_s", "cost_usd"))


class TestQuickstart:
    def test_objectives_equal_the_reference(self):
        twin = load("examples/torch_quickstart.py")
        X = np.random.default_rng(0).random((16, twin.ENC.dim))
        want = jax.vmap(_j_quickstart_problem().objectives)(
            jnp.asarray(X, jnp.float32))
        got = torch.func.vmap(twin.objectives)(
            torch.as_tensor(X, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    def test_frontier_on_reference_draws(self, monkeypatch):
        """PF-AP 24 probes: HV within ±0.5 %, probes equal."""
        _reference_draws(monkeypatch)
        twin = load("examples/torch_quickstart.py")
        got = P.solve_pf(twin.make_problem(CPU), mode="AP", n_probes=24,
                         device=CPU)
        want = J.solve_pf(_j_quickstart_problem(), mode="AP", n_probes=24)
        assert got.probes == want.probes
        _same_hv(want.F, got.F)

    def test_runs_as_a_user_runs_it(self, capsys):
        out = load("examples/torch_quickstart.py").main(["--device", CPU])
        assert _last_line(capsys) == NO_LAUNCHES
        res = out["result"]
        assert res.probes >= 24 and bool(P.pareto_mask(res.F).all())
        assert set(out["picks"]) == {"balanced", "latency-first"}


# ---------------------------------------------------------------------------
# 3. examples/moo_service.py
# ---------------------------------------------------------------------------


def _j_moo_service_stats() -> dict:
    """``examples/moo_service.py:29-67`` in JAX: the eight tenants'
    service after ``run_until(32)``."""
    specs = [J.integer("cores", 4, 64), J.continuous("mem_fraction", 0.2, 0.9)]
    enc = JSpaceEncoder(specs)

    def make_task(scale, weights):
        def objectives(x):
            cfg = enc.decode_soft(x)
            lat = scale * 120.0 / cfg["cores"] ** 0.9 + 2.0 * (1 - cfg["mem_fraction"])
            cost = cfg["cores"] * 0.02 * (1.0 + 0.1 * cfg["mem_fraction"])
            return jnp.stack([lat, cost])

        return JSV.TaskSpec(
            knobs=specs, objectives=(JSV.Objective("latency_s"),
                                     JSV.Objective("cost_usd")),
            model=objectives, preference=JSV.WeightedUtopiaNearest(weights),
            name="etl")

    svc = JSV.MOOService(mogd=J.MOGDConfig(steps=80, multistart=8),
                         batch_rects=4)
    for i in range(8):
        svc.create_session(make_task(1.0 if i < 4 else 3.5,
                                     (0.8, 0.2) if i % 2 == 0 else (0.2, 0.8)))
    svc.run_until(min_probes=32)
    return svc.stats()


class TestMooService:
    def test_counters_equal_the_reference_examples(self, capsys):
        """Run as a user runs it: fresh torch closures of equal content hit
        the solver cache as the reference's do; ``sessions``,
        ``compiled_solvers``, ``solver_cache_hits`` and
        ``coalesced_batches`` exactly; the capped tenant's frontier at or
        under its cap."""
        out = load("examples/torch_moo_service.py").main(["--device", CPU])
        assert _last_line(capsys) == NO_LAUNCHES
        want = _j_moo_service_stats()
        for key in ("sessions", "compiled_solvers", "solver_cache_hits",
                    "coalesced_batches"):
            assert out["stats"][key] == want[key], key
        assert out["capped_max_cost"] <= 0.6
        before, after = out["resumed"]
        assert after >= before

    def test_fresh_closures_share_one_signature(self):
        twin = load("examples/torch_moo_service.py")
        a = twin.make_task(1.0, weights=(0.8, 0.2), device=CPU)
        b = twin.make_task(1.0, weights=(0.8, 0.2), device=CPU)
        c = twin.make_task(3.5, weights=(0.8, 0.2), device=CPU)
        assert a.model is not b.model
        assert a.signature() == b.signature()
        assert a.signature() != c.signature()


# ---------------------------------------------------------------------------
# 4. examples/multistage_job.py
# ---------------------------------------------------------------------------


def _j_service_dag(ref) -> dict:
    """``examples/multistage_job.py:59-73`` in JAX, less its probing: the
    counters compared (child sessions, and the problem cache hits of the
    re-submitted job) do not depend on ``run_until``."""
    svc = JSV.MOOService(batch_rects=4)
    svc.create_dag_session(ref.build_job())
    st = svc.stats()
    svc.create_dag_session(ref.build_job())
    return {"stats": st, "resubmitted": svc.stats()}


class TestMultistageJob:
    def test_composed_frontier_on_reference_draws(self, monkeypatch):
        """``plan_job(dag, n_probes=24)``: the composed frontier's HV
        within ±0.5 %, probes equal.  The reference plans in a fresh
        process, as the example does: its stage frontiers depend on what
        its process ran before (one ``solve_pf`` on ZDT1 first makes it
        probe 30 where a fresh process probes 10)."""
        _reference_draws(monkeypatch)
        twin = load("examples/torch_multistage_job.py")
        got = PPP.plan_job(twin.build_job(CPU), n_probes=24,
                           preference=P.WeightedUtopiaNearest((0.7, 0.3)),
                           device=CPU)
        want = _fresh_reference(f"""
import importlib.util, json
import numpy as np
import repro.core as J, repro.planner as JP
spec = importlib.util.spec_from_file_location(
    "multistage_job", {str(ROOT / "examples/multistage_job.py")!r})
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
rec = JP.plan_job(ref.build_job(), n_probes=24,
                  preference=J.WeightedUtopiaNearest((0.7, 0.3)))
print(json.dumps({{"probes": rec.probes,
                  "F": np.asarray(rec.frontier_F).tolist()}}))
""")
        assert got.probes == want["probes"]
        _same_hv(np.asarray(want["F"]), got.frontier_F)

    def test_structure_and_counters_equal_the_reference_examples(self,
                                                                 capsys):
        """Run as a user runs it: stage names, topological order, compose
        operators, child sessions and ``problem_cache_hits`` exactly."""
        out = load("examples/torch_multistage_job.py").main(["--device", CPU])
        assert _last_line(capsys) == NO_LAUNCHES
        ref = load("examples/multistage_job.py")
        jdag = ref.build_job()
        dag = out["dag"]
        assert dag.stage_names == jdag.stage_names
        assert dag.topo_order() == jdag.topo_order()
        assert dag.objective_names == jdag.objective_names
        assert tuple(dag.compose) == tuple(jdag.compose)
        want = _j_service_dag(ref)
        assert out["stats"]["sessions"] == want["stats"]["sessions"]
        assert (out["resubmitted"]["problem_cache_hits"]
                == want["resubmitted"]["problem_cache_hits"])
        assert set(out["plan"].stage_configs) == set(jdag.stage_names)


# ---------------------------------------------------------------------------
# 5. examples/tune_spark_analytics.py
# ---------------------------------------------------------------------------


class TestTuneSparkAnalytics:
    def test_surrogates_and_frontier_on_reference_draws(self, monkeypatch):
        """The reference's traces (600, noise 0.08) and its fits' draws:
        the (64, 64) surrogates within 1e-4; then PF-AP 24 on the
        surrogates from the reference's draws: HV within ±0.5 %, probes
        equal."""
        _reference_draws(monkeypatch)
        _reference_training(monkeypatch)
        twin = load("examples/torch_tune_spark_analytics.py")
        w = JDATA.batch_suite()[twin.WORKLOAD]
        X, Y = (np.array(a) for a in JDATA.generate_traces(
            JDATA.batch_problem(w), n=600, noise=0.08))
        want = {name: JM.fit_mlp(X, Y[:, j], hidden=(64, 64),
                                 config=JM.TrainConfig(max_epochs=60),
                                 log_target=True)
                for j, name in enumerate(twin.OBJECTIVES)}
        got = twin.fit_surrogates(X, Y, CPU)
        Xt = torch.as_tensor(X, dtype=torch.float32)
        for name in twin.OBJECTIVES:
            np.testing.assert_allclose(
                got[name](Xt).detach().numpy(),
                np.asarray(want[name](jnp.asarray(X, jnp.float32))),
                rtol=FIT_RTOL)
        mogd = dict(steps=100, multistart=8)
        res = P.solve_pf(batch_problem(w, models=got, device=CPU),
                         mode="AP", n_probes=24, mogd=P.MOGDConfig(**mogd),
                         device=CPU)
        ref = J.solve_pf(JDATA.batch_problem(w, models=want), mode="AP",
                         n_probes=24, mogd=J.MOGDConfig(**mogd))
        assert res.probes == ref.probes
        _same_hv(ref.F, res.F)

    def test_runs_as_a_user_runs_it(self, capsys):
        out = load("examples/torch_tune_spark_analytics.py").main(
            ["--device", CPU])
        assert _last_line(capsys) == NO_LAUNCHES
        assert out["result"].probes >= 24
        assert np.isfinite(out["default"]).all()
        for f in out["picks"].values():
            assert np.isfinite(f).all() and f[0] < out["default"][0]


# ---------------------------------------------------------------------------
# 6. examples/plan_tpu_job.py
# ---------------------------------------------------------------------------


class TestPlanTpuJob:
    def test_frontier_on_reference_draws(self, monkeypatch):
        """``plan_job(grok-1-314b, train_4k, n_probes=24, deadline_s=None)``
        from the reference's draws: HV within ±0.5 % (as
        ``tests/test_torch_planner.py``'s plan test)."""
        _reference_draws(monkeypatch)
        monkeypatch.setattr(PPP, "_PF_CACHE", {})
        monkeypatch.setattr(JPP, "_PF_CACHE", {})
        kw = dict(weights=(0.5, 0.5), n_probes=24, deadline_s=None)
        got = PPP.plan_job(get_config("grok-1-314b"), "train_4k", **kw,
                           device=CPU)
        want = JP.plan_job(JC.get_config("grok-1-314b"), "train_4k", **kw)
        _same_hv(want.frontier_F, got.frontier_F)

    def test_runs_as_a_user_runs_it(self, monkeypatch, capsys):
        monkeypatch.setattr(PPP, "_PF_CACHE", {})
        out = load("examples/torch_plan_tpu_job.py").main(["--device", CPU])
        assert _last_line(capsys) == NO_LAUNCHES
        assert len(out["plan"].frontier_F) >= 1
        assert 0 < out["elastic"].num_chips <= 192
