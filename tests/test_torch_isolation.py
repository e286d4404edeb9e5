"""The port stands alone: it never loads JAX or the JAX package, and its
entry points (the twins of the examples and of ``smoke_archs`` and
``smoke_core`` among them) run on the card unless the caller asks for the
host.

The import check runs in a fresh interpreter, because this test process
imports both packages for the parity tests.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (
    MOGDConfig,
    MOGDSolver,
    ProgressiveFrontier,
    as_problem,
    make_zdt1,
    solve_pf,
    zdt1_task,
)
from repro_torch.core.frontier_store import FrontierStore
from repro_torch.data.workloads import batch_problem, batch_suite, batch_task
from repro_torch.distributed import probe_mesh
from repro_torch.exec import ProbeExecutor, default_executor
from repro_torch.configs import get_smoke
from repro_torch.launch import serve, train
from repro_torch.nn import init_cache, init_params
from repro_torch.serving import ServeEngine
from repro_torch.service import MOOService

ROOT = Path(__file__).resolve().parents[1]
# the twins of the reference's examples and of scripts/smoke_archs.py and
# scripts/smoke_core.py
TWINS = ("examples/torch_train_e2e.py", "examples/torch_serve_batched.py",
         "scripts/torch_smoke_archs.py", "scripts/torch_smoke_core.py",
         "examples/torch_quickstart.py", "examples/torch_moo_service.py",
         "examples/torch_multistage_job.py",
         "examples/torch_tune_spark_analytics.py",
         "examples/torch_plan_tpu_job.py",
         "examples/torch_adaptive_tuning.py",
         "examples/torch_budget_tuning.py", "examples/torch_warm_restart.py",
         "examples/torch_trace_serving.py", "examples/torch_serve_moo.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file: the suite runs in parallel worker
    processes that idle torch threads would slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twin(rel: str):
    """A twin script as a module (its ``main`` is not run)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_is_covered():
    mods = _port_modules()
    for want in ("repro_torch.core.progressive_frontier",
                 "repro_torch.exec.executor",
                 "repro_torch.kernels.mogd_descend",
                 "repro_torch.kernels.pareto_filter",
                 "repro_torch.models.convert", "repro_torch.obs.trace",
                 "repro_torch.data.workloads", "repro_torch.alloc.features",
                 "repro_torch.alloc.policy", "repro_torch.core.dag",
                 "repro_torch.kernels.compose",
                 "repro_torch.service.moo_service",
                 "repro_torch.kernels.mogd_mlp", "repro_torch.models.gp",
                 "repro_torch.models.train", "repro_torch.modelserver.drift",
                 "repro_torch.modelserver.trainer",
                 "repro_torch.modelserver.registry",
                 "repro_torch.configs", "repro_torch.configs.rwkv6_3b",
                 "repro_torch.configs.qwen3_4b", "repro_torch.nn.config",
                 "repro_torch.nn.layers", "repro_torch.nn.rwkv",
                 "repro_torch.nn.attention", "repro_torch.nn.blocks",
                 "repro_torch.nn.model", "repro_torch.nn.convert",
                 "repro_torch.kernels.rwkv6_wkv",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.serving.engine", "repro_torch.serving.steps",
                 "repro_torch.launch.serve", "repro_torch.kernels.mamba_scan",
                 "repro_torch.nn.mamba", "repro_torch.nn.moe",
                 "repro_torch.configs.jamba_v0_1_52b",
                 "repro_torch.configs.qwen2_moe_a2_7b",
                 "repro_torch.configs.grok_1_314b",
                 "repro_torch.training", "repro_torch.training.adam",
                 "repro_torch.training.train_step",
                 "repro_torch.data.lm_data", "repro_torch.runtime.straggler",
                 "repro_torch.runtime.elastic", "repro_torch.launch.train",
                 "repro_torch.distributed.sharding",
                 "repro_torch.distributed.collectives",
                 "repro_torch.launch.mesh", "repro_torch.launch.dryrun"):
        assert want in mods


def test_no_jax_and_no_reference_package_loaded():
    script = f"""
import importlib, importlib.util, json, sys
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(ROOT)!r})
for name in {_port_modules()!r}:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
for rel in {TWINS!r}:
    spec = importlib.util.spec_from_file_location(
        rel.split('/')[-1][:-3], {str(ROOT)!r} + '/' + rel)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch.distributed as dist
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))
             or m == 'repro' or m.startswith('repro.'))
if dist.is_available() and dist.is_initialized():
    bad.append('a process group was started at import')
print(json.dumps(bad))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=240, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_never_name_jax():
    paths = [*(ROOT / "src" / "repro_torch").rglob("*.py"),
             *(ROOT / rel for rel in TWINS)]
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import")), (path, line)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


@pytest.mark.parametrize("entry", [
    "zdt1_task", "make_zdt1", "batch_task", "batch_problem", "executor",
    "default_executor", "store", "solve_pf", "pf", "solver", "solver_for",
    "init_params", "init_cache", "serve_engine", "launch_serve",
    "init_params_jamba", "init_cache_jamba", "serve_engine_moe",
    "launch_serve_jamba", "launch_train", "launch_train_rwkv",
    "probe_mesh", "service_mesh", *TWINS,
])
def test_entry_points_default_to_cuda_and_raise_here(no_cuda, entry):
    cpu_problem = as_problem(zdt1_task(d=3, device="cpu"))
    calls = {
        "zdt1_task": lambda: zdt1_task(d=3),
        "make_zdt1": lambda: make_zdt1(d=3),
        "batch_task": lambda: batch_task(batch_suite()[0]),
        "batch_problem": lambda: batch_problem(batch_suite()[0]),
        "executor": lambda: ProbeExecutor(),
        "default_executor": lambda: default_executor(),
        "store": lambda: FrontierStore(2, 3),
        "solve_pf": lambda: solve_pf(cpu_problem, n_probes=2),
        "pf": lambda: ProgressiveFrontier(cpu_problem),
        "solver": lambda: MOGDSolver(cpu_problem, MOGDConfig()),
        "solver_for": lambda: cpu_problem.solver_for(MOGDConfig()),
        "init_params": lambda: init_params(get_smoke("qwen3-4b")),
        "init_cache": lambda: init_cache(get_smoke("rwkv6-3b"), 1, 8),
        "serve_engine": lambda: ServeEngine(
            init_params(get_smoke("qwen3-4b"), device="cpu"),
            get_smoke("qwen3-4b"), batch=1, max_seq=8),
        "launch_serve": lambda: serve.main(["--arch", "rwkv6-3b",
                                            "--smoke"]),
        "init_params_jamba": lambda: init_params(get_smoke("jamba-v0.1-52b")),
        "init_cache_jamba": lambda: init_cache(get_smoke("jamba-v0.1-52b"),
                                               1, 8),
        "serve_engine_moe": lambda: ServeEngine(
            init_params(get_smoke("qwen2-moe-a2.7b"), device="cpu"),
            get_smoke("qwen2-moe-a2.7b"), batch=1, max_seq=8),
        "launch_serve_jamba": lambda: serve.main(["--arch", "jamba-v0.1-52b",
                                                  "--smoke"]),
        "launch_train": lambda: train.main(["--arch", "qwen3-4b", "--smoke",
                                            "--steps", "1"]),
        "launch_train_rwkv": lambda: train.main(["--arch", "rwkv6-3b",
                                                 "--smoke", "--steps", "1"]),
        "probe_mesh": lambda: probe_mesh(),
        "service_mesh": lambda: MOOService(mesh="auto"),
        **{rel: (lambda rel=rel: _twin(rel).main([])) for rel in TWINS},
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_cpu_is_taken_only_when_asked():
    problem = as_problem(zdt1_task(d=3, device="cpu"))
    assert problem.device == torch.device("cpu")
    res = solve_pf(problem, n_probes=4, mogd=MOGDConfig(steps=5,
                                                        multistart=2),
                   device="cpu")
    assert np.all(np.isfinite(res.F))


def test_chip_smoke_fails_without_a_card_and_prints_no_result(no_cuda):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=240, cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
