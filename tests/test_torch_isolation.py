"""The port stands alone: it never loads JAX or the JAX package, and its
entry points run on the card unless the caller asks for the host.

The import check runs in a fresh interpreter, because this test process
imports both packages for the parity tests.
"""

from __future__ import annotations

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
from repro_torch.exec import ProbeExecutor, default_executor

ROOT = Path(__file__).resolve().parents[1]


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
                 "repro_torch.data.workloads"):
        assert want in mods


def test_no_jax_and_no_reference_package_loaded():
    script = f"""
import importlib, json, sys
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(ROOT)!r})
for name in {_port_modules()!r}:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))
             or m == 'repro' or m.startswith('repro.'))
print(json.dumps(bad))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=240, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_never_name_jax():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
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
