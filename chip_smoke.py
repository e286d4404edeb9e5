"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

Run from the repository root on a machine with the card::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and turned into 0):

1. Card and build: prints the card's name and power limit as nvidia-smi
   reports them, then builds the kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a.
2. Kernels against their plain versions at the main path's shapes:
   ``cross_dominator_counts`` (exact) and ``descend_batch`` at the paper's
   surrogate width (D=13, hidden (128,)*4, k=2), timed with CUDA events.
3. Main path, one task: PF-AP over the 12 Spark knobs with two random
   paper-shape MLP surrogates, through the fused descend kernel and the
   kernel path of the frontier store, then the task's recommendation.
4. Main path, coalesced tenants: one task per workload of ``batch_suite()``
   (258 tenants), ten rounds of ``coalesce_step`` over ``solve_grouped``.
5. The service: one ``MOOService`` holding the 258 tenants, the 5-stage ETL
   job of ``examples/multistage_job.py`` and an 8-stage random
   series-parallel job (``benchmarks/expt5_multistage.py``'s
   ``make_job(8, seed=8)``) as DAG sessions; coalesced ``step_all`` rounds,
   ``recommend`` for every tenant, ``recommend_dag`` for both jobs through
   the pairwise-compose kernel, then ``solve_dag`` on the 8-stage job at
   expt5's full size.
6. Assertions: fused dispatches, no fallbacks, every kernel launched on its
   path, no JAX or ``repro`` module loaded, everything on ``cuda``.

Phase 2 also holds ``pairwise_compose`` to its plain version bit for bit.

The last two lines of standard output are the kernels' JSON record and the
device JSON line.  Without a CUDA device, or outside the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# the fp32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

PAPER_HIDDEN = (128, 128, 128, 128)
GATE = 1e-3  # the executor's fused-vs-scan parity tolerance
EXACT_STEPS = (1, 10)  # descents short enough that every element must agree
GRAD_EPS = 1e6  # Adam eps far above any |dL/dx|: the step is linear in it
GRAD_RATIOS = (1e-3, 1e-2, 1e-1, 1.0)  # lr/eps: steps of 1e-3..1 x |dL/dx|
CHAOS_FACTOR = 2  # full descent: rows apart, relative to the control


def log(*args) -> None:
    """Progress lines go to stderr so stdout ends with the result lines."""
    print(*args, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    """Abort the run with a non-zero exit and no result line."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, with CUDA events
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 1: card and build
# ---------------------------------------------------------------------------


def phase_card():
    """Print the card line and build the kernel library."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stdout}")
    print(card, flush=True)
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    so = native.build()
    native.library()
    log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    log(native.ptxas_report())
    return card


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _pareto_inputs(n: int, k: int, seed: int):
    """Random fronts with +inf rows and duplicate rows mixed in."""
    import numpy as np

    rng = np.random.default_rng(seed)
    F = rng.random((n, k)).astype(np.float32)
    if n >= 4:
        F[rng.choice(n, size=max(1, n // 8), replace=False)] = np.inf
        dup = rng.choice(n, size=max(1, n // 8), replace=False)
        F[dup] = F[rng.integers(0, n, size=len(dup))]
        F[1] = F[0]
    return F


def phase_pareto(dev) -> float:
    """cross_dominator_counts == its plain version, exactly.  Returns the
    largest |kernel - plain| count difference measured over every case."""
    import torch

    from repro_torch.kernels.pareto_filter import (
        cross_dominator_counts,
        cross_dominator_counts_plain,
    )

    sizes = (0, 1, 127, 128, 129, 4096)
    cases, worst = 0, 0

    def compare(FA, FB, label):
        got = cross_dominator_counts(FA, FB)
        want = cross_dominator_counts_plain(FA, FB)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != (FA.shape[0],):
            fail(f"pareto counts shape/dtype {got.shape} {got.dtype}")
        diff = (got.long() - want.long()).abs()
        err = int(diff.max()) if diff.numel() else 0
        if err:
            fail(f"pareto counts differ at {label}: {int((diff > 0).sum())} "
                 f"rows, by up to {err}")
        return err

    for k in (2, 3):
        for n in sizes:
            for m in sizes:
                FA = torch.as_tensor(_pareto_inputs(n, k, 10 * n + m)).to(dev)
                FB = torch.as_tensor(_pareto_inputs(m, k, 7 * m + n + 1)).to(
                    dev)
                worst = max(worst, compare(FA, FB, f"N={n} M={m} k={k}"))
                cases += 1
        F = torch.as_tensor(_pareto_inputs(4096, k, 99)).to(dev)
        worst = max(worst, compare(F, F, f"self N=4096 k={k}"))
    log(f"pareto: {cases} cross-set cases and 2 self cases exact")
    return float(worst)


def pareto_timing(dev, N: int, M: int, k: int, reps: int = 200) -> dict:
    """Kernel and plain times of cross_dominator_counts at (N, M, k)."""
    import torch

    from repro_torch.kernels.pareto_filter import (
        cross_dominator_counts,
        cross_dominator_counts_plain,
    )

    FA = torch.as_tensor(_pareto_inputs(N, k, 5)).to(dev)
    FB = torch.as_tensor(_pareto_inputs(M, k, 6)).to(dev)
    ms = time_ms(lambda: cross_dominator_counts(FA, FB), reps)
    plain_ms = time_ms(lambda: cross_dominator_counts_plain(FA, FB), reps)
    nbytes = (N + M) * k * 4 + 4 * N
    ops = N * M * k
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return {"shape": [N, M, k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _same_bits(got, want) -> bool:
    """Equal shapes, NaN in the same places, every other float equal bit
    for bit."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        return False
    keep = ~nan_g
    return torch.equal(got[keep].view(torch.int32),
                       want[keep].view(torch.int32))


def _compose_inputs(n: int, m: int, k: int, seed: int, dev, nan: bool):
    """Random stage frontiers with +inf rows (and, with ``nan``, one NaN
    entry in each), plus an add/max mask that mixes both operators."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for rows in (n, m):
        F = rng.uniform(0.5, 4.0, (rows, k)).astype(np.float32)
        if rows >= 4:
            F[rng.choice(rows, size=max(1, rows // 8), replace=False)] = np.inf
            if nan:
                F[rng.integers(0, rows), rng.integers(0, k)] = np.nan
        out.append(torch.as_tensor(F).to(dev))
    mask = np.arange(k) % 2 == 1  # max on objective 0, as a parallel join
    return out[0], out[1], mask


def phase_compose(dev) -> float:
    """pairwise_compose == its plain version, bit for bit (NaN where the
    plain version has NaN).  Returns the largest |kernel - plain| measured
    over the finite entries of every case."""
    import torch

    from repro_torch.kernels.compose import (
        pairwise_compose_blocked,
        pairwise_compose_plain,
    )

    shapes = [(n, m) for n in (1, 7, 130, 1000) for m in (1, 5, 129, 4096)]
    shapes += [(0, 5), (5, 0), (102, 40), (64, 64), (4096, 4096)]
    cases, worst = 0, 0.0
    for k in (2, 3, 5):
        for n, m in shapes:
            if k != 2 and n * m > 4096 * 1000:
                continue  # the largest shape is timed below at k = 2
            for nan in (False, True):
                FA, FB, mask = _compose_inputs(n, m, k, 31 * n + m + k, dev,
                                               nan)
                for add in (mask, ~mask):
                    got = pairwise_compose_blocked(FA, FB, add)
                    want = pairwise_compose_plain(FA, FB, add)
                    torch.cuda.synchronize()
                    if not _same_bits(got, want):
                        fail(f"pairwise_compose differs from its plain "
                             f"version at N={n} M={m} k={k} nan={nan}")
                    both = torch.isfinite(got) & torch.isfinite(want)
                    if both.any():
                        worst = max(worst, float(
                            (got[both] - want[both]).abs().max()))
                    cases += 1
    log(f"compose: {cases} cases bit for bit, max |d| {worst:g}")
    return worst


def compose_timing(dev, N: int, M: int, k: int, reps: int = 200) -> dict:
    """Kernel and plain times of pairwise_compose at (N, M, k) with a mixed
    add/max mask (a parallel join: no single PyTorch call computes it),
    and, as a yardstick, one broadcast ``torch.add`` of the same inputs
    (what a series join with every objective summed computes)."""
    import torch

    from repro_torch.kernels.compose import (
        pairwise_compose_blocked,
        pairwise_compose_plain,
    )

    FA, FB, mask = _compose_inputs(N, M, k, 17, dev, nan=False)
    ms = time_ms(lambda: pairwise_compose_blocked(FA, FB, mask), reps)
    plain_ms = time_ms(lambda: pairwise_compose_plain(FA, FB, mask), reps)
    add_ms = time_ms(lambda: torch.add(FA[:, None, :], FB[None, :, :]), reps)
    nbytes = (N + M) * k * 4 + N * M * k * 4
    ops = N * M * k
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return {"shape": [N, M, k], "ms": ms, "plain_ms": plain_ms,
            "broadcast_add_ms": add_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gb_s": nbytes / (ms * 1e-3) / 1e9}


def descend_case(dev, G: int, R: int, S: int, D: int = 13,
                 hidden=PAPER_HIDDEN, k: int = 2, steps: int = 120,
                 seed: int = 0):
    """Inputs of descend_batch at the paper's width: mixed log targets and
    orientation signs, user bounds on objective 0."""
    import numpy as np
    import torch

    from repro_torch.core.mogd import MOGDConfig
    from repro_torch.kernels.mogd_descend import DescendPlan

    rng = np.random.default_rng(seed)
    dims = (D, *hidden, 1)
    plan = DescendPlan((dims,) * k, (False, True)[:k] + (False,) * (k - 2),
                       (1.0, -1.0)[:k] + (1.0,) * (k - 2))
    params = []
    for _ in range(k):
        layers = []
        for i in range(len(dims) - 1):
            w = rng.normal(size=(G, dims[i], dims[i + 1])) * math.sqrt(
                2.0 / dims[i])
            b = rng.normal(size=(G, dims[i + 1])) * 0.05
            layers.append({"w": torch.tensor(w, dtype=torch.float32,
                                             device=dev),
                           "b": torch.tensor(b, dtype=torch.float32,
                                             device=dev)})
        params.append({
            "layers": layers,
            "x_mean": torch.tensor(rng.random((G, D)) * 0.2,
                                   dtype=torch.float32, device=dev),
            "x_std": torch.tensor(np.exp(rng.normal(size=(G, D)) * 0.2),
                                  dtype=torch.float32, device=dev),
            "y_mean": torch.tensor(rng.normal(size=G) * 0.1,
                                   dtype=torch.float32, device=dev),
            "y_std": torch.tensor(np.exp(rng.normal(size=G) * 0.2) * 0.3,
                                  dtype=torch.float32, device=dev),
        })
    x0s = rng.random((G, R, S, D))
    los = rng.normal(size=(G, R, k)) * 0.5 - 1.0
    his = los + np.exp(rng.normal(size=(G, R, k))) * 2.0
    ulos = np.full((G, R, k), -np.inf)
    uhis = np.full((G, R, k), np.inf)
    ulos[..., 0] = los[..., 0] - 0.5
    uhis[..., 0] = his[..., 0] + 0.5
    uscales = np.ones((G, R, k))
    targets = rng.integers(0, k, size=(G, R))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    batch = (f32(x0s), f32(los), f32(his), f32(ulos), f32(uhis),
             f32(uscales), torch.tensor(targets, device=dev))
    cfg = MOGDConfig(steps=steps, multistart=S)
    return plan, cfg, tuple(params), batch


def descend_flops(plan, G: int, M: int, steps: int) -> float:
    """Forward + input-gradient FLOPs of one descend call."""
    per_row = sum(sum(a * b for a, b in zip(d[:-1], d[1:]))
                  for d in plan.layer_dims)
    return 4.0 * G * M * steps * per_row


def _descend_errors(plan, cfg, params, batch):
    """Kernel and plain finals on the same inputs -> (kernel, plain,
    per-row max |dx| of shape (G, R*S))."""
    import torch

    from repro_torch.kernels.mogd_descend import (
        descend_batch,
        descend_batch_plain,
    )

    got = descend_batch(plan, cfg, params, *batch)
    want = descend_batch_plain(plan, cfg, params, *batch)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"descend output shape {tuple(got.shape)} or non-finite "
             f"(steps={cfg.steps})")
    rows = (got - want).abs().amax(-1)
    return got, want, rows.reshape(rows.shape[0], -1)


def phase_descend(dev, G=64, R=4, S=16, reps=3) -> dict:
    """descend_batch against descend_batch_plain on the card, and timed.

    Every comparison is at the executor's parity tolerance (``GATE``, 1e-3
    on a coordinate of a final point):

    * ``EXACT_STEPS`` (1 and 10) steps at the default configuration: every
      element agrees.  This exercises the forward, the hand-written
      backward and the Adam update on every row;
    * the gradient's magnitude: one step with Adam's eps far above every
      |dL/dx|, so the step is ``lr/eps * dL/dx``, linear in the gradient,
      at four ratios ``lr/eps`` a decade apart; every element agrees.
      Adam's default first step is about ``lr * sign(dL/dx)`` and would let
      a gradient of the right sign but the wrong size through;
    * ``cfg.steps`` (120) steps: Adam's ``m/(sqrt(v)+eps)`` turns a rounding
      difference in a near-zero gradient element into a full step, and a
      row on a ridge then ends elsewhere.  Which rows do depends on the
      summation order, so the plain version on the card against the plain
      version on the host is the control, measured here beside it.  The
      kernel may part from its plain version on at most ``CHAOS_FACTOR``
      times the control's rows, overall and in its worst group (plus one
      row there), so a fault confined to one group or to a few percent of
      the rows fails.
    """
    import dataclasses

    import torch

    from repro_torch.kernels.mogd_descend import (
        descend_batch,
        descend_batch_plain,
    )

    plan, cfg, params, batch = descend_case(dev, G, R, S)
    strict = {}
    for steps in EXACT_STEPS:
        _, _, rows = _descend_errors(
            plan, dataclasses.replace(cfg, steps=steps), params, batch)
        strict[f"steps={steps}"] = float(rows.max())
    for ratio in GRAD_RATIOS:
        lin = dataclasses.replace(cfg, steps=1, adam_eps=GRAD_EPS,
                                  lr=ratio * GRAD_EPS)
        _, _, rows = _descend_errors(plan, lin, params, batch)
        strict[f"lr/eps={ratio:g}"] = float(rows.max())
    for label, err in strict.items():
        log(f"descend: {label}: max |dx| kernel vs plain = {err:.3e}")
        if not err <= GATE:
            fail(f"descend kernel disagrees with its plain version at "
                 f"{label}: {err:.3e} > {GATE:g}")

    got, want, row_kp = _descend_errors(plan, cfg, params, batch)
    host = descend_batch_plain(plan, cfg, _to(params, "cpu"),
                               *_to(batch, "cpu"))
    row_ph = (want.cpu() - host).abs().amax(-1).reshape(G, -1)
    bad_kp = (row_kp > GATE).sum(-1).cpu()
    bad_ph = (row_ph > GATE).sum(-1)
    n_kp, n_ph = int(bad_kp.sum()), int(bad_ph.sum())
    worst_kp, worst_ph = int(bad_kp.max()), int(bad_ph.max())
    err = float(row_kp.max())
    log(f"descend: {cfg.steps} steps at G={G} R={R} S={S}: rows beyond "
        f"{GATE:g}: kernel vs plain {n_kp} (worst group {worst_kp}), plain "
        f"on card vs plain on host {n_ph} (worst group {worst_ph}) of "
        f"{row_kp.numel()}; max |dx| kernel vs plain {err:.3e}, plain vs "
        f"plain {float(row_ph.max()):.3e}")
    if n_kp > CHAOS_FACTOR * n_ph or worst_kp > CHAOS_FACTOR * worst_ph + 1:
        fail(f"descend kernel parts from its plain version on {n_kp} rows "
             f"(worst group {worst_kp}); the control parts on {n_ph} "
             f"(worst group {worst_ph})")
    ms = time_ms(lambda: descend_batch(plan, cfg, params, *batch), reps)
    plain_ms = time_ms(lambda: descend_batch_plain(plan, cfg, params, *batch),
                       reps)
    flops = descend_flops(plan, G, R * S, cfg.steps)
    nbytes = 4 * (2 * G * R * S * 13 + 6 * G * R * 2) + 4 * G * sum(
        sum(a * b + b for a, b in zip(d[:-1], d[1:])) for d in plan.layer_dims)
    t_ops = flops / PEAK_FP32_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"shape": [G, R, S], "steps": cfg.steps,
            "max_abs_err": max(strict.values()), "strict_errs": strict,
            "full_err": err, "full_rows_apart": n_kp,
            "full_rows_apart_control": n_ph, "full_worst_group": worst_kp,
            "full_worst_group_control": worst_ph, "rows": int(row_kp.numel()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflops_s": flops / (ms * 1e-3) / 1e9}


def _to(tree, device):
    """A copy of a dict/list/tuple tree of tensors on ``device``."""
    from repro_torch.exec import tree_map

    return tree_map(lambda t: t.to(device), tree)


# ---------------------------------------------------------------------------
# Phases 3-4: the main path
# ---------------------------------------------------------------------------


def spark_task(seed: int, dev, workload=None):
    """A TaskSpec over the 12 Spark knobs (encoded D = 13) whose two
    objectives are paper-shape MLP surrogates (hidden (128,)*4) with random
    weights from a seeded ``torch.Generator``, both on log targets so the
    predictions stay positive.  A workload of ``batch_suite()`` scales the
    outputs."""
    import torch

    from repro_torch.core import Objective, TaskSpec, UtopiaNearest
    from repro_torch.data.workloads import spark_space
    from repro_torch.exec import stack_programs
    from repro_torch.models import MLPRegressor, MLPSpec, init_mlp

    knobs = tuple(spark_space())
    D = 13
    scale = 1.0 if workload is None else workload.w_cpu / 1000.0
    regs = []
    for j, y_mean in enumerate((math.log(60.0 * scale),
                                math.log(2.0 * scale))):
        spec = MLPSpec(D, PAPER_HIDDEN, 1)
        gen = torch.Generator().manual_seed(1000 * seed + j)
        regs.append(MLPRegressor(
            spec=spec, params=init_mlp(gen, spec, device=dev),
            x_mean=torch.full((D,), 0.5, device=dev),
            x_std=torch.full((D,), 0.29, device=dev),
            y_mean=torch.tensor(y_mean, device=dev),
            y_std=torch.tensor(0.5, device=dev), dropout=0.0,
            log_target=True))
    name = "spark" if workload is None else workload.name
    return TaskSpec(
        knobs=knobs,
        objectives=(Objective("latency_s"), Objective("cost_usd")),
        program=stack_programs([r.as_program() for r in regs]),
        preference=UtopiaNearest(), name=name, device=dev)


def check_frontier(res, problem, label: str) -> None:
    """What comes out is right: finite frontier of the expected shape,
    mutually non-dominated, inside [0,1]^D, and its X re-evaluate to F."""
    import numpy as np

    from repro_torch.core import pareto_mask

    F, X = res.F, res.X
    if (F.ndim != 2 or F.shape[1] != 2 or X.shape != (len(F), problem.dim)
            or not len(F)):
        fail(f"{label}: frontier shape F{F.shape} X{X.shape}")
    if not (np.all(np.isfinite(F)) and np.all(np.isfinite(X))):
        fail(f"{label}: non-finite frontier")
    if X.min() < 0.0 or X.max() > 1.0:
        fail(f"{label}: configurations outside [0,1]^D")
    if not bool(pareto_mask(F).all()):
        fail(f"{label}: frontier points dominate each other")
    F_re = problem.evaluate_batch(X).cpu().numpy()
    # probe results are clipped into their cell before they are stored
    inside = np.all((F_re >= res.utopia) & (F_re <= res.nadir), axis=1)
    if not np.allclose(F_re[inside], F[inside], rtol=1e-4, atol=1e-5):
        fail(f"{label}: frontier X does not re-evaluate to its F")


def phase_single_task(dev) -> dict:
    """PF-AP on one paper-shape task through both kernels."""
    import torch

    from repro_torch.core import (
        MOGDConfig,
        ProgressiveFrontier,
        as_problem,
        frontier_hypervolume,
    )
    from repro_torch.exec import default_executor

    task = spark_task(0, dev)
    problem = as_problem(task)
    tracer = default_executor(dev).obs.tracer
    tracer.enabled = True  # exec.* spans: where the wall time goes
    tracer.clear()
    t0 = time.perf_counter()
    pf = ProgressiveFrontier(task, mode="AP", mogd=MOGDConfig(),
                             use_kernel=True, device=dev)
    res = pf.run(n_probes=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracer.enabled = False
    spans = {}
    for sp in tracer.spans():
        spans.setdefault(sp.name, []).append(sp.t1 - sp.t0)
    span_s = {name: {"count": len(v), "seconds": sum(v)}
              for name, v in spans.items()}
    idx = task.preference.pick(res.F, res.utopia, res.nadir)
    check_frontier(res, problem, "single task")
    stats = pf.solver.executor.stats()
    hv = frontier_hypervolume(res.state)
    rec = problem.encoder.decode(res.X[idx])
    log(f"single task: {res.probes} probes, {len(res.F)} frontier points, "
        f"normalized HV {hv:.6f}, {wall:.2f} s")
    log(f"recommendation (UN): F={res.F[idx].tolist()} config={rec}")
    log(f"executor stats: {stats}")
    log(f"executor spans: {span_s}")
    for obj in (problem, pf.solver.executor, res.state.store):
        if obj.device.type != "cuda":
            fail(f"single task: {type(obj).__name__} on {obj.device}")
    return {"probes": res.probes, "points": len(res.F), "hv": hv,
            "seconds": wall, "spans": span_s,
            "recommendation": res.F[idx].tolist(), "stats": stats}


def phase_tenants(dev, rounds: int = 10) -> dict:
    """One task per batch_suite() workload, coalesced PF-AP rounds."""
    from repro_torch.core import (
        MOGDConfig,
        ProgressiveFrontier,
        coalesce_step,
        solve_grouped,
    )
    from repro_torch.data.workloads import batch_suite

    suite = batch_suite()
    t0 = time.perf_counter()
    engines = [ProgressiveFrontier(spark_task(1 + i, dev, w), mode="AP",
                                   mogd=MOGDConfig(), use_kernel=True,
                                   device=dev)
               for i, w in enumerate(suite)]
    executor = engines[0].solver.executor
    if any(e.solver.executor is not executor for e in engines):
        fail("tenants do not share one executor")
    entries = [(e, e.initialize()) for e in engines]
    setup = time.perf_counter() - t0
    log(f"tenants: {len(entries)} engines initialized in {setup:.1f} s")

    def solve(all_boxes, prepared):
        return solve_grouped([(eng.solver, boxes, eng.target)
                              for eng, _, _, boxes in prepared])

    tracer = executor.obs.tracer
    tracer.enabled = True  # the dispatch's share of each round
    per_round = []
    for r in range(rounds):
        d0 = executor.dispatches
        tracer.clear()
        t1 = time.perf_counter()
        probes = coalesce_step(entries, solve)
        seconds = time.perf_counter() - t1
        per_round.append({
            "round": r, "seconds": seconds, "rows": probes,
            "dispatch_s": sum(sp.t1 - sp.t0 for sp in tracer.spans()
                              if sp.name == "exec.dispatch"),
            "dispatches": executor.dispatches - d0,
            "bucket": list(executor.last_bucket),
            "fill": executor.last_fill})
        log(f"round {r}: {per_round[-1]}")
    tracer.enabled = False
    for eng, state in entries:
        check_frontier(eng.finalize(state), eng.problem, eng.problem.name
                       if hasattr(eng.problem, "name") else "tenant")
    stats = executor.stats()
    log(f"tenant executor stats: {stats}")
    return {"tenants": len(entries), "setup_s": setup, "rounds": per_round,
            "stats": stats}


# ---------------------------------------------------------------------------
# Phase 5: the service, with multi-stage jobs
# ---------------------------------------------------------------------------

ETL_STAGES = (  # examples/multistage_job.py: theta = (work, base_s,
    ("extract", (3.0, 0.4, 0.3, 0.6)),  # mem_sensitivity, price)
    ("transform_a", (2.0, 0.2, 0.9, 0.8)),
    ("transform_b", (4.5, 0.3, 0.5, 0.5)),
    ("join", (2.5, 0.5, 1.2, 1.0)),
    ("report", (1.0, 0.1, 0.2, 0.4)),
)
ETL_EDGES = (("extract", "transform_a"), ("extract", "transform_b"),
             ("transform_a", "join"), ("transform_b", "join"),
             ("join", "report"))


def etl_job(dev):
    """The 5-stage ETL job of examples/multistage_job.py."""
    from repro_torch.core import JobDAG, make_analytics_family

    fam = make_analytics_family(device=dev)
    return JobDAG([fam.stage(n, th) for n, th in ETL_STAGES], ETL_EDGES,
                  name="etl")


def expt5_job(n_stages: int, seed: int, dev):
    """benchmarks/expt5_multistage.py's make_job: a random n-stage
    series-parallel analytics job (latency, cost)."""
    import numpy as np

    from repro_torch.core import (
        JobDAG,
        make_analytics_family,
        random_series_parallel_edges,
    )

    rng = np.random.default_rng(seed)
    fam = make_analytics_family(device=dev)
    names = [f"s{i}" for i in range(n_stages)]
    stages = [fam.stage(n, rng.uniform([1.0, 0.2, 0.1, 0.3],
                                       [6.0, 1.0, 1.5, 1.2]))
              for n in names]
    return JobDAG(stages, random_series_parallel_edges(names, rng),
                  name=f"job{n_stages}")


def check_composed(dag, comp, stage_frontiers, label: str) -> None:
    """A composed DAG frontier is right: finite, mutually non-dominated,
    equal (sorted, 1e-5) to the host's composition of the same stage
    frontiers without the kernels, and its rows decode to stage
    configurations inside their knob ranges."""
    import numpy as np

    from repro_torch.core import pareto_mask

    F, X = comp.F, comp.X
    if F.ndim != 2 or F.shape[1] != dag.k or X.shape != (len(F), dag.dim):
        fail(f"{label}: composed frontier shape F{F.shape} X{X.shape}")
    if not len(F) or not np.all(np.isfinite(F)):
        fail(f"{label}: empty or non-finite composed frontier")
    if not bool(pareto_mask(F).all()):
        fail(f"{label}: composed points dominate each other")
    host = dag.compose_frontiers(stage_frontiers, use_kernel=False,
                                 device="cpu")
    if host.F.shape != F.shape or not np.allclose(
            np.sort(host.F, axis=0), np.sort(F, axis=0), rtol=1e-5,
            atol=1e-5):
        fail(f"{label}: composed frontier differs from the host's "
             f"({len(F)} vs {len(host.F)} points)")
    for row in X:
        for name, cfg in dag.decode(row).items():
            for spec in dag.stage(name).task.knobs:
                v = cfg[spec.name]
                if not spec.low <= v <= spec.high:
                    fail(f"{label}: stage {name} knob {spec.name}={v} "
                         f"outside [{spec.low}, {spec.high}]")


def phase_service(dev, rounds: int = 4) -> dict:
    """MOOService with the reference's defaults over 258 tenants and two
    DAG jobs; recommendations; then solve_dag at expt5's full size."""
    import torch

    from repro_torch.core import MOGDConfig, solve_dag
    from repro_torch.data.workloads import batch_suite
    from repro_torch.service import MOOService

    suite = batch_suite()
    t0 = time.perf_counter()
    # max_sessions raised from the default 256: 258 tenants plus 13 stage
    # sessions
    svc = MOOService(use_kernel=True, max_sessions=512, device=dev)
    sids = [svc.create_session(spark_task(1 + i, dev, w))
            for i, w in enumerate(suite)]
    jobs = {"etl": etl_job(dev), "job8": expt5_job(8, 8, dev)}
    dags = {name: svc.create_dag_session(job) for name, job in jobs.items()}
    setup = time.perf_counter() - t0
    log(f"service: {len(sids)} tenant sessions, DAG sessions "
        f"{list(dags)}, {svc.stats()['sessions']} sessions in "
        f"{setup:.1f} s")
    ex = svc.executor
    tracer = svc.obs.tracer
    tracer.enabled = True
    per_round = []
    for r in range(rounds):
        d0 = ex.dispatches
        tracer.clear()
        t1 = time.perf_counter()
        out = svc.step_all(rounds=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        dispatch_s = sum(sp.t1 - sp.t0 for sp in tracer.spans()
                         if sp.name == "exec.dispatch")
        each = sorted((sp.t1 - sp.t0 for sp in tracer.spans()
                       if sp.name == "exec.dispatch"), reverse=True)
        per_round.append({
            "round": r, "seconds": seconds, "dispatch_s": dispatch_s,
            "dispatch_share": dispatch_s / seconds,
            "dispatches": ex.dispatches - d0,
            "largest_dispatches_s": each[:3], **out})
        log(f"service round {r}: {per_round[-1]}")
    tracer.enabled = False
    t1 = time.perf_counter()
    recs = [svc.recommend(sid) for sid in sids]
    recommend_s = time.perf_counter() - t1
    for sid in sids:
        sess = svc._sessions[sid]
        check_frontier(sess.engine.finalize(sess.state), sess.problem,
                       f"service tenant {sid}")
    if any(len(r.config) != 12 for r in recs):
        fail("a tenant's recommendation does not set the 12 Spark knobs")
    from repro_torch.kernels import platform

    dag_out = {}
    for name, did in dags.items():
        comp_ms = []
        for _ in range(3):
            before = platform.launch_counts()
            t1 = time.perf_counter()
            rec = svc.recommend_dag(did)
            comp_ms.append((time.perf_counter() - t1) * 1e3)
            after = platform.launch_counts()
        per_call = {kname: after.get(kname, 0) - before.get(kname, 0)
                    for kname in ("pairwise_compose",
                                  "cross_dominator_counts")}
        comp = svc.dag_frontier(did)
        stage_frontiers = {n: svc.frontier(sid) for n, sid in
                           svc._dags[did].stage_sids.items()}
        check_composed(jobs[name], comp, stage_frontiers, f"DAG {name}")
        dag_out[name] = {
            "stages": len(jobs[name].stages), "edges": len(jobs[name].edges),
            "stage_points": {n: len(F) for n, (F, _) in
                             stage_frontiers.items()},
            "points": len(comp), "recommend_dag_ms": comp_ms,
            "launches_per_recommend_dag": per_call,
            "objectives": rec.objectives.tolist()}
        log(f"DAG {name}: {dag_out[name]}")
    stats = svc.stats()
    ex_stats = ex.stats()
    log(f"service stats: {stats}")
    log(f"service executor stats: {ex_stats}")

    # solve_dag on expt5's 8-stage job at its full size
    job = expt5_job(8, 8, dev)
    t1 = time.perf_counter()
    res = solve_dag(job, n_probes_per_stage=48,
                    mogd=MOGDConfig(steps=60, multistart=8), batch_rects=4,
                    use_kernel=True, device=dev)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    check_composed(job, res.frontier, res.stage_frontiers, "solve_dag job8")
    sd = {"seconds": solve_s, "probes": res.probes,
          "unique_stages": res.unique_stages,
          "dispatches": res.dispatches, "points": len(res.frontier)}
    log(f"solve_dag job8: {sd}")
    for obj in (svc.executor, *(svc._sessions[s].state.store for s in sids)):
        if obj.device.type != "cuda":
            fail(f"service: {type(obj).__name__} on {obj.device}")
    return {"tenants": len(sids), "setup_s": setup, "rounds": per_round,
            "recommend_all_s": recommend_s, "dags": dag_out,
            "solve_dag": sd, "stats": stats, "executor": ex_stats}


def main() -> int:
    """Run the phases; exit code 0 only when every check held."""
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a repository "
             f"checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    phase_s = {}

    def mark(name: str) -> None:
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
        log(f"phase {name}: {phase_s[name]:.1f} s")

    card = phase_card()
    mark("card_and_build")
    dev = torch.device("cuda", 0)
    from repro_torch.kernels import platform

    # phase 2: kernels against their plain versions
    p_err = phase_pareto(dev)
    p_main = pareto_timing(dev, 4, 256, 2)
    p_big = pareto_timing(dev, 4096, 4096, 2, reps=20)
    log(f"pareto timing main-path shape: {p_main}")
    log(f"pareto timing 4096x4096: {p_big}")
    d = phase_descend(dev)
    log(f"descend timing: {d}")
    c_err = phase_compose(dev)
    mark("kernels")

    # phase 3: the main path, one task (launch counts of this run only)
    platform.reset_launches()
    single = phase_single_task(dev)
    launches = platform.launch_counts()
    log(f"main-path launches: {launches}")
    mark("single_task")
    # phase 4: coalesced tenants (counted separately)
    platform.reset_launches()
    tenants = phase_tenants(dev)
    tenant_launches = platform.launch_counts()
    log(f"tenant-path launches: {tenant_launches}")
    mark("tenants")
    # phase 5: the service with DAG jobs (counted separately)
    platform.reset_launches()
    service = phase_service(dev)
    service_launches = platform.launch_counts()
    log(f"service-path launches: {service_launches}")
    # the compose kernel's time at a shape of its path: the ETL job's
    # extract x transform_a stage frontiers
    pts = service["dags"]["etl"]["stage_points"]
    c_main = compose_timing(dev, pts["extract"], pts["transform_a"], 2)
    c_big = compose_timing(dev, 4096, 4096, 2, reps=20)
    log(f"compose timing path shape: {c_main}")
    log(f"compose timing 4096x4096: {c_big}")
    mark("service")

    # phase 6: assertions
    for label, st in (("single task", single["stats"]),
                      ("tenants", tenants["stats"]),
                      ("service", service["executor"])):
        if st["fused_dispatches"] <= 0:
            fail(f"{label}: no fused dispatch")
        if st["fused_fallbacks"] != 0:
            fail(f"{label}: fused fallbacks {st['fused_fallbacks']}")
    for name in ("descend_batch", "cross_dominator_counts"):
        if launches.get(name, 0) <= 0 or tenant_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for name in ("descend_batch", "cross_dominator_counts",
                 "pairwise_compose"):
        if service_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the service path")
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    if bad:
        fail(f"reference modules loaded: {bad[:5]}")

    kernels = [
        {"name": "cross_dominator_counts", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pareto_filter.cu",
         "replaces": "src/repro/kernels/pareto_filter.py:28",
         "launches": launches["cross_dominator_counts"],
         "max_abs_err": p_err, "ms": p_main["ms"],
         "plain_ms": p_main["plain_ms"], "bound_ms": p_main["bound_ms"],
         "bound_by": p_main["bound_by"], "library_ms": None},
        {"name": "descend_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mogd_descend.cu",
         "replaces": "src/repro/kernels/mogd_descend.py:239",
         "launches": launches["descend_batch"],
         "max_abs_err": d["max_abs_err"], "ms": d["ms"],
         "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
         "bound_by": d["bound_by"], "library_ms": None},
        {"name": "pairwise_compose", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/compose.cu",
         "replaces": "src/repro/kernels/compose.py:31",
         "launches": service_launches["pairwise_compose"],
         "max_abs_err": c_err, "ms": c_main["ms"],
         "plain_ms": c_main["plain_ms"], "bound_ms": c_main["bound_ms"],
         "bound_by": c_main["bound_by"], "library_ms": None},
    ]
    summary = {"single_task": {k: v for k, v in single.items()
                               if k != "stats"},
               "tenants": {k: v for k, v in tenants.items() if k != "stats"},
               "service": {k: v for k, v in service.items()
                           if k not in ("stats", "executor")},
               "service_stats": service["stats"],
               "launches": {"single_task": launches,
                            "tenants": tenant_launches,
                            "service": service_launches},
               "pareto_4096": p_big, "descend": d,
               "compose_path": c_main, "compose_4096": c_big,
               "phase_s": phase_s}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, **summary}, indent=1,
        default=str))
    print(json.dumps({"service": {
        "round_s": [r["seconds"] for r in service["rounds"]],
        "dispatch_share": [r["dispatch_share"] for r in service["rounds"]],
        "dispatches_per_round": [r["dispatches"]
                                 for r in service["rounds"]],
        "recommend_dag_ms": {name: dag["recommend_dag_ms"]
                             for name, dag in service["dags"].items()},
        "solve_dag_s": service["solve_dag"]["seconds"],
        "solve_dag_dispatches": service["solve_dag"]["dispatches"]}}),
        flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
