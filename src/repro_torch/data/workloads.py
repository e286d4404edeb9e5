"""Synthetic analytics workload families + trace pipeline (paper §6).

The paper evaluates on 258 TPCx-BB batch workloads (30 templates ×
parameterization) and 63 streaming workloads (6 templates), with traces of
(configuration -> latency/cost/throughput) used to train per-workload
surrogate models.  TPCx-BB and a Spark cluster are not available offline,
so this module provides a *calibrated analytic stand-in*: a differentiable
ground-truth performance model of a Spark-like engine with
workload-specific parameters drawn per template.  It plays three roles:

1. **ground truth** for "accurate models" experiments (Expt 3) — the
   optimizer sees the true objective functions;
2. **trace generator** for the modeling engine — sampled configurations +
   noisy observed objectives, used to train DNN/GP surrogates whose
   10-40% prediction error matches the paper's observed OtterTune range
   (Expt 4, "inaccurate models");
3. **test oracle** — closed-form structure lets tests verify Pareto
   recovery properties.

The performance model follows standard parallel-dataflow cost structure
(Amdahl serial fraction + parallel compute with diminishing returns +
shuffle/network + memory-pressure spill penalty + per-task scheduling
overhead + compression/serializer tradeoffs); constants are arbitrary but
fixed per workload, giving non-trivial, conflicting latency/cost surfaces.

The problem builders take ``device`` (``None`` means ``cuda``).  The model
code uses ``torch.maximum``/``minimum`` (and ``kernels.ref.clip``) where the
reference uses ``jnp.maximum``/``minimum``/``clip``, so subgradients at ties
follow JAX's convention.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.problem import (
    MOOProblem,
    SpaceEncoder,
    boolean,
    categorical,
    continuous,
    integer,
    to_numpy,
)
from ..kernels.platform import resolve_device
from ..kernels.ref import clip

Array = torch.Tensor

# ---------------------------------------------------------------------------
# Spark-like configuration space: the paper tunes the 12 most important
# Spark knobs (§6 "we ran MOO over the most important 12 parameters").
# ---------------------------------------------------------------------------


def spark_space() -> list:
    """The 12 Spark knobs (encoded width 13: the serializer is one-hot)."""
    return [
        integer("parallelism", 8, 512),
        integer("num_executors", 2, 32),
        integer("cores_per_executor", 1, 8),
        integer("mem_per_executor_gb", 1, 32),
        continuous("memory_fraction", 0.2, 0.9),
        boolean("shuffle_compress"),
        boolean("rdd_compress"),
        categorical("serializer", ("java", "kryo")),
        integer("shuffle_partitions", 8, 512),
        integer("broadcast_threshold_mb", 1, 256),
        continuous("locality_wait_s", 0.0, 10.0),
        boolean("speculation"),
    ]


@dataclasses.dataclass(frozen=True)
class BatchWorkload:
    """One parameterized TPCx-BB-style job (template × scale)."""

    name: str
    template: int
    w_cpu: float  # parallelizable compute work (core-seconds)
    w_serial: float  # serial fraction (seconds)
    w_shuffle_gb: float  # shuffle volume
    input_gb: float  # scan volume
    task_overhead_ms: float
    mem_need_gb: float  # per-core working set
    kryo_gain: float  # serializer effect on CPU work
    compress_ratio: float  # shuffle compression effectiveness
    compress_cpu: float  # compression CPU tax
    skew: float  # straggler factor exponent


@dataclasses.dataclass(frozen=True)
class StreamingWorkload:
    """One streaming job template × offered load."""

    name: str
    template: int
    rate_rec_s: float  # offered load
    rec_cost_us: float  # per-record CPU cost
    state_gb: float
    window_s: float
    shuffle_frac: float


def batch_suite(n: int = 258, seed: int = 7) -> list[BatchWorkload]:
    """258 workloads from 30 templates (paper §6 'parameterized the 30
    templates to create 258 workloads')."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = i % 30
        trng = np.random.default_rng(1000 + t)
        base = dict(
            w_cpu=float(trng.uniform(200, 12000)),
            w_serial=float(trng.uniform(2, 40)),
            w_shuffle_gb=float(trng.uniform(0.5, 200)),
            input_gb=float(trng.uniform(5, 100)),
            task_overhead_ms=float(trng.uniform(5, 60)),
            mem_need_gb=float(trng.uniform(0.5, 6.0)),
            kryo_gain=float(trng.uniform(0.05, 0.25)),
            compress_ratio=float(trng.uniform(0.3, 0.8)),
            compress_cpu=float(trng.uniform(0.02, 0.15)),
            skew=float(trng.uniform(0.0, 0.5)),
        )
        scale = float(rng.uniform(0.5, 2.0))
        for key in ("w_cpu", "w_serial", "w_shuffle_gb", "input_gb"):
            base[key] *= scale
        out.append(BatchWorkload(name=f"batch-{i}", template=t, **base))
    return out


def streaming_suite(n: int = 63, seed: int = 11) -> list[StreamingWorkload]:
    """63 streaming workloads from 6 templates (paper §6)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = i % 6
        trng = np.random.default_rng(2000 + t)
        base = dict(
            rate_rec_s=float(trng.uniform(5e4, 5e5)),
            rec_cost_us=float(trng.uniform(5, 60)),
            state_gb=float(trng.uniform(0.5, 8.0)),
            window_s=float(trng.uniform(1, 30)),
            shuffle_frac=float(trng.uniform(0.05, 0.6)),
        )
        scale = float(rng.uniform(0.6, 1.6))
        base["rate_rec_s"] *= scale
        out.append(StreamingWorkload(name=f"stream-{i}", template=t, **base))
    return out


# ---------------------------------------------------------------------------
# Differentiable ground-truth performance models
# ---------------------------------------------------------------------------

CORE_PRICE_PER_S = 0.000012  # $/core-second (cloud-ish)
MEM_PRICE_PER_S = 0.0000015  # $/GB-second
NET_GBPS = 1.25  # per-executor effective network bandwidth


def batch_latency(cfg: dict, w: BatchWorkload) -> Array:
    """Latency (s) of a batch job under soft-decoded config ``cfg``."""
    execs = cfg["num_executors"]
    cores = cfg["cores_per_executor"]
    total_cores = execs * cores
    par = cfg["parallelism"]
    kryo = cfg["serializer"][..., 1]  # one-hot: (java, kryo)

    # CPU work: serializer gain, compression tax; diminishing returns in
    # cores; parallelism must cover cores (waves) and adds per-task cost.
    cpu_work = w.w_cpu * (1.0 - w.kryo_gain * kryo)
    cpu_work = cpu_work * (1.0 + w.compress_cpu * (cfg["shuffle_compress"]
                                                   + 0.5 * cfg["rdd_compress"]))
    eff_par = torch.minimum(par, total_cores * 4.0)  # oversubscription cap
    util = clip(eff_par / total_cores, 0.0, 1.0)  # undersized parallelism
    skew_penalty = 1.0 + w.skew / torch.sqrt(eff_par)
    t_compute = cpu_work * skew_penalty / (total_cores ** 0.92 * (0.25 + 0.75 * util))

    # Shuffle: volume shrinks with compression; bandwidth scales sub-linearly
    # with executors; locality wait adds latency but improves bandwidth.
    vol = w.w_shuffle_gb * (1.0 - (1.0 - w.compress_ratio) * cfg["shuffle_compress"])
    bw = NET_GBPS * execs ** 0.85 * (1.0 + 0.03 * cfg["locality_wait_s"])
    t_shuffle = vol / bw + 0.4 * cfg["locality_wait_s"]

    # Memory pressure: spill if per-core memory below working set.
    mem_per_core = cfg["mem_per_executor_gb"] * cfg["memory_fraction"] / cores
    deficit = torch.nn.functional.softplus(
        (w.mem_need_gb - mem_per_core) * 2.0) / 2.0
    t_spill = (w.input_gb / total_cores) * deficit * 1.8

    # Scheduling: per-task overhead across waves; speculation shaves skew
    # but adds duplicate-task cost.
    n_tasks = torch.maximum(par, cfg["shuffle_partitions"])
    t_sched = n_tasks * (w.task_overhead_ms / 1000.0) / torch.maximum(
        execs, execs.new_full((), 1.0))
    spec_gain = 1.0 - 0.12 * w.skew * cfg["speculation"]
    t_sched = t_sched * (1.0 + 0.05 * cfg["speculation"])

    return (w.w_serial + t_compute + t_shuffle + t_spill + t_sched) * spec_gain


def batch_cost(cfg: dict, w: BatchWorkload, latency: Array) -> Array:
    """Cloud cost in $ (paper simulates cost via cores; we price time)."""
    execs = cfg["num_executors"]
    total_cores = execs * cfg["cores_per_executor"]
    mem = execs * cfg["mem_per_executor_gb"]
    return latency * (total_cores * CORE_PRICE_PER_S + mem * MEM_PRICE_PER_S) * 1e4


def streaming_metrics(cfg: dict, w: StreamingWorkload):
    """(avg record latency s, throughput rec/s) for a streaming job."""
    execs = cfg["num_executors"]
    cores = cfg["cores_per_executor"]
    total_cores = execs * cores
    kryo = cfg["serializer"][..., 1]
    per_rec = w.rec_cost_us * (1.0 - 0.15 * kryo) * (
        1.0 + 0.1 * w.shuffle_frac * cfg["shuffle_compress"]
    )
    capacity = total_cores * 1e6 / per_rec  # rec/s
    rho = clip(w.rate_rec_s / capacity, 0.0, 0.999)
    throughput = torch.minimum(capacity, capacity.new_full((), w.rate_rec_s))
    # M/M/1-flavored queueing + windowing + state paging if memory short.
    mem = cfg["mem_per_executor_gb"] * execs * cfg["memory_fraction"]
    paging = torch.nn.functional.softplus((w.state_gb - mem) * 1.5) / 1.5
    base = per_rec * 1e-6 / torch.maximum(1.0 - rho, rho.new_full((), 1e-3))
    latency = base + 0.05 * w.window_s + 0.5 * paging
    return latency, throughput


# ---------------------------------------------------------------------------
# MOOProblem builders
# ---------------------------------------------------------------------------


def batch_problem(w: BatchWorkload, models: dict | None = None,
                  model_stds: dict | None = None, device=None) -> MOOProblem:
    """2-objective (latency, cost) problem.  ``models`` overrides ground
    truth with learned surrogates keyed 'latency'/'cost' (Expt 3/4)."""
    dev = resolve_device(device)
    specs = spark_space()
    enc = SpaceEncoder(specs)

    if models is None:
        def obj(x: Array) -> Array:
            cfg = enc.decode_soft(x)
            lat = batch_latency(cfg, w)
            return torch.stack([lat, batch_cost(cfg, w, lat)])
        stds = None
    else:
        lat_m, cost_m = models["latency"], models["cost"]

        def obj(x: Array) -> Array:
            return torch.stack([lat_m(x), cost_m(x)])

        if model_stds:
            lat_s, cost_s = model_stds["latency"], model_stds["cost"]

            def stds(x: Array) -> Array:
                return torch.stack([lat_s(x), cost_s(x)])
        else:
            stds = None

    return MOOProblem(specs=specs, objectives=obj, k=2,
                      names=("latency_s", "cost_usd"), objective_stds=stds,
                      device=dev)


def batch_task(w: BatchWorkload, models: dict | None = None,
               model_stds: dict | None = None,
               preference=None,
               cost_cap: float | None = None,
               alpha: float = 0.0,
               model_tag: object = None,
               device=None):
    """Declarative TaskSpec for one batch workload (the new front door).

    ``cost_cap`` declares the paper's budgetary cap ``F_cost <= cap`` as an
    enforced bound; ``alpha`` weights predictive std on both objectives
    (uncertainty-aware solving, §4.2.3).  ``model_tag`` distinguishes
    surrogate generations (e.g. a training seed) in the task signature —
    ground-truth tasks need none, their closures fingerprint by content."""
    from ..core.task import Objective, TaskSpec, UtopiaNearest

    problem = batch_problem(w, models=models, model_stds=model_stds,
                            device=device)
    return TaskSpec(
        knobs=tuple(problem.specs),
        objectives=(
            Objective("latency_s", alpha=alpha),
            Objective("cost_usd", alpha=alpha,
                      bound=None if cost_cap is None else (None, cost_cap)),
        ),
        model=problem.objectives,
        model_stds=problem.objective_stds,
        preference=preference if preference is not None else UtopiaNearest(),
        model_id=None if model_tag is None else (w.name, model_tag),
        name=f"batch:{w.name}",
        device=problem.device,
    )


def streaming_problem(w: StreamingWorkload, k: int = 2,
                      models: dict | None = None, device=None) -> MOOProblem:
    """k=2: (latency, -throughput); k=3 adds cost (paper Expt 2)."""
    dev = resolve_device(device)
    specs = spark_space()
    enc = SpaceEncoder(specs)
    if models is None:
        def obj(x: Array) -> Array:
            cfg = enc.decode_soft(x)
            lat, thr = streaming_metrics(cfg, w)
            objs = [lat, -thr]
            if k == 3:
                execs = cfg["num_executors"]
                cores = execs * cfg["cores_per_executor"]
                mem = execs * cfg["mem_per_executor_gb"]
                objs.append((cores * CORE_PRICE_PER_S + mem * MEM_PRICE_PER_S) * 3.6e3)
            return torch.stack(objs)
    else:
        ms = [models["latency"], models["neg_throughput"]] + (
            [models["cost"]] if k == 3 else []
        )

        def obj(x: Array) -> Array:
            return torch.stack([m(x) for m in ms])

    names = ("latency_s", "neg_throughput") + (("cost_usd_h",) if k == 3 else ())
    return MOOProblem(specs=specs, objectives=obj, k=k, names=names,
                      device=dev)


# ---------------------------------------------------------------------------
# Trace generation (the paper's 19,528 traces -> per-workload models)
# ---------------------------------------------------------------------------


def generate_traces(problem: MOOProblem, n: int, noise: float = 0.08,
                    seed: int = 0):
    """Sample configurations and noisy observed objectives.

    Returns (X encoded (n,D), Y (n,k)) as numpy.  Multiplicative log-normal
    noise models run-to-run variance; surrogates trained on these land in
    the paper's observed 10-40% relative-error band.  Configurations are
    drawn from a ``torch.Generator`` seeded with ``seed`` (other numbers
    than the reference's JAX draws); the noise from numpy, as there.
    """
    X = problem.encoder.snap(
        problem.sample(torch.Generator().manual_seed(int(seed)), n))
    Y = to_numpy(problem.evaluate_batch(X), np.float64)
    rng = np.random.default_rng(seed)
    Y = Y * np.exp(rng.normal(0.0, noise, Y.shape))
    return to_numpy(X), Y


def default_config() -> dict:
    """The paper's x^1: a job's first run uses a default configuration."""
    return dict(
        parallelism=64,
        num_executors=4,
        cores_per_executor=2,
        mem_per_executor_gb=4,
        memory_fraction=0.6,
        shuffle_compress=True,
        rdd_compress=False,
        serializer="java",
        shuffle_partitions=64,
        broadcast_threshold_mb=10,
        locality_wait_s=3.0,
        speculation=False,
    )
