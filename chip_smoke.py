"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

Run from the repository root on a machine with the card::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and turned into 0):

1. Card and build: prints the card's name and power limit as nvidia-smi
   reports them, then builds the kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a.
2. Kernels against their plain versions at the main path's shapes:
   ``cross_dominator_counts`` (exact) and ``descend_batch`` at the paper's
   surrogate width (D=13, hidden (128,)*4, k=2) on its resident route (the
   group's weights in a cluster's shared memory), timed with CUDA events
   beside its streaming route (the first port's kernel) in the same run.
3. Main path, one task: PF-AP over the 12 Spark knobs with two random
   paper-shape MLP surrogates, through the fused descend kernel and the
   kernel path of the frontier store, then the task's recommendation; then
   the same task again on each descend route, for its time to a frontier
   and its descend launches' device time (CUDA events).
4. Main path, coalesced tenants: one task per workload of ``batch_suite()``
   (258 tenants), ten rounds of ``coalesce_step`` over ``solve_grouped``.
5. The service: one ``MOOService`` holding the 258 tenants, the 5-stage ETL
   job of ``examples/multistage_job.py`` and an 8-stage random
   series-parallel job (``benchmarks/expt5_multistage.py``'s
   ``make_job(8, seed=8)``) as DAG sessions; coalesced ``step_all`` rounds,
   ``recommend`` for every tenant, ``recommend_dag`` for both jobs through
   the pairwise-compose kernel, then ``solve_dag`` on the 8-stage job at
   expt5's full size.
5b. The front desk: a ``FrontDesk`` with its dispatcher thread over a
   kernel-path ``MOOService`` with a ``FrontierVault`` (in a temporary
   directory), one ticket of 16 probes for each of the 258 tenants, the
   interactive, standard and batch SLO classes dealt round-robin, while a
   second thread calls ``recommend`` on served sessions (at least 200
   times).  Every ticket must end done, or shed where its class allows it,
   every batch ticket done, every latency breakdown sum to its end-to-end
   time within 1e-6 s, the descend and dominance kernels launch from the
   dispatcher thread with no plain version on the card, and the rounds'
   persist phase snapshot sessions.  Then 4 waves of 6 tickets (2 a
   class) on sessions the burst initialized, one wave at a time: the same
   checks, and each class must have a ticket done through a dispatch.
   Then every session is closed (its state persisted) and the vault
   flushed.
5c. The vault: a fresh service on the same directory re-creates every
   tenant's session: each one closed with a frontier is restored with no
   executor dispatch, its state (row history, Pareto mask, rectangle
   queue) equal bit for bit to the closed one's, and recommends the same
   configuration.
6. The model server at the paper's width: one ``ModelRegistry`` training
   4 x 128 MLP surrogates over the 12 Spark knobs for eight
   ``batch_suite()`` workloads (2,048 traces each) and a GP for a ninth,
   gated promotion to v1, one ``create_workload_session`` each on one
   ``MOOService``, then traces from another workload's surface streamed into
   one workload until drift fires, the inline retrain to v2 and the warm
   re-solve of its session.  The registry persists each promotion to a
   vault; after the phase a fresh registry rehydrates the 9 workloads from
   it, with the same task signatures and no fit.
7. LM serving at full width, weights random from a seed: ``rwkv6_wkv``
   (RWKV-6 3B's 40 heads of 64: a 512-token prefill at B = 1 and B = 4,
   which take the kernel's two layouts, a decode step from a nonzero
   state, 37 steps), ``flash_attention`` (Qwen3-4B's 32/8 heads of 128, S
   = 16, 37, 512, 4096, bf16 and fp32, one non-causal case) and
   ``mamba_scan`` (Jamba's d_inner 8192 with 16 states: a 512-token
   prefill from zero and from a nonzero state, at B = 4 from zero, a
   decode step, 37 steps) against their plain versions and timed (SDPA
   timed beside flash as a yardstick only); WKV on each of its layouts
   at T = 512, B = 1 and 4 (the wrapper's choice beside the other); the
   host side of a decode call of both, piece by piece
   (``decode_host_pieces``); then for ``rwkv6-3b`` (32 layers),
   ``qwen3-4b`` (36), ``jamba-v0.1-52b`` and ``qwen2-moe-a2.7b`` (24) in
   turn:
   ``init_params`` on the card; in fp32 compute, 16 decode steps from an
   empty cache and one decode step from a 16-token prefill's cache against
   the full forward; then ``ServeEngine`` in bf16 serving 8 requests over
   4 slots (prompts of 16-512 tokens, 32 new tokens each, greedy), with
   tokens/s, per-token decode and prefill times and peak device memory.
   Jamba's depth is cut to fit one card: 8 layers (one period of its
   plan) for the fp32 check, 16 layers with bf16 parameters for serving;
   qwen2-moe serves with bf16 parameters.  Each instance is freed before
   the next is built.  The launch counts are set to 0 just before
   ``ServeEngine.run`` and read just after it: each kernel must have
   launched exactly once per mixer layer of every prefill (and, for WKV
   and the scan, every decode step) the engine made, every flash launch
   of those bf16 prefills on the tensor-core route, and no plain WKV,
   attention or scan may have run on a CUDA tensor, forward or backward.
8. Assertions: fused dispatches, no fallbacks, every kernel launched on its
   path, every descend launch of phases 3-5 on the resident route, no JAX
   or ``repro`` module loaded, everything on ``cuda``.

Phase 2 also holds ``pairwise_compose`` to its plain version bit for bit,
and ``mlp_forward`` (the fused surrogate forward), its gradients and a
``vmap(grad)`` through ``MLPRegressor`` to theirs; the forward also at its
layout's edges (one row to a grid capped at the SMs, a head alone, two
outputs, widths that are not multiples of 4, layers streamed through the
ring), one launch each.  The dominance kernel is held exact at its
layout's edges too (both bodies, 8-row tiles around their edges, one warp
to eight over FB; +inf, NaN and duplicate rows) and timed at the frontier
store's three call shapes and at 4096 x 4096, beside a whole
``FrontierStore.add`` (capacity 256, batches of 4) on its kernel path and
on the dense torch pass; compose at its float4 walk's edges (k = 1..5,
sizes not multiples of 4, the mask as bools on the card), bit for bit.
The dominance, compose and MLP kernels' rows of the kernels line carry
their profiler device times beside the back-to-back ones (``device_ms``,
``plain_device_ms``), and the descend kernel's row its own at the timed
shape (``device_ms``); compose's ``library_ms`` is one broadcast
``torch.add`` of the same inputs.

``python3 chip_smoke.py --timing NAME`` runs only phase 1 and the
dominance, compose and store-``add`` timings that the whole run makes,
into ``NAME.json`` beside ``chip_smoke.json``; copied into an earlier
tree, it times that tree's kernels the same way.

Standard output ends with the service, front-desk (latency by class,
shed counts, ``recommend`` while dispatching, launches, the plane), vault,
model-server and LM-serving summary lines, the decode calls' host pieces,
the kernels' JSON record (seven kernels; WKV and the scan with their
decode call's times beside the prefill's, the scan's bound counting its
exps on the SFUs) and the device JSON line.  Without a CUDA device, or outside the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
# accurate expf: one MUFU.EX2 each, 16 a clock an SM against 128 fp32 FMA
# lanes (CUDA C Programming Guide, arithmetic instruction throughput,
# compute capability 9.0), at the clock of the fp32 peak
PEAK_SFU_S = PEAK_FP32_S / 16

PAPER_HIDDEN = (128, 128, 128, 128)
GATE = 1e-3  # the executor's fused-vs-scan parity tolerance
EXACT_STEPS = (1, 10)  # descents short enough that every element must agree
GRAD_EPS = 1e6  # Adam eps far above any |dL/dx|: the step is linear in it
GRAD_RATIOS = (1e-3, 1e-2, 1e-1, 1.0)  # lr/eps: steps of 1e-3..1 x |dL/dx|
CHAOS_FACTOR = 2  # full descent: rows apart, relative to the control
PAPER_DIMS = (13, *PAPER_HIDDEN, 1)
# the fused MLP forward: tests/test_kernels.py::TestMogdMLP (2e-5, 3e-5 at
# the paper shape) and tests/test_mogd_descend.py::TestFusedMLPVJP (1e-4)
MLP_TOL, MLP_PAPER_TOL, MLP_GRAD_TOL = 2e-5, 3e-5, 1e-4
MLP_EDGE_ROWS = (1, 7, 8, 33, 409, 4096, 20000)
MLP_EDGE_DIMS = ((13, 1), (13, 128, 128, 2), (13, 24, 10, 1),
                 (13, 40, 72, 16, 128, 1))
MLP_STREAMED = (13, 1000, 1000, 1)  # 4 MB of weights: the ring streams them
# the front-desk phase: one ticket a batch_suite() tenant, the SLO classes
# dealt round-robin, and the recommend calls a second thread makes while
# the plane dispatches
FD_CLASSES = ("interactive", "standard", "batch")
FD_PROBES = 16
FD_RECOMMENDS = 200
FD_RECOMMEND_PAUSE_S = 1e-3
# after the burst (whose init phase sheds the interactive class), waves of
# FD_WAVE_SIZE tickets, the classes dealt round-robin, on sessions the
# burst initialized: each class must complete through a dispatch there
FD_WAVES, FD_WAVE_SIZE = 4, 6
# the model-server phase
MS_WORKLOADS = 8  # MLP workloads of batch_suite(), plus one GP workload
MS_TRACES = 2048  # per workload: half of the registry's max_traces
SHIFT_ROWS = 256  # traces streamed from another surface (= trim_on_drift)
MS_PROBES = 32
# the LM serving phase: RWKV-6 3B's WKV heads (40 x 64), Qwen3-4B's
# attention heads (32 query / 8 key-value heads of 128); the kernels'
# tolerances are tests/test_kernels.py's TestRwkvWKV and TestFlashAttention
LM_ARCHS = ("rwkv6-3b", "qwen3-4b", "jamba-v0.1-52b", "qwen2-moe-a2.7b")
# config overrides of the fp32 check's instance and of the served one (None:
# the check's parameters serve, cast to bf16 by the engine).  Jamba at 32
# layers is 51.6 B parameters: one period of its plan (8 layers, 53.2 GB in
# fp32) for the check, two (16 layers, 52.1 GB in bf16) for serving
LM_CUTS = {"jamba-v0.1-52b": ({"n_layers": 8},
                              {"n_layers": 16, "param_dtype": "bfloat16"}),
           "qwen2-moe-a2.7b": ({}, {"param_dtype": "bfloat16"})}
LM_WKV_HEADS, LM_WKV_DH = 40, 64
LM_HEADS, LM_KV_HEADS, LM_HEAD_DIM = 32, 8, 128
LM_WKV_TOL = 3e-4
# Jamba's Mamba mixers: d_inner 8192, d_state 16; the scan's tolerance is
# tests/test_kernels.py::TestMambaScan's
LM_SCAN_D, LM_SCAN_N = 8192, 16
LM_SCAN_TOL = 3e-4
LM_FLASH_S = (16, 37, 512, 4096)
LM_PROMPTS = (16, 64, 256, 512)
LM_REQUESTS, LM_SLOTS, LM_MAX_NEW = 8, 4, 32
LM_CHECK_LEN = 16
# fp32-compute decode against the full forward: the card's readings were
# 1.5e-5 to 6.9e-5 at both models' full size (PERF.md, PR 14)
LM_FP32_TOL = 1e-3
# the bf16 dense tensor-core peak of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_S = 989e12


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


def _pareto_inputs(n: int, k: int, seed: int, nan: bool = False):
    """Random fronts with +inf rows and duplicate rows mixed in (and, with
    ``nan``, a NaN in every 16th row)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    F = rng.random((n, k)).astype(np.float32)
    if n >= 4:
        F[rng.choice(n, size=max(1, n // 8), replace=False)] = np.inf
        dup = rng.choice(n, size=max(1, n // 8), replace=False)
        F[dup] = F[rng.integers(0, n, size=len(dup))]
        F[1] = F[0]
    if nan and n >= 8:
        F[5::16, rng.integers(0, k)] = np.nan
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
    # the layout's edges: 8 or 32 candidate rows a CTA around their tiles,
    # one warp to eight over FB, +inf, NaN and duplicate rows, and rows
    # equal across the two sets
    for k in (2, 3, 5):
        for n in PARETO_EDGE_N:
            for m in PARETO_EDGE_M:
                FA = _pareto_inputs(n, k, 3 * n + m + k, nan=True)
                FB = _pareto_inputs(m, k, 5 * m + n + k, nan=True)
                FB[: min(n, m) // 2] = FA[: min(n, m) // 2]
                worst = max(worst, compare(
                    torch.as_tensor(FA).to(dev), torch.as_tensor(FB).to(dev),
                    f"edge N={n} M={m} k={k}"))
                cases += 1
    log(f"pareto: {cases} cross-set cases and 2 self cases exact")
    return float(worst)


# the dominance kernel's layout edges (pareto_filter.layout)
PARETO_EDGE_N = (1, 4, 31, 32, 33, 128, 4096)
PARETO_EDGE_M = (1, 4, 32, 33, 64, 256, 257, 4096)
# the frontier store's three calls at capacity 256 with a batch of 4 (batch
# vs live, batch vs batch, live vs kept batch), and a large call
PARETO_SHAPES = ((4, 256), (4, 4), (256, 4), (4096, 4096))


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


def pareto_device_ms(dev, N: int, M: int, k: int) -> dict:
    """Profiler device times of cross_dominator_counts and its plain
    version on ``pareto_timing``'s inputs at (N, M, k)."""
    import torch

    from repro_torch.kernels.pareto_filter import (
        cross_dominator_counts,
        cross_dominator_counts_plain,
    )

    FA = torch.as_tensor(_pareto_inputs(N, k, 5)).to(dev)
    FB = torch.as_tensor(_pareto_inputs(M, k, 6)).to(dev)
    return {**kernel_device_ms(lambda: cross_dominator_counts(FA, FB)),
            "plain_device_ms": device_ms(
                lambda: cross_dominator_counts_plain(FA, FB))}


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
    # the float4 walk's edges: k = 1..5, M*k and N*M*k not multiples of 4;
    # the mask also as bools on the card, read there by the kernel (the
    # 4096 x 4096 x 2 case above writes 134 MB, past L2: streaming stores)
    for k in range(1, 6):
        for n, m in COMPOSE_EDGE_SHAPES:
            FA, FB, mask = _compose_inputs(n, m, k, 7 * n + m + k, dev, True)
            for add in (mask, ~mask, torch.as_tensor(mask, device=dev)):
                got = pairwise_compose_blocked(FA, FB, add)
                want = pairwise_compose_plain(FA, FB, add)
                torch.cuda.synchronize()
                if not _same_bits(got, want):
                    fail(f"pairwise_compose differs from its plain version "
                         f"at the edge N={n} M={m} k={k}")
                cases += 1
    log(f"compose: {cases} cases bit for bit, max |d| {worst:g}")
    return worst


# the compose kernel's float4 walk: M*k and N*M*k not multiples of 4 at
# odd k, a tail shorter than one float4, rows longer than a CTA
COMPOSE_EDGE_SHAPES = ((1, 1), (3, 5), (7, 3), (27, 25), (5, 1001),
                       (130, 77))


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


def compose_device_ms(dev, N: int, M: int, k: int) -> dict:
    """Profiler device times of pairwise_compose and its plain version on
    ``compose_timing``'s inputs at (N, M, k)."""
    from repro_torch.kernels.compose import (
        pairwise_compose_blocked,
        pairwise_compose_plain,
    )

    import torch

    FA, FB, mask = _compose_inputs(N, M, k, 17, dev, nan=False)
    return {**kernel_device_ms(
                lambda: pairwise_compose_blocked(FA, FB, mask)),
            "plain_device_ms": device_ms(
                lambda: pairwise_compose_plain(FA, FB, mask)),
            "broadcast_add_device_ms": device_ms(
                lambda: torch.add(FA[:, None, :], FB[None, :, :]))}


def store_add_timing(dev, adds: int = 400) -> dict:
    """Milliseconds per ``FrontierStore.add`` at capacity 256 with batches
    of 4, on the host's clock from before the first add to a synchronise
    after the last: the kernel path (three dominance launches, 4 x 256,
    4 x 4 and 256 x 4) beside the dense torch pass on the card
    (``_incremental_pass``, ``use_kernel=False``) as a yardstick.  The
    store holds 128 live points on the front x + y = 1 and every batch lies
    above it (x, y >= 0.55), so each add makes the whole pass and leaves
    the store as it was."""
    import numpy as np
    import torch

    from repro_torch.core.frontier_store import FrontierStore

    rng = np.random.default_rng(7)
    t = np.linspace(0.0, 1.0, 128)
    front = np.stack([t, 1.0 - t], axis=1)
    batches = [rng.uniform(0.55, 1.5, (4, 2)) for _ in range(adds)]
    X = np.zeros((4, 3))
    out = {}
    for label, use_kernel in (("kernel", True), ("dense", False)):
        store = FrontierStore(2, 3, capacity=256, use_kernel=use_kernel,
                              device=dev)
        store.add(front, np.zeros((128, 3)))
        for F in batches[:20]:
            store.add(F, X)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for F in batches:
            store.add(F, X)
        torch.cuda.synchronize()
        out[f"{label}_ms"] = (time.perf_counter() - t0) / adds * 1e3
        if store.capacity != 256 or store.n_points != 128:
            fail(f"store timing: capacity {store.capacity}, "
                 f"{store.n_points} live points")
    return out


def kernel_device_ms(fn, reps: int = 50) -> dict:
    """The profiler's device time of the one kernel that each call of
    ``fn`` launches, over ``reps`` back-to-back calls in one window: the
    mean (``device_ms``, as ``device_ms()`` gives it) and the median launch
    (``device_median_ms``, which one slow launch does not move); None
    where the profiler does not record one kernel a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    each = sorted(ev.time_range.end - ev.time_range.start
                  for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    if len(each) != reps:
        return {"device_ms": None, "device_median_ms": None}
    return {"device_ms": sum(each) / reps / 1e3,
            "device_median_ms": each[reps // 2] / 1e3}


def _mlp_inputs(dims, B: int, seed: int, dev, w_scale=0.1, b_scale=0.05,
                uniform: bool = False):
    """Random weights and inputs of an MLP with layer widths ``dims``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    ws = [f32(rng.normal(size=(dims[i], dims[i + 1])) * w_scale)
          for i in range(len(dims) - 1)]
    bs = [f32(rng.normal(size=(dims[i + 1],)) * b_scale)
          for i in range(len(dims) - 1)]
    x = rng.random((B, dims[0])) if uniform else rng.normal(size=(B, dims[0]))
    return f32(x), ws, bs


def _close(got, want, tol: float, label: str) -> float:
    """Fail unless ``|got - want| <= tol + tol*|want|`` everywhere (the
    reference tests' rtol = atol); returns the largest |got - want|."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite")
    diff = (got - want).abs()
    if bool((diff > tol + tol * want.abs()).any()):
        fail(f"{label}: max |d| {float(diff.max()):.3e} beyond {tol:g}")
    return float(diff.max()) if diff.numel() else 0.0


def phase_mlp(dev) -> dict:
    """mlp_forward against its plain version on the card: the forward at
    the reference test's batches and depths and at the paper shape, the
    gradients through the autograd.Function against autograd through the
    plain version, and vmap(grad) through MLPRegressor.forward."""
    import torch
    from torch.func import grad, vmap

    from repro_torch.kernels import platform, ref
    from repro_torch.kernels.mogd_mlp import mlp_forward_cuda, mlp_forward_fused
    from repro_torch.models import MLPRegressor, MLPSpec, init_mlp

    fwd, cases = 0.0, 0
    for depth in (1, 2, 4):
        for B in (1, 7, 256, 300, 4096):
            x, ws, bs = _mlp_inputs((24, *(128,) * depth, 1), B,
                                    10 * B + depth, dev)
            fwd = max(fwd, _close(mlp_forward_cuda(x, ws, bs),
                                  ref.mlp_forward(x, ws, bs), MLP_TOL,
                                  f"mlp_forward B={B} depth={depth}"))
            cases += 1
    for B in (1024, 4096, 409):
        x, ws, bs = _mlp_inputs(PAPER_DIMS, B, B, dev, 0.2, 0.1, True)
        fwd = max(fwd, _close(mlp_forward_cuda(x, ws, bs),
                              ref.mlp_forward(x, ws, bs), MLP_PAPER_TOL,
                              f"mlp_forward paper shape B={B}"))
        cases += 1
    # the layout's edges: one tile and its ragged neighbours, a grid capped
    # at the SMs (20,000 rows: 19 tiles a block), a head alone, two outputs,
    # widths that are not multiples of 4, unequal hidden widths, and layers
    # too wide for shared memory (streamed through the ring)
    edges = [(B, dims) for B in MLP_EDGE_ROWS for dims in MLP_EDGE_DIMS]
    for B, dims in edges + [(64, MLP_STREAMED)]:
        x, ws, bs = _mlp_inputs(dims, B, B + len(dims), dev)
        before = platform.launch_counts().get("mlp_forward", 0)
        got = mlp_forward_cuda(x, ws, bs)
        if platform.launch_counts().get("mlp_forward", 0) != before + 1:
            fail(f"mlp_forward {dims} B={B}: not one launch")
        fwd = max(fwd, _close(got, ref.mlp_forward(x, ws, bs), MLP_TOL,
                              f"mlp_forward {dims} B={B}"))
        cases += 1
    grads = 0.0
    for B in (5, 256, 300, 4096):  # TestFusedMLPVJP's network and inputs
        x, ws, bs = _mlp_inputs((6, 32, 32, 1), B, B + 1, dev, 0.3, 0.1,
                                True)
        got = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
        want = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
        (mlp_forward_fused(got[0], got[1:4], got[4:]) ** 2).sum().backward()
        (ref.mlp_forward(want[0], want[1:4], want[4:]) ** 2).sum().backward()
        for i, (g, w) in enumerate(zip(got, want)):
            grads = max(grads, _close(g.grad, w.grad, MLP_GRAD_TOL,
                                      f"mlp_forward grad {i} B={B}"))
    # vmap(grad) through a paper-shape regressor (He-init weights, as
    # init_mlp draws them), against the same standardized forward through
    # the plain version
    spec = MLPSpec(13, PAPER_HIDDEN, 1)
    layers = init_mlp(torch.Generator().manual_seed(3), spec, device=dev)
    ws = [layer["w"] for layer in layers]
    bs = [layer["b"] for layer in layers]
    x = _mlp_inputs(PAPER_DIMS, 256, 3, dev, uniform=True)[0]
    xm = torch.full((13,), 0.5, device=dev)
    xs = torch.full((13,), 0.29, device=dev)
    ym = torch.tensor([0.3], device=dev)
    ys = torch.tensor([0.7], device=dev)
    reg = MLPRegressor(spec, layers, xm, xs, ym, ys, log_target=True)

    def plain(r):
        y = ref.mlp_forward(((r - xm) / xs)[None], ws, bs)[0] * ys + ym
        return torch.exp(y[0])

    before = platform.launch_counts().get("mlp_forward", 0)
    got = vmap(grad(reg))(x)
    if platform.launch_counts().get("mlp_forward", 0) <= before:
        fail("vmap(grad) through MLPRegressor did not launch mlp_forward")
    vg = _close(got, vmap(grad(plain))(x), MLP_GRAD_TOL,
                "vmap(grad) through MLPRegressor")
    log(f"mlp_forward: {cases} forward cases, max |d| {fwd:.3e}; gradients "
        f"max |d| {grads:.3e}; vmap(grad) through MLPRegressor max |d| "
        f"{vg:.3e}")
    return {"max_abs_err": fwd, "grad_err": grads, "vmap_grad_err": vg,
            "cases": cases}


def device_ms(fn, reps: int = 50, name: str | None = None):
    """Mean device time per call of ``fn`` from the profiler's CUDA kernel
    records (all kernels, or those whose name contains ``name``), or None
    when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or (
                name is not None and name not in ev.key):
            continue
        total += getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
    return total / reps / 1e3 if total > 0 else None


def mlp_timing(dev, B: int, reps: int = 200) -> dict:
    """Kernel and plain times of mlp_forward at the paper shape over B
    rows, with its bound.  ``ms``/``plain_ms`` are back-to-back calls timed
    with CUDA events (what a caller waits); ``device_ms``/
    ``plain_device_ms`` the kernels' own time from the profiler."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mogd_mlp import mlp_forward_cuda

    x, ws, bs = _mlp_inputs(PAPER_DIMS, B, 11, dev, 0.2, 0.1, True)
    ms = time_ms(lambda: mlp_forward_cuda(x, ws, bs), reps)
    plain_ms = time_ms(lambda: ref.mlp_forward(x, ws, bs), reps)
    dev_ms = device_ms(lambda: mlp_forward_cuda(x, ws, bs),
                       name="mlp_forward_kernel")
    plain_dev_ms = device_ms(lambda: ref.mlp_forward(x, ws, bs))
    pairs = sum(a * b for a, b in zip(PAPER_DIMS[:-1], PAPER_DIMS[1:]))
    flops = 2.0 * B * pairs
    nbytes = 4 * (B * (PAPER_DIMS[0] + PAPER_DIMS[-1]) + pairs
                  + sum(PAPER_DIMS[1:]))
    t_ops = flops / PEAK_FP32_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"shape": [B, *PAPER_DIMS], "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflops_s": flops / (ms * 1e-3) / 1e9}


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


def descend_device_ms(dev, G=64, R=4, S=16, reps: int = 10) -> dict:
    """The profiler's device time of the resident descend kernel at the
    timed shape (phase 2's case, 120 steps)."""
    from repro_torch.kernels.mogd_descend import descend_batch

    plan, cfg, params, batch = descend_case(dev, G, R, S)

    def call():
        descend_batch(plan, cfg, params, *batch)

    return {"device_ms": device_ms(call, reps, name="descend_resident")}


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

    The port routes this shape to the resident kernel, and every check
    above runs on it.  The streaming kernel (the route of plans too wide
    for a cluster, forced here) passes the ``EXACT_STEPS`` checks before
    it is timed beside the resident one as the earlier kernel's time.
    """
    import dataclasses

    import torch

    from repro_torch.kernels.mogd_descend import (
        descend_batch,
        descend_batch_plain,
    )

    from repro_torch.kernels import platform
    from repro_torch.kernels.mogd_descend import descend_route

    plan, cfg, params, batch = descend_case(dev, G, R, S)
    route, cluster_rows = descend_route(plan, G, R * S,
                                        platform.sm_count(dev.index))
    if route != "resident":
        fail(f"descend at the paper shape takes the {route} route")

    def strict_checks(label, cases):
        """``cases`` (label -> config) on the route ``label``: every
        element of every final point within ``GATE`` of the plain
        version's."""
        platform.reset_launches()
        errs = {}
        for name, c in cases.items():
            _, _, rows = _descend_errors(plan, c, params, batch)
            errs[name] = float(rows.max())
        if platform.route_counts() != {f"descend_batch:{label}": len(errs)}:
            fail(f"descend checks' routes: {platform.route_counts()}")
        for name, err in errs.items():
            log(f"descend ({label}): {name}: max |dx| kernel vs plain = "
                f"{err:.3e}")
            if not err <= GATE:
                fail(f"descend {label} kernel disagrees with its plain "
                     f"version at {name}: {err:.3e} > {GATE:g}")
        return errs

    exact = {f"steps={steps}": dataclasses.replace(cfg, steps=steps)
             for steps in EXACT_STEPS}
    strict = strict_checks("resident", {
        **exact,
        **{f"lr/eps={ratio:g}": dataclasses.replace(
            cfg, steps=1, adam_eps=GRAD_EPS, lr=ratio * GRAD_EPS)
           for ratio in GRAD_RATIOS}})
    # the streaming route (the first port's kernel, which phase 3 also
    # runs a whole task on) is held to the same bar before it is timed
    with streaming_descend():
        strict_streaming = strict_checks("streaming", exact)

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
    with streaming_descend():
        ms_streaming = time_ms(
            lambda: descend_batch(plan, cfg, params, *batch), reps)
    plain_ms = time_ms(lambda: descend_batch_plain(plan, cfg, params, *batch),
                       reps)
    flops = descend_flops(plan, G, R * S, cfg.steps)
    nbytes = 4 * (2 * G * R * S * 13 + 6 * G * R * 2) + 4 * G * sum(
        sum(a * b + b for a, b in zip(d[:-1], d[1:])) for d in plan.layer_dims)
    t_ops = flops / PEAK_FP32_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"shape": [G, R, S], "steps": cfg.steps,
            "max_abs_err": max(strict.values()), "strict_errs": strict,
            "strict_errs_streaming": strict_streaming,
            "full_err": err, "full_rows_apart": n_kp,
            "full_rows_apart_control": n_ph, "full_worst_group": worst_kp,
            "full_worst_group_control": worst_ph, "rows": int(row_kp.numel()),
            "route": route, "rows_per_cluster": cluster_rows, "ms": ms,
            "ms_streaming": ms_streaming,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflops_s": flops / (ms * 1e-3) / 1e9}


@contextlib.contextmanager
def streaming_descend():
    """``descend_batch`` forced onto its streaming route (the first port's
    kernel, weights streamed from L2 every step) for an in-run comparison
    with the resident route; the port's own choice is restored on exit."""
    from repro_torch.kernels import mogd_descend as md

    chosen = md.descend_route
    md.descend_route = lambda plan, G, M, n_sm: ("streaming",
                                                 md._block_rows(plan, M))
    try:
        yield
    finally:
        md.descend_route = chosen


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


def single_task_descend(dev) -> dict:
    """The single task's time to a frontier and the device time of its
    descend launches, by route: PF-AP on phase 3's task again, as the port
    routes it (resident) and forced onto the streaming route.  Each launch
    is bracketed by CUDA events on its stream (the profiler is kept out of
    this phase: the host-bound phases after it would pay for it)."""
    import torch

    from repro_torch.core import MOGDConfig, ProgressiveFrontier
    from repro_torch.kernels import native, platform

    lib = native.library()
    entries = ("mogd_descend", "mogd_descend_resident")
    saved = {name: getattr(lib, name) for name in entries}
    events = []

    def timed(fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args)
            end.record()
            events.append((start, end))
            return err
        return call

    out = {}
    try:
        for name in entries:
            setattr(lib, name, timed(saved[name]))
        for label, ctx in (("resident", contextlib.nullcontext()),
                           ("streaming", streaming_descend())):
            with ctx:
                platform.reset_launches()
                events.clear()
                pf = ProgressiveFrontier(spark_task(0, dev), mode="AP",
                                         mogd=MOGDConfig(), use_kernel=True,
                                         device=dev)
                t0 = time.perf_counter()
                pf.run(n_probes=64)
                _sync(dev)
                wall = time.perf_counter() - t0
            routes = platform.route_counts()
            out[label] = {
                "seconds": wall, "routes": routes,
                "descend_device_s": sum(s.elapsed_time(e)
                                        for s, e in events) / 1e3}
            if {r for r in routes if r.startswith("descend_batch:")} != {
                    f"descend_batch:{label}"}:
                fail(f"single task forced to {label}: routes {routes}")
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)
    log(f"single task by descend route: {out}")
    return out


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


# ---------------------------------------------------------------------------
# Phases 5b-5c: the front desk and the vault
# ---------------------------------------------------------------------------


def _pcts(values) -> dict:
    """The count, p50 and p95 of a list (None when it is empty)."""
    import numpy as np

    if not len(values):
        return {"n": 0, "p50": None, "p95": None}
    v = np.asarray(values, dtype=np.float64)
    return {"n": int(len(v)), "p50": float(np.quantile(v, 0.5)),
            "p95": float(np.quantile(v, 0.95))}


def _check_tickets(tickets, label: str) -> None:
    """Every ticket done, or shed where its class allows it; every batch
    ticket done; every breakdown summing to its end-to-end latency."""
    from repro_torch.frontdesk import DONE, SHED

    states = {t.state for t in tickets}
    if not states <= {DONE, SHED}:
        fail(f"{label}: ticket states {sorted(states)}")
    for t in tickets:
        if t.state == SHED and not t.slo.sheddable:
            fail(f"{label}: a {t.slo.name} ticket was shed")
        b = t.breakdown()
        if b["e2e_s"] is None or abs(b["accounted_s"] - b["e2e_s"]) > 1e-6:
            fail(f"{label}: ticket {t.ticket_id} breakdown {b}")
    if any(t.state != DONE for t in tickets if t.slo.name == "batch"):
        fail(f"{label}: a batch ticket did not complete")


def _by_class(tickets, admit_s) -> dict:
    """Per SLO class: counts, and admit, queue-wait, dispatch and
    end-to-end p50/p95 (of the done tickets, but admit)."""
    from repro_torch.frontdesk import DONE, SHED

    out = {}
    for name in FD_CLASSES:
        mine = [t for t in tickets if t.slo.name == name]
        done = [t for t in mine if t.state == DONE]
        out[name] = {
            "tickets": len(mine), "done": len(done),
            "shed": sum(t.state == SHED for t in mine),
            "admit_s": _pcts([a for a, t in zip(admit_s, tickets)
                              if t.slo.name == name]),
            "queue_wait_s": _pcts([t.queue_wait_s for t in done]),
            "dispatch_s": _pcts([t.dispatch_s for t in done]),
            "e2e_s": _pcts([t.latency() for t in done])}
    return out


def phase_frontdesk(dev, vault_dir) -> dict:
    """A ``FrontDesk`` over ``MOOService(use_kernel=True, vault=...)`` with
    its dispatcher thread: one ticket of ``FD_PROBES`` probes for each
    ``batch_suite()`` tenant, the SLO classes dealt round-robin, while a
    second thread calls ``recommend`` on sessions already served.  Every
    ticket must end done (or shed, where its class allows it), every batch
    ticket done, every breakdown must sum to its end-to-end latency, and
    the rounds' persist phase must have snapshotted sessions to the vault.
    The service's tracer records the plane's dispatch spans: ``recommend``
    must answer at least ``FD_RECOMMENDS`` times inside them.
    Then every session is closed (its state persisted) and the vault
    flushed; the closed states come back for the vault phase."""
    import threading

    from repro_torch.core.progressive_frontier import export_pf_state
    from repro_torch.data.workloads import batch_suite
    from repro_torch.frontdesk import DONE, FrontDesk
    from repro_torch.obs import Observability
    from repro_torch.persist import FrontierVault
    from repro_torch.service import MOOService

    suite = batch_suite()
    specs = [spark_task(1 + i, dev, w) for i, w in enumerate(suite)]
    vault = FrontierVault(vault_dir)
    # max_sessions raised from the default 256 for the 258 tenants
    svc = MOOService(use_kernel=True, max_sessions=512, vault=vault,
                     vault_autosave_probes=FD_PROBES,
                     obs=Observability(trace=True), device=dev)
    desk = FrontDesk(svc, capacity=2 * len(specs))
    served: list = []  # session ids with a completed ticket
    rec_s: list = []  # (start on the tracer's clock, seconds)
    stop = threading.Event()
    errors: list = []

    def reader():
        i = 0
        while not stop.is_set():
            if not served:
                time.sleep(FD_RECOMMEND_PAUSE_S)
                continue
            sid = served[i % len(served)]
            i += 1
            t0 = time.perf_counter()
            try:
                rec = svc.recommend(sid)
            except Exception as e:  # reported and failed below
                errors.append(repr(e))
                return
            rec_s.append((t0, time.perf_counter() - t0))
            if len(rec.config) != 12:
                errors.append(f"recommend({sid}) set {len(rec.config)} "
                              f"knobs")
                return
            time.sleep(FD_RECOMMEND_PAUSE_S)

    t0 = time.perf_counter()
    desk.start()
    rthread = threading.Thread(target=reader, name="recommend-reader",
                               daemon=True)
    rthread.start()
    tickets, admit_s = [], []
    for i, spec in enumerate(specs):
        t1 = time.perf_counter()
        tickets.append(desk.submit(spec=spec, slo=FD_CLASSES[i % 3],
                                   n_probes=FD_PROBES))
        admit_s.append(time.perf_counter() - t1)
    submit_s = time.perf_counter() - t0
    pending = list(tickets)
    while pending:  # publish served sessions as their tickets complete
        for t in pending:
            if t.ok and t.session_id not in served:
                served.append(t.session_id)
        pending = [t for t in pending if not t.done]
        if time.perf_counter() - t0 > 600.0:
            fail(f"front desk: {len(pending)} tickets still pending")
        time.sleep(0.01)
    if not desk.drain(timeout=60.0):
        fail("front desk: live tickets left after every ticket ended")
    wall_s = time.perf_counter() - t0
    # the waves: sessions the burst initialized, with probe work left
    ready = [t.session_id for t in tickets
             if svc._sessions[t.session_id].state is not None
             and not svc.session_exhausted(t.session_id)]
    if len(ready) < FD_WAVES * FD_WAVE_SIZE:
        fail(f"front desk: {len(ready)} initialized sessions with work "
             f"left, want {FD_WAVES * FD_WAVE_SIZE} for the waves")
    wave, wave_admit_s = [], []
    for w in range(FD_WAVES):
        mine = []
        for i in range(FD_WAVE_SIZE):
            t1 = time.perf_counter()
            mine.append(desk.submit(
                session_id=ready[w * FD_WAVE_SIZE + i],
                slo=FD_CLASSES[i % 3], n_probes=FD_PROBES))
            wave_admit_s.append(time.perf_counter() - t1)
        for t in mine:
            if not t.wait(timeout=60.0) and not t.done:
                fail(f"front desk: wave ticket {t.ticket_id} still pending")
        wave += mine
    if not desk.drain(timeout=60.0):
        fail("front desk: live tickets left after the waves")
    # the launch counters are read after the dispatcher stops: in this
    # phase only its thread launches kernels, so they see one writer
    desk.stop()
    stop.set()
    rthread.join(timeout=30.0)
    if rthread.is_alive():
        fail("front desk: the recommend thread did not stop")
    if errors:
        fail(f"front desk: recommend failed: {errors[:3]}")
    _check_tickets(tickets, "front desk")
    _check_tickets(wave, "front desk waves")
    for name in FD_CLASSES:
        if not any(t.state == DONE and t.dispatch_s > 0.0
                   for t in wave if t.slo.name == name):
            fail(f"front desk waves: no {name} ticket done through a "
                 f"dispatch")
    spans = svc.obs.tracer.spans()
    windows = sorted((sp.t0, sp.t1) for sp in spans
                     if sp.name == "frontdesk.dispatch")
    rec_busy = [dt for t, dt in rec_s
                if any(a <= t <= b for a, b in windows)]
    if len(rec_busy) < FD_RECOMMENDS:
        fail(f"front desk: {len(rec_busy)} recommend calls while the plane "
             f"dispatched ({len(rec_s)} in all), want {FD_RECOMMENDS}")
    persist_s = svc._h_round["persist_s"].sum
    if persist_s <= 0.0 or svc.vault_snapshots <= 0:
        fail(f"front desk: persist_s {persist_s}, vault snapshots "
             f"{svc.vault_snapshots}")
    by_class = _by_class(tickets, admit_s)
    wave_by_class = _by_class(wave, wave_admit_s)
    # the sessions' states as the vault phase must find them again
    closed = {}
    for spec, t in zip(specs, tickets):
        sess = svc._sessions.get(t.session_id)
        st = None if sess is None else sess.state
        if st is None or st.store.n_points == 0:
            continue
        arrays, meta = export_pf_state(st)
        rec = svc.recommend(t.session_id)
        closed[spec.signature()] = {"arrays": arrays, "meta": meta,
                                    "config": rec.config,
                                    "index": rec.index}
    for t in tickets:
        svc.close_session(t.session_id)
    if not vault.flush(timeout=120.0):
        fail("front desk: the vault did not flush")
    vault.close()
    plane = desk.stats()
    out = {"tickets": len(tickets), "wall_s": wall_s, "submit_s": submit_s,
           "by_class": by_class, "wave_by_class": wave_by_class,
           "recommend_s": {"while_dispatching": _pcts(rec_busy),
                           "all": _pcts([dt for _, dt in rec_s])},
           "dispatch_walls_s": [b - a for a, b in windows],
           "dispatches": plane["dispatches"],
           "dispatched_probes": plane["dispatched_probes"],
           "fast_completions": plane["fast_completions"],
           "persist_s": persist_s,
           "round_s": {p: h.sum for p, h in svc._h_round.items()},
           "vault_snapshots": svc.vault_snapshots,
           "vault": vault.stats(), "closed_with_frontier": len(closed),
           "executor": svc.executor.stats()}
    log(f"front desk: {out}")
    return {**out, "_specs": specs, "_closed": closed}


def phase_vault(dev, vault_dir, specs, closed) -> dict:
    """A fresh ``MOOService(use_kernel=True)`` on the front desk's vault
    directory re-creates every tenant's session: each one that closed with
    a frontier is restored with no executor dispatch, its exported state
    (row history, Pareto mask, rectangle queue, box, traces) equal bit for
    bit to the closed one's, and its recommendation the same
    configuration."""
    import numpy as np

    from repro_torch.core.progressive_frontier import export_pf_state
    from repro_torch.persist import FrontierVault
    from repro_torch.service import MOOService

    vault = FrontierVault(vault_dir)
    t0 = time.perf_counter()
    svc = MOOService(use_kernel=True, max_sessions=512, vault=vault,
                     device=dev)
    per_s, sids = [], {}
    for spec in specs:
        t1 = time.perf_counter()
        sids[spec.signature()] = svc.create_session(spec)
        per_s.append(time.perf_counter() - t1)
    restore_s = time.perf_counter() - t0
    if svc.vault_restores != len(closed):
        fail(f"vault: {svc.vault_restores} restores, {len(closed)} "
             f"sessions closed with a frontier")
    if svc.executor.dispatches != 0:
        fail(f"vault: {svc.executor.dispatches} executor dispatches on "
             f"restore")
    for sig, want in closed.items():
        sess = svc._sessions[sids[sig]]
        arrays, meta = export_pf_state(sess.state)
        if sorted(arrays) != sorted(want["arrays"]):
            fail(f"vault: restored arrays {sorted(arrays)}")
        for k, a in want["arrays"].items():
            got = np.asarray(arrays[k])
            a = np.asarray(a)
            if (got.dtype != a.dtype or got.shape != a.shape
                    or got.tobytes() != a.tobytes()):
                fail(f"vault: restored {k} differs from the closed "
                     f"session's")
        for k in ("probes", "initial_volume", "store"):
            if meta[k] != want["meta"][k]:
                fail(f"vault: restored meta {k} {meta[k]} != "
                     f"{want['meta'][k]}")
        rec = svc.recommend(sids[sig])
        if rec.index != want["index"] or rec.config != want["config"]:
            fail("vault: a restored session recommends another "
                 "configuration")
        if sess.state.store.device.type != "cuda":
            fail(f"vault: a restored store on {sess.state.store.device}")
    if svc.executor.dispatches != 0:
        fail("vault: recommend dispatched")
    vault.close()
    out = {"sessions": len(specs), "restores": svc.vault_restores,
           "restore_all_s": restore_s,
           "restore_per_session_s": {**_pcts(per_s), "max": max(per_s)},
           "executor_dispatches": svc.executor.dispatches}
    log(f"vault: {out}")
    return out


def registry_rehydrate(dev, reg, vault_dir) -> dict:
    """A fresh ``ModelRegistry`` on the model-server phase's vault
    directory rehydrates every workload that phase promoted: the same
    task-spec signatures (the snapshot identity the frontier vault keys
    on), the same versions, models on the card, and no fit."""
    from repro_torch.modelserver import ModelRegistry
    from repro_torch.modelserver import registry as registry_mod
    from repro_torch.persist import FrontierVault

    if not reg.vault.flush(timeout=120.0):
        fail("registry: the vault did not flush")
    sigs = sorted(reg._records)
    fits = [0]
    real = registry_mod.train_candidate

    def counted(*a, **kw):
        fits[0] += 1
        return real(*a, **kw)

    registry_mod.train_candidate = counted
    try:
        fresh = ModelRegistry(trainer=reg.trainer, drift=reg.drift_config,
                              vault=FrontierVault(vault_dir), device=dev)
        t0 = time.perf_counter()
        got = fresh.rehydrate()
        _sync(dev)
        seconds = time.perf_counter() - t0
    finally:
        registry_mod.train_candidate = real
    if sorted(got) != sigs or fits[0] != 0:
        fail(f"registry: rehydrated {len(got)} of {len(sigs)} workloads "
             f"with {fits[0]} fits")
    for sig in sigs:
        if (fresh.task_spec(sig).signature()
                != reg.task_spec(sig).signature()):
            fail(f"registry: {reg.info(sig)['name']} rehydrated with "
                 f"another task signature")
        if fresh.info(sig)["version"] != reg.info(sig)["version"]:
            fail("registry: a rehydrated version differs")
        if any(m.device.type != "cuda"
               for m in fresh.snapshot(sig).models):
            fail("registry: a rehydrated model is off the card")
    reg.vault.close()
    fresh.vault.close()
    out = {"workloads": len(got), "persisted": reg.workloads_persisted,
           "rehydrate_s": seconds, "fits": fits[0],
           "versions": sorted(fresh.info(s)["version"] for s in sigs)}
    log(f"registry rehydrate: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 6: the model server
# ---------------------------------------------------------------------------


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def phase_modelserver(dev, vault_dir, n_workloads: int = MS_WORKLOADS,
                      n_traces: int = MS_TRACES, hidden=PAPER_HIDDEN,
                      shift_rows: int = SHIFT_ROWS,
                      min_probes: int = MS_PROBES) -> dict:
    """The modeling engine online, at the paper's surrogate width.

    One ``ModelRegistry`` (``TrainerConfig(hidden=(128,)*4,
    log_target=True)``, otherwise the defaults: dropout 0.05, 60 epochs)
    holds ``n_workloads`` workloads of ``batch_suite()`` over the 12 Spark
    knobs with ``n_traces`` traces each from ``generate_traces`` (ground
    truth on the card, 8 % log-normal noise), plus one workload fit with the
    GP backend (``gp_max_points`` 1024).  Each is retrained to v1 (gated
    promotion; later MLP workloads warm-start from their nearest neighbour
    and hedge with a cold fit), then served by one ``MOOService`` session
    per workload (``create_workload_session``) run to ``min_probes``
    probes.  Then ``shift_rows`` traces of another workload's surface are
    streamed into the first workload: the drift watermark fires, the
    registry trims to the new rows and retrains inline
    (``retrain_on_drift``) to v2, and one more pass warm re-solves its
    session.  The registry persists every promotion to a vault in
    ``vault_dir`` (``registry_rehydrate`` reads it back)."""
    import torch

    from repro_torch.core import Objective
    from repro_torch.data.workloads import (
        batch_problem,
        batch_suite,
        generate_traces,
        spark_space,
    )
    from repro_torch.modelserver import ModelRegistry, TrainerConfig
    from repro_torch.modelserver.trainer import gate_split, relative_error
    from repro_torch.persist import FrontierVault
    from repro_torch.service import MOOService

    suite = batch_suite()
    knobs = tuple(spark_space())
    objectives = (Objective("latency_s"), Objective("cost_usd"))
    mlp_cfg = TrainerConfig(hidden=tuple(hidden), log_target=True)
    gp_cfg = TrainerConfig(backend="gp", gp_max_points=1024,
                           log_target=True)
    reg = ModelRegistry(trainer=mlp_cfg, retrain_on_drift=True,
                        trim_on_drift=shift_rows,
                        vault=FrontierVault(vault_dir), device=dev)
    events = []
    reg.subscribe(lambda ev: events.append((time.perf_counter(), ev)))
    t0 = time.perf_counter()
    sigs, traces = [], {}
    for i, w in enumerate(suite[:n_workloads + 1]):
        sig = reg.register_workload(("batch", w.name), knobs, objectives,
                                    name=w.name)
        X, Y = generate_traces(batch_problem(w, device=dev), n_traces,
                               seed=100 + i)
        reg.observe_batch(sig, X, Y)
        sigs.append(sig)
        traces[sig] = (X, Y)
    _sync(dev)
    ingest_s = time.perf_counter() - t0
    gp_sig = sigs[-1]
    per = {}
    for sig in sigs:
        cfg = gp_cfg if sig == gp_sig else mlp_cfg
        t1 = time.perf_counter()
        rep = reg.retrain(sig, cfg)
        _sync(dev)
        fit_s = time.perf_counter() - t1
        name = reg.info(sig)["name"]
        if not (rep.improved and rep.version == 1):
            fail(f"model server: {name} was not promoted to v1 "
                 f"({rep.outcome.candidate_error} vs "
                 f"{rep.outcome.previous_error})")
        X, Y = traces[sig]
        _, va = gate_split(len(X), cfg.val_frac, cfg.seed)
        t1 = time.perf_counter()
        err = relative_error(reg.snapshot(sig).models, X[va], Y[va])
        _sync(dev)
        gate_s = time.perf_counter() - t1
        if abs(err - rep.outcome.candidate_error) > 1e-6:
            fail(f"model server: {name} gate error {err} does not repeat "
                 f"{rep.outcome.candidate_error}")
        warm = rep.outcome.warm_started_from
        per[name] = {"backend": cfg.backend, "fit_s": fit_s,
                     "gate_s": gate_s, "gate_rows": int(len(va)),
                     "gate_error": rep.outcome.candidate_error,
                     "warm_start": (None if warm is None else "self"
                                    if warm == "self" else "neighbour")}
        log(f"model server: v1 {name}: {per[name]}")

    svc = MOOService(use_kernel=True, device=dev)
    t1 = time.perf_counter()
    sids = {sig: svc.create_workload_session(reg, sig) for sig in sigs}
    svc.run_until(min_probes=min_probes)
    _sync(dev)
    solve_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    gp_round = svc.step_sessions([sids[gp_sig]], origin=None)
    _sync(dev)
    gp_round_s = time.perf_counter() - t1
    recommend_ms = []
    for sig, sid in sids.items():
        t1 = time.perf_counter()
        rec = svc.recommend(sid)
        recommend_ms.append((time.perf_counter() - t1) * 1e3)
        if len(rec.config) != 12:
            fail("model server: a recommendation does not set the 12 knobs")
        sess = svc._sessions[sid]
        check_frontier(sess.engine.finalize(sess.state), sess.problem,
                       f"model server {reg.info(sig)['name']} v1")
    log(f"model server: {len(sids)} sessions to {min_probes} probes in "
        f"{solve_s:.2f} s; GP session round {gp_round['timing']}")

    # drift: stream the surface of the workload (among the next 20) the
    # target's v1 model predicts worst
    target = sigs[0]
    model = reg.snapshot(target).models
    best = None
    for j, w in enumerate(suite[n_workloads + 1:n_workloads + 21]):
        Xs, Ys = generate_traces(batch_problem(w, device=dev), shift_rows,
                                 seed=500 + j)
        err = relative_error(model, Xs, Ys)
        if best is None or err > best[0]:
            best = (err, w.name, Xs, Ys)
    shift_err, shift_name, Xs, Ys = best
    n_events = len(events)
    t_obs = time.perf_counter()
    evs = reg.observe_batch(target, Xs, Ys)
    _sync(dev)
    observe_s = time.perf_counter() - t_obs
    kinds = [e.kind for e in evs]
    if kinds != ["drift", "version"]:
        fail(f"model server: drift stream gave events {kinds}, expected "
             f"one drift, then the inline retrain's version")
    if [e.kind for _, e in events[n_events:]] != kinds:
        fail("model server: subscribers saw other events than observe "
             "returned")
    t_drift = events[n_events][0]
    info = reg.info(target)
    if info["version"] != 2 or info["stale"]:
        fail(f"model server: after the inline retrain {info}")
    st = svc.stats()
    if st["stale_sessions"] != 1 or st["frontier_invalidations"] != 1:
        fail(f"model server: invalidation {st}")
    svc.run_until(min_probes=min_probes)
    _sync(dev)
    t_fresh = time.perf_counter()
    st = svc.stats()
    if st["warm_resolves"] < 1 or st["stale_sessions"] != 0:
        fail(f"model server: no warm re-solve {st}")
    sess = svc._sessions[sids[target]]
    if sess.spec.model_id != ("modelserver", target, 2):
        fail(f"model server: the session serves {sess.spec.model_id}")
    check_frontier(sess.engine.finalize(sess.state), sess.problem,
                   "model server shifted workload v2")
    drift = {"source": shift_name, "v1_error_on_source": shift_err,
             "rows": shift_rows, "observe_and_retrain_s": observe_s,
             "v2_gate_error": evs[1].detail["val_error"],
             "v2_warm_start": evs[1].detail["warm_started_from"],
             "drift_to_fresh_frontier_s": t_fresh - t_drift,
             "probes_after": svc.session_info(sids[target]).probes}
    log(f"model server: drift {drift}")
    for obj in (reg, svc.executor, *(svc._sessions[s].state.store
                                     for s in sids.values())):
        if obj.device.type != torch.device(dev).type:
            fail(f"model server: {type(obj).__name__} on {obj.device}")
    ex = svc.executor.stats()
    log(f"model server executor stats: {ex}")
    return {"workloads": per, "ingest_s": ingest_s, "_registry": reg,
            "sessions_solve_s": solve_s,
            "gp_round_s": gp_round_s,
            "gp_dispatch_s": gp_round["timing"]["solve_s"],
            "recommend_ms": recommend_ms, "drift": drift,
            "stats": svc.stats(), "executor": ex,
            "gate_rows": per[reg.info(sigs[0])["name"]]["gate_rows"]}


# ---------------------------------------------------------------------------
# Phase 7: LM serving
# ---------------------------------------------------------------------------


def _bound(flops: float, nbytes: float, peak_flops: float,
           sfu_ops: float = 0.0) -> dict:
    """The least time of ``flops`` at ``peak_flops``, ``sfu_ops`` (exps) at
    the SFUs' rate and ``nbytes`` at the HBM rate, in ms, and which bounds
    it ("operations" for either kind of operation; ``bound_terms_ms`` has
    each term)."""
    t_flops = flops / peak_flops * 1e3
    t_sfu = sfu_ops / PEAK_SFU_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(t_flops, t_sfu)
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if sfu_ops:
        out["bound_terms_ms"] = {"bytes": t_bytes, "fp32": t_flops,
                                 "sfu": t_sfu}
    return out


def _wkv_inputs(dev, B: int, T: int, H: int, dh: int, seed: int,
                state: bool):
    """r/k/v normal, w = exp(-exp(0.5 N)), u = 0.5 N and, with ``state``, a
    nonzero S0 (``tests/test_kernels.py::TestRwkvWKV``'s draws)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    r, k, v = (f32(rng.normal(size=(B, T, H, dh))) for _ in range(3))
    w = f32(np.exp(-np.exp(rng.normal(size=(B, T, H, dh)) * 0.5)))
    u = f32(rng.normal(size=(H, dh)) * 0.5)
    S0 = f32(rng.normal(size=(B, H, dh, dh)) * 0.5) if state else None
    return r, k, v, w, u, S0


def _attn_inputs(dev, S: int, dtype, seed: int, H=LM_HEADS, Hk=LM_KV_HEADS,
                 dh=LM_HEAD_DIM):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda *sh: torch.tensor(rng.normal(size=sh), dtype=torch.float32,  # noqa: E731
                                 device=dev).to(dtype)
    return t(1, S, H, dh), t(1, S, Hk, dh), t(1, S, Hk, dh)


def _scan_inputs(dev, T: int, seed: int, state: bool, d=LM_SCAN_D,
                 n=LM_SCAN_N, B=1):
    """dt = softplus(N), B_t, C_t, x normal, A = -exp(0.3 N) and, with
    ``state``, a nonzero h0 (``tests/test_kernels.py::TestMambaScan``'s
    draws)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    dt = f32(np.logaddexp(rng.normal(size=(B, T, d)), 0))
    Bt, Ct = (f32(rng.normal(size=(B, T, n))) for _ in range(2))
    xs = f32(rng.normal(size=(B, T, d)))
    A = f32(-np.exp(rng.normal(size=(d, n)) * 0.3))
    h0 = f32(rng.normal(size=(B, d, n)) * 0.5) if state else None
    return dt, Bt, Ct, xs, A, h0


def phase_lm_kernels(dev) -> dict:
    """rwkv6_wkv and flash_attention against their plain versions at the LM
    path's shapes: WKV at RWKV-6 3B's 40 heads of 64 (a 512-token prefill
    from zero at B = 1 and at B = 4, the two layouts of the kernel, a
    decode step and an odd 37-step run from a nonzero state; y and the
    final state at 3e-4), flash at Qwen3-4B's 32/8 heads of 128 (S = 16,
    37, 512, 4096; bf16 at 2e-2, fp32 at 2e-3; one non-causal case);
    mamba_scan at Jamba's d_inner 8192 and 16 states (a 512-token prefill
    from zero and from a nonzero state, at B = 1 and from zero at B = 4,
    the two lane layouts of the kernel; a decode step and an odd 37-step
    run from a state; y and the final state at 3e-4)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_cuda

    wkv_err = 0.0
    for B, T, state in ((1, 512, False), (4, 512, False), (1, 1, True),
                        (1, 37, True)):
        args = _wkv_inputs(dev, B, T, LM_WKV_HEADS, LM_WKV_DH, T + B, state)
        y, S = rwkv6_wkv_cuda(*args)
        want_y, want_S = ref.rwkv6_wkv(*args)
        label = f"rwkv6_wkv B={B} T={T}"
        wkv_err = max(wkv_err, _close(y, want_y, LM_WKV_TOL, f"{label} y"),
                      _close(S, want_S, LM_WKV_TOL, f"{label} S"))
    flash_err = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-3)):
        worst = 0.0
        for S in LM_FLASH_S:
            q, k, v = _attn_inputs(dev, S, dtype, S)
            got = flash_attention_cuda(q, k, v)
            if got.dtype != dtype:
                fail(f"flash_attention returned {got.dtype} for {dtype}")
            worst = max(worst, _close(
                got.float(), flash_attention_plain(q, k, v).float(), tol,
                f"flash_attention S={S} {dtype}"))
        flash_err[str(dtype).split(".")[-1]] = worst
    q, k, v = _attn_inputs(dev, 512, torch.float32, 1)
    flash_err["non_causal_float32"] = _close(
        flash_attention_cuda(q, k, v, causal=False),
        flash_attention_plain(q, k, v, causal=False), 2e-3,
        "flash_attention non-causal")
    scan_err = 0.0
    for B, T, state in ((1, 512, False), (1, 512, True), (4, 512, False),
                        (1, 1, True), (1, 37, True)):
        args = _scan_inputs(dev, T, T + int(state) + B, state, B=B)
        y, h = mamba_scan_cuda(*args)
        want_y, want_h = ref.mamba_scan(*args)
        label = f"mamba_scan B={B} T={T}{' from h0' if state else ''}"
        scan_err = max(scan_err,
                       _close(y, want_y, LM_SCAN_TOL, f"{label} y"),
                       _close(h, want_h, LM_SCAN_TOL, f"{label} h_fin"))
    log(f"lm kernels: rwkv6_wkv max |d| {wkv_err:.3e}; flash_attention "
        f"{flash_err}; mamba_scan {scan_err:.3e}")
    return {"wkv_err": wkv_err, "flash_err": flash_err, "scan_err": scan_err}


@contextlib.contextmanager
def forced(module, name: str, value):
    """``module.name`` (a layout choice the wrapper looks up at each call)
    answering ``value`` whatever it is asked, for an in-run comparison of a
    kernel's layouts; the port's own choice is restored on exit."""
    chosen = getattr(module, name)
    setattr(module, name, lambda *args: value)
    try:
        yield
    finally:
        setattr(module, name, chosen)


def wkv_timing(dev, T: int, state: bool, reps: int, B: int = 1,
               plain: bool = True) -> dict:
    """Kernel and plain times of rwkv6_wkv at RWKV-6 3B's heads, and the
    layout the wrapper chose."""
    from repro_torch.kernels import platform, ref
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_cuda, wkv_split

    H, dh = LM_WKV_HEADS, LM_WKV_DH
    args = _wkv_inputs(dev, B, T, H, dh, 7, state)
    ms = time_ms(lambda: rwkv6_wkv_cuda(*args), reps)
    plain_ms = (time_ms(lambda: ref.rwkv6_wkv(*args), max(2, reps // 20))
                if plain else None)
    nbytes = 4 * (5 * B * T * H * dh + (2 if state else 1) * B * H * dh * dh
                  + H * dh)
    # per step and head: y_j = sum_i r_i S_ij (dh^2 FMAs; the u-term is
    # O(dh)) and S = w * S + k v^T (a multiply and an FMA per element):
    # 3 dh^2 instructions, 6 dh^2 flops at the FMA-counted fp32 peak
    split = wkv_split(B * H, platform.sm_count(dev.index))
    return {"shape": [B, T, H, dh], "state": state, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "layout": "split" if split else "whole",
            **_bound(6.0 * B * T * H * dh * dh, nbytes, PEAK_FP32_S)}


def wkv_layouts(dev, reps: int = 50) -> dict:
    """The WKV kernel at T = 512 on each layout, at B = 1 and B = 4 (B*H
    below and above the SM count): ms by layout, beside the wrapper's
    choice."""
    from repro_torch.kernels import platform
    from repro_torch.kernels import rwkv6_wkv as rk

    out = {}
    for B in (1, 4):
        row = {}
        for layout in ("split", "whole"):
            with forced(rk, "wkv_split", layout == "split"):
                row[layout] = wkv_timing(dev, 512, False, reps, B=B,
                                         plain=False)["ms"]
        row["chosen"] = ("split" if rk.wkv_split(
            B * LM_WKV_HEADS, platform.sm_count(dev.index)) else "whole")
        out[f"B{B}"] = row
    return out


def scan_timing(dev, T: int, state: bool, reps: int, B: int = 1,
                plain: bool = True) -> dict:
    """Kernel and plain times of mamba_scan at Jamba's d_inner and d_state
    (no single PyTorch call computes a selective scan)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda

    d, n = LM_SCAN_D, LM_SCAN_N
    args = _scan_inputs(dev, T, 7, state, B=B)
    ms = time_ms(lambda: mamba_scan_cuda(*args), reps)
    plain_ms = (time_ms(lambda: ref.mamba_scan(*args), max(2, reps // 20))
                if plain else None)
    # dt, x and y; B_t and C_t; A; h_fin (and h0)
    nbytes = 4 * (3 * B * T * d + 2 * B * T * n
                  + (2 if state else 1) * B * d * n + d * n)
    # per step, channel and state: dt*A, dA*h, (dt x)*B, the add and the
    # FMA of y, 6 flops at the fp32 peak; and one accurate expf, one
    # MUFU.EX2 on the SFUs
    return {"shape": [B, T, d, n], "state": state, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            **_bound(6.0 * B * T * d * n, nbytes, PEAK_FP32_S,
                     sfu_ops=float(B * T * d * n))}


def _us_per_call(fn, reps: int) -> float:
    """Microseconds a call of ``fn()`` back to back on the host's clock
    (``time.perf_counter``) over ``reps`` calls after 50 warm-up calls; the
    device is synchronised before the first and after the last."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def decode_host_pieces(dev, reps: int = 2000) -> dict:
    """The host side of a decode call of each recurrence wrapper, piece by
    piece, in microseconds a call (``_us_per_call``, ``reps`` calls each):
    WKV at RWKV-6 3B's 1 x 1 x 40 x 64 from a state, the scan at Jamba's
    1 x 1 x 8192 x 16 from a state.  The pieces are the wrapper's own:
    ``_check``, the copies (``contiguous`` of every input, no-ops here),
    two ``new_empty``, ``_pack``, the current-device check, the raw
    stream, the foreign call with its launch, ``native.check``.  ``call``
    is the wrapper back to back, ``apply`` its ``autograd.Function`` (what
    the model calls) and ``ops`` the model's entry point in
    ``kernels.ops``."""
    import torch

    from repro_torch.kernels import mamba_scan as msc
    from repro_torch.kernels import native, ops, platform
    from repro_torch.kernels import rwkv6_wkv as rk

    lib = native.library()
    idx = dev.index
    t = lambda fn: _us_per_call(fn, reps)  # noqa: E731

    def pieces(mod, args, outs, extra, fn):
        tensors = [x for x in args if x is not None]
        packed = mod._pack(*args, *outs, *extra)
        rec = {
            "checks": t(lambda: mod._check(*args)),
            "copies": t(lambda: [x.contiguous() for x in tensors]),
            "allocations": t(lambda: [args[0].new_empty(o.shape)
                                      for o in outs]),
            "packed_arguments": t(lambda: mod._pack(*args, *outs, *extra)),
            "device_check": t(lambda: idx == torch.cuda.current_device()),
            "stream_lookup": t(lambda: torch._C._cuda_getCurrentRawStream(
                idx)),
            "foreign_call": t(lambda: fn(
                packed, torch._C._cuda_getCurrentRawStream(idx))),
            "native_check": t(lambda: native.check(0, "launch"))}
        rec["sum"] = sum(rec.values())
        return rec

    args = _wkv_inputs(dev, 1, 1, LM_WKV_HEADS, LM_WKV_DH, 11, True)
    split = rk.wkv_split(LM_WKV_HEADS, platform.sm_count(idx))
    wkv = pieces(rk, args, rk.rwkv6_wkv_cuda(*args), (split,),
                 lib.rwkv6_wkv)
    wkv.update(call=t(lambda: rk.rwkv6_wkv_cuda(*args)),
               apply=t(lambda: rk.rwkv6_wkv(*args)),
               ops=t(lambda: ops.rwkv_wkv(*args)))

    args = _scan_inputs(dev, 1, 12, True)
    scan = pieces(msc, args, msc.mamba_scan_cuda(*args), (), lib.mamba_scan)
    scan.update(call=t(lambda: msc.mamba_scan_cuda(*args)),
                apply=t(lambda: msc.mamba_scan(*args)),
                ops=t(lambda: ops.mamba_selective_scan(*args)))
    return {"rwkv6_wkv": wkv, "mamba_scan": scan, "reps": reps}


def flash_timing(dev, S: int, dtype, reps: int) -> dict:
    """Kernel, plain and library (SDPA, a yardstick the port never calls)
    times of causal flash attention at B=1, Qwen3-4B's heads."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )

    H, Hk, dh = LM_HEADS, LM_KV_HEADS, LM_HEAD_DIM
    q, k, v = _attn_inputs(dev, S, dtype, 3)
    ms = time_ms(lambda: flash_attention_cuda(q, k, v), reps)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v),
                       max(2, reps // 4))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps)
    esize = q.element_size()
    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_FP32_S
    return {"shape": [1, S, H, Hk, dh], "dtype": str(dtype).split(".")[-1],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **_bound(2.0 * H * S * (S + 1) * dh,
                     esize * (2 * S * H * dh + 2 * S * Hk * dh), peak)}


def _decode_bytes(cparams) -> int:
    """Bytes of the compute-dtype weights one decode token reads: every
    leaf once, but one row of the embedding table."""
    from repro_torch.nn.model import tree_leaves

    total = sum(t.numel() * t.element_size() for t in tree_leaves(cparams))
    if "embed" in cparams:
        tok = cparams["embed"]["tok"]
        total -= (tok.shape[0] - 1) * tok.shape[1] * tok.element_size()
    return total


def _decode_flops(cparams, cfg) -> float:
    """Operations of one decode token's weight products: two a weight (no
    embedding lookup), but two a weight and capacity slot for the MoE
    experts, which the dense dispatch runs over every slot for one token;
    the attention over the cache and the elementwise work are left out."""
    from repro_torch.nn.model import tree_leaves
    from repro_torch.nn.moe import expert_capacity

    n = sum(t.numel() for k, v in cparams.items() if k != "embed"
            for t in tree_leaves(v))
    if cfg.tie_embeddings:
        n += cparams["embed"]["tok"].numel()
    flops = 2.0 * n
    if cfg.moe is not None:
        expert = sum(layer["moe"][w].numel() for unit in cparams["blocks"]
                     for layer in unit.values() if "moe" in layer
                     for w in ("w1", "w2", "w3") if w in layer["moe"])
        flops += 2.0 * (expert_capacity(cfg.moe) - 1) * expert
    return flops


def lm_profile(dev, engine, cfg, max_seq: int) -> dict:
    """Where one decode step and one 512-token prefill spend their time:
    wall ms (host clock, mean of 3, ending in a sync), the device's kernel
    ms and count from the profiler (CUDA activity only, one call), and
    the device's idle share of the wall time; the five kernels that take
    most device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nn import decode_step, init_cache, prefill

    cache = init_cache(cfg, 1, max_seq, device=dev)
    tok = engine._tokens([[1]])
    prompt = engine._tokens(np.arange(max(LM_PROMPTS))[None] % cfg.vocab)
    calls = {
        "decode": lambda: decode_step(engine.cparams, cfg, cache,
                                      {"tokens": tok}, max(LM_PROMPTS)),
        "prefill_512": lambda: prefill(engine.cparams, cfg,
                                       {"tokens": prompt}, max_seq=max_seq),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            _sync(dev)
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        dev_t = lambda e: getattr(e, "device_time_total",  # noqa: E731
                                  getattr(e, "cuda_time_total", 0.0))
        busy_ms = sum(dev_t(e) for e in kern) / 1e3
        top = sorted(kern, key=dev_t, reverse=True)[:5]
        seen = busy_ms > 0  # else the profiler recorded no device time
        out[name] = {"wall_ms": wall_ms,
                     "device_ms": busy_ms if seen else None,
                     "kernels": sum(e.count for e in kern),
                     "idle_share": 1.0 - busy_ms / wall_ms if seen else None,
                     "top": [[e.key[:60], dev_t(e) / 1e3, e.count]
                             for e in top]}
    return out


def _mixer_layers(cfg, kind: str) -> int:
    """Layers of the model whose mixer is ``kind`` (``rwkv``, ``attn`` or
    ``mamba``)."""
    from repro_torch.nn.blocks import layer_plan, scan_length

    return scan_length(cfg) * sum(m == kind for m, _ in layer_plan(cfg))


def _no_plain_on_card(platform, label: str) -> dict:
    plain = platform.plain_on_cuda_counts()
    for name in ("rwkv6_wkv", "flash_attention", "mamba_scan"):
        if plain.get(name, 0):
            fail(f"{label}: the plain {name} ran {plain[name]} times on a "
                 f"CUDA tensor")
    if platform.plain_backward_on_cuda_counts():
        fail(f"{label}: backward recomputes on the card: "
             f"{platform.plain_backward_on_cuda_counts()}")
    return plain


def _free() -> None:
    """Hand the memory of dropped tensors back to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _instance(dev, cfg):
    """``init_params`` of ``cfg`` on the card, seed 0: (params, parameter
    count, seconds)."""
    from repro_torch.nn import init_params
    from repro_torch.nn.model import tree_leaves

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_dtype} parameters, {n_params / 1e9:.3f} B in "
        f"{init_s:.1f} s")
    return params, n_params, init_s


def lm_serve(dev, arch: str) -> dict:
    """One model at full width, weights random from seed 0; the depth and
    parameter dtype of its fp32 check and of its served instance as
    ``LM_CUTS`` sets them (full depth, fp32 parameters when it does not).

    First, in fp32 compute, against the full-sequence forward over 17
    tokens: 16 decode steps from an empty cache, and one decode step from
    the cache of a 16-token prefill (the hand-off of the KV cache, the WKV
    state or the Mamba state, conv window and MoE loads), each at
    ``LM_FP32_TOL``.  Then ``ServeEngine`` in the model's bf16 compute: 4
    slots, 8 requests with prompts cycling over 16/64/256/512 tokens, 32
    new tokens each, greedy; prefill and decode calls timed (each ends in a
    device sync).  The launch counts are those of ``engine.run`` alone, and
    must be one per mixer layer and call."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import platform
    from repro_torch.nn import decode_step, forward, init_cache, prefill
    from repro_torch.nn.model import tree_leaves
    from repro_torch.serving import Request, ServeEngine

    check_cut, serve_cut = LM_CUTS.get(arch, ({}, None))
    cfg = get_config(arch).replace(**check_cut)
    torch.cuda.reset_peak_memory_stats(dev)
    params, n_check, init_s = _instance(dev, cfg)

    cfg32 = cfg.replace(compute_dtype="float32")
    n = LM_CHECK_LEN
    platform.reset_launches()  # the kernel checks ran the plain versions
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, n + 1)), device=dev)
    full, _ = forward(params, cfg32, {"tokens": toks}, mode="train")
    cache = init_cache(cfg32, 1, n + 4, device=dev)
    dec = 0.0
    for t in range(n):
        lg, cache = decode_step(params, cfg32, cache,
                                {"tokens": toks[:, t:t + 1]}, t)
        dec = max(dec, _close(lg, full[:, t], LM_FP32_TOL,
                              f"{arch} fp32 decode step {t}"))
    _, cache = prefill(params, cfg32, {"tokens": toks[:, :n]},
                       max_seq=n + 4)
    lg, _ = decode_step(params, cfg32, cache, {"tokens": toks[:, n:]}, n)
    check = {"decode": dec, "decode_after_prefill": _close(
        lg, full[:, n], LM_FP32_TOL, f"{arch} fp32 decode after prefill"),
        "layers": cfg.n_layers, "params_b": n_check / 1e9,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del full, cache, lg
    log(f"{arch}: fp32 decode vs forward max |d| {check}")
    _no_plain_on_card(platform, f"{arch} fp32 check")
    n_params = n_check
    if serve_cut is not None:  # free the check's instance, build another
        del params
        _free()
        cfg = get_config(arch).replace(**serve_cut)
        torch.cuda.reset_peak_memory_stats(dev)
        params, n_params, init_s = _instance(dev, cfg)

    max_seq = max(LM_PROMPTS) + LM_MAX_NEW + 8
    engine = ServeEngine(params, cfg, batch=LM_SLOTS, max_seq=max_seq,
                         device=dev)
    prefill_s, decode_s = {}, []
    inner_prefill, inner_decode = engine._prefill, engine._decode

    def timed_prefill(p, b):
        t1 = time.perf_counter()
        out = inner_prefill(p, b)
        _sync(dev)
        prefill_s.setdefault(int(b["tokens"].shape[1]), []).append(
            time.perf_counter() - t1)
        return out

    def timed_decode(p, c, b, pos):
        t1 = time.perf_counter()
        out = inner_decode(p, c, b, pos)
        _sync(dev)
        decode_s.append(time.perf_counter() - t1)
        return out

    engine._prefill, engine._decode = timed_prefill, timed_decode
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, LM_PROMPTS[i % len(LM_PROMPTS)]).astype(np.int32),
        max_new=LM_MAX_NEW) for i in range(LM_REQUESTS)]
    platform.reset_launches()
    t0 = time.perf_counter()
    engine.run(reqs)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = platform.launch_counts()
    routes = platform.route_counts()
    plain = _no_plain_on_card(platform, f"{arch} ServeEngine.run")
    log(f"{arch} ServeEngine.run launches: {launches}; routes: {routes}; "
        f"plain versions on the card: {plain}")
    if routes.get("flash_attention:wgmma", 0) != launches.get(
            "flash_attention", 0):
        fail(f"{arch}: bf16 prefills' flash launches by route {routes}, "
             f"want all {launches.get('flash_attention', 0)} on wgmma")
    n_prefill = sum(len(v) for v in prefill_s.values())
    calls = n_prefill + len(decode_s)
    want = {"rwkv6_wkv": _mixer_layers(cfg, "rwkv") * calls,
            "mamba_scan": _mixer_layers(cfg, "mamba") * calls,
            "flash_attention": _mixer_layers(cfg, "attn") * n_prefill}
    for name, n_want in want.items():
        if launches.get(name, 0) != n_want:
            fail(f"{arch}: {name} launched {launches.get(name, 0)} times in "
                 f"ServeEngine.run, want {n_want} ({n_prefill} prefills, "
                 f"{len(decode_s)} decode steps)")
    for r in reqs:
        if not r.done or len(r.out) != LM_MAX_NEW or not all(
                0 <= t < cfg.vocab for t in r.out):
            fail(f"{arch}: request {r.rid} done={r.done} with "
                 f"{len(r.out)} tokens")
    for name, tree in (("params", params), ("cast params", engine.cparams),
                       ("slot caches", engine.slot_cache)):
        for t in tree_leaves(tree):
            if t.device.type != torch.device(dev).type:
                fail(f"{arch}: {name} hold a tensor on {t.device}")
    tokens = sum(len(r.out) for r in reqs)
    decode_bytes = _decode_bytes(engine.cparams)
    decode_flops = _decode_flops(engine.cparams, cfg)
    prof = lm_profile(dev, engine, cfg, max_seq)
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "param_dtype": cfg.param_dtype,
           "params_b": n_params / 1e9, "init_s": init_s,
           "launches": launches, "routes": routes,
           "fp32_check_err": check, "requests": len(reqs),
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "decode_calls": len(decode_s),
           "decode_ms_median": float(np.median(decode_s)) * 1e3,
           "decode_ms_p90": float(np.percentile(decode_s, 90)) * 1e3,
           "decode_bound_ms": decode_bytes / PEAK_BYTES_S * 1e3,
           "decode_ops_bound_ms": decode_flops / PEAK_BF16_S * 1e3,
           "prefill_ms": {n: float(np.median(v)) * 1e3
                          for n, v in sorted(prefill_s.items())},
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "profile": prof}
    log(f"{arch} serving: {out}")
    del engine, params
    _free()
    return out


def phase_lm(dev) -> dict:
    """The LM serving phase: the three kernels against their plain versions
    and timed, then RWKV-6 3B, Qwen3-4B, Jamba and qwen2-moe through
    ``ServeEngine``, each with the launch counts of its own
    ``ServeEngine.run``."""
    import torch

    chk = phase_lm_kernels(dev)
    timing = {"wkv_prefill": wkv_timing(dev, 512, False, 50),
              "wkv_prefill_b4": wkv_timing(dev, 512, False, 20, B=4),
              "wkv_decode": wkv_timing(dev, 1, True, 200),
              "wkv_layouts": wkv_layouts(dev),
              "scan_prefill": scan_timing(dev, 512, False, 50),
              "scan_prefill_b4": scan_timing(dev, 512, False, 20, B=4),
              "scan_decode": scan_timing(dev, 1, True, 200),
              "decode_host_us": decode_host_pieces(dev),
              "flash": {f"{dt}_{S}": flash_timing(dev, S, getattr(torch, dt),
                                                  20 if S > 512 else 100)
                        for dt in ("bfloat16", "float32")
                        for S in LM_FLASH_S}}
    log(f"lm kernel timing: {timing}")
    models, launches = {}, {}
    for arch in LM_ARCHS:
        models[arch] = lm_serve(dev, arch)
        launches[arch] = models[arch]["launches"]
    for arch, name in (("rwkv6-3b", "rwkv6_wkv"),
                       ("qwen3-4b", "flash_attention"),
                       ("jamba-v0.1-52b", "mamba_scan"),
                       ("jamba-v0.1-52b", "flash_attention"),
                       ("qwen2-moe-a2.7b", "flash_attention")):
        if launches[arch].get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {arch} serving "
                 f"path")
    return {"check": chk, "timing": timing, "models": models,
            "launches": launches}


def _decode_row(timing: dict) -> dict:
    """The decode call's numbers beside a recurrence kernel's prefill ones
    in the kernels line (T = 1 from a state, back to back)."""
    return {"decode_ms": timing["ms"], "decode_plain_ms": timing["plain_ms"],
            "decode_bound_ms": timing["bound_ms"],
            "decode_bound_by": timing["bound_by"]}


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
    p_times = {f"{N}x{M}": pareto_timing(dev, N, M, 2,
                                         reps=20 if N * M > 1 << 20 else 200)
               for N, M in PARETO_SHAPES}
    p_main = p_times["4x256"]
    log(f"pareto timing: {p_times}")
    store_add = store_add_timing(dev)
    log(f"frontier-store add, ms: {store_add}")
    d = phase_descend(dev)
    log(f"descend timing: {d}")
    c_err = phase_compose(dev)
    m_chk = phase_mlp(dev)
    mark("kernels")

    # phase 3: the main path, one task (launch counts of this run only)
    platform.reset_launches()
    single = phase_single_task(dev)
    launches = platform.launch_counts()
    routes = {"single_task": platform.route_counts()}
    plain = {"single_task": platform.plain_on_cuda_counts()}
    log(f"main-path launches: {launches}")
    single["by_route"] = single_task_descend(dev)
    mark("single_task")
    # phase 4: coalesced tenants (counted separately)
    platform.reset_launches()
    tenants = phase_tenants(dev)
    tenant_launches = platform.launch_counts()
    routes["tenants"] = platform.route_counts()
    plain["tenants"] = platform.plain_on_cuda_counts()
    log(f"tenant-path launches: {tenant_launches}")
    mark("tenants")
    # phase 5: the service with DAG jobs (counted separately)
    platform.reset_launches()
    service = phase_service(dev)
    service_launches = platform.launch_counts()
    routes["service"] = platform.route_counts()
    plain["service"] = platform.plain_on_cuda_counts()
    log(f"service-path launches: {service_launches}; routes: {routes}")
    # the compose kernel's time at a shape of its path: the ETL job's
    # extract x transform_a stage frontiers
    pts = service["dags"]["etl"]["stage_points"]
    c_main = compose_timing(dev, pts["extract"], pts["transform_a"], 2)
    c_big = compose_timing(dev, 4096, 4096, 2, reps=20)
    log(f"compose timing path shape: {c_main}")
    log(f"compose timing 4096x4096: {c_big}")
    mark("service")
    # phase 5b: the front desk over a kernel-path service with a vault
    # (counted separately; read after its dispatcher thread stops)
    import tempfile

    vault_root = Path(tempfile.mkdtemp(prefix="chip_smoke_vault_"))
    platform.reset_launches()
    desk = phase_frontdesk(dev, vault_root / "frontiers")
    fd_launches = platform.launch_counts()
    fd_plain = platform.plain_on_cuda_counts()
    log(f"front-desk launches: {fd_launches}; plain versions on the card: "
        f"{fd_plain}")
    for name in ("descend_batch", "cross_dominator_counts"):
        if fd_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched from the front desk's "
                 f"dispatcher thread")
    if fd_plain:
        fail(f"front desk: plain versions ran on the card: {fd_plain}")
    mark("frontdesk")
    # phase 5c: the vault, read back by a fresh service (counted separately)
    platform.reset_launches()
    vault = phase_vault(dev, vault_root / "frontiers", desk.pop("_specs"),
                        desk.pop("_closed"))
    vault["launches"] = platform.launch_counts()
    vault_plain = platform.plain_on_cuda_counts()
    if vault_plain:
        fail(f"vault: plain versions ran on the card: {vault_plain}")
    mark("vault")
    # phase 6: the model server (counted separately)
    platform.reset_launches()
    ms = phase_modelserver(dev, vault_root / "models")
    ms_launches = platform.launch_counts()
    ms_plain = platform.plain_on_cuda_counts()
    log(f"model-server-path launches: {ms_launches}; plain versions on the "
        f"card: {ms_plain}")
    if ms_launches.get("mlp_forward", 0) <= 0:
        fail("kernel mlp_forward was not launched on the model-server path")
    if ms_plain.get("mlp_forward", 0) != 0:
        fail(f"the plain MLP forward ran {ms_plain['mlp_forward']} times on "
             f"a CUDA tensor on the model-server path")
    m_gate = mlp_timing(dev, ms["gate_rows"])
    m_big = mlp_timing(dev, 4096)
    log(f"mlp_forward timing gate split: {m_gate}")
    log(f"mlp_forward timing 4096 rows: {m_big}")
    mark("modelserver")
    # the registry's vault, read back by a fresh registry
    vault["registry"] = registry_rehydrate(dev, ms.pop("_registry"),
                                           vault_root / "models")
    import shutil

    shutil.rmtree(vault_root, ignore_errors=True)
    mark("registry_rehydrate")
    # the device times of the two launch-sized kernels at their timed path
    # shapes, taken here and not in phases 2 and 5: the profiler's first
    # session (above, in mlp_timing) may leave CUPTI set up for the
    # process and slow later launches on the host (phases 3-6 read slower
    # when these ran in phases 2 and 5), so phases 2-6 run without it
    for timing in p_times.values():
        timing.update(pareto_device_ms(dev, *timing["shape"]))
    for timing in (c_main, c_big):
        timing.update(compose_device_ms(dev, *timing["shape"]))
    d.update(descend_device_ms(dev))
    log(f"device times: pareto {p_times}; compose {c_main}, {c_big}; "
        f"descend {d['device_ms']}")
    mark("device_times")
    # phase 7: LM serving (counted per model inside)
    lm = phase_lm(dev)
    mark("lm_serving")

    # phase 8: assertions
    for label, st in (("single task", single["stats"]),
                      ("tenants", tenants["stats"]),
                      ("service", service["executor"]),
                      ("model server", ms["executor"])):
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
    for label, counts in plain.items():
        for name in ("cross_dominator_counts", "pairwise_compose"):
            if counts.get(name, 0):
                fail(f"{label}: the plain {name} ran {counts[name]} times "
                     f"on a CUDA tensor")
    for label, counts in (("single_task", launches),
                          ("tenants", tenant_launches),
                          ("service", service_launches)):
        by_kernel = {}
        for route, n in routes[label].items():
            by_kernel.setdefault(route.split(":")[0], {})[route] = n
        if by_kernel.get("descend_batch") != {"descend_batch:resident":
                                              counts["descend_batch"]}:
            fail(f"{label}: descend launches by route {routes[label]}, "
                 f"want all {counts['descend_batch']} resident")
        # a store add's three launches: the batch against the live rows on
        # the 8-row tiles (capacity >= 64), the batch against itself and
        # the live rows against the kept batch on the short-FB body
        dom = by_kernel.get("cross_dominator_counts", {})
        if (set(dom) != {"cross_dominator_counts:short",
                         "cross_dominator_counts:tiles"}
                or sum(dom.values()) != counts["cross_dominator_counts"]):
            fail(f"{label}: dominance launches by body {dom}, want both "
                 f"bodies and {counts['cross_dominator_counts']} in all")
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
         "bound_by": p_main["bound_by"], "library_ms": None,
         "device_ms": p_main["device_ms"],
         "plain_device_ms": p_main["plain_device_ms"]},
        {"name": "descend_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mogd_descend.cu",
         "replaces": "src/repro/kernels/mogd_descend.py:239",
         "launches": launches["descend_batch"],
         "max_abs_err": d["max_abs_err"], "ms": d["ms"],
         "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
         "bound_by": d["bound_by"], "library_ms": None,
         "kernel_route": d["route"], "ms_before": d["ms_streaming"],
         "device_ms": d["device_ms"]},
        {"name": "pairwise_compose", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/compose.cu",
         "replaces": "src/repro/kernels/compose.py:31",
         "launches": service_launches["pairwise_compose"],
         "max_abs_err": c_err, "ms": c_main["ms"],
         "plain_ms": c_main["plain_ms"], "bound_ms": c_main["bound_ms"],
         "bound_by": c_main["bound_by"],
         "library_ms": c_main["broadcast_add_ms"],
         "device_ms": c_main["device_ms"],
         "plain_device_ms": c_main["plain_device_ms"]},
        {"name": "mlp_forward", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mogd_mlp.cu",
         "replaces": "src/repro/kernels/mogd_mlp.py:33",
         "launches": ms_launches["mlp_forward"],
         "max_abs_err": m_chk["max_abs_err"], "ms": m_gate["ms"],
         "plain_ms": m_gate["plain_ms"], "bound_ms": m_gate["bound_ms"],
         "bound_by": m_gate["bound_by"], "library_ms": None,
         "device_ms": m_gate["device_ms"],
         "plain_device_ms": m_gate["plain_device_ms"]},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_wkv.py:27",
         "launches": lm["launches"]["rwkv6-3b"]["rwkv6_wkv"],
         "max_abs_err": lm["check"]["wkv_err"],
         **{k: lm["timing"]["wkv_prefill"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms", "layout")},
         **_decode_row(lm["timing"]["wkv_decode"])},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": lm["launches"]["qwen3-4b"]["flash_attention"],
         "max_abs_err": max(lm["check"]["flash_err"].values()),
         **{k: lm["timing"]["flash"]["bfloat16_512"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms")},
         "kernel_route": "wgmma"},
        {"name": "mamba_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:26",
         "launches": lm["launches"]["jamba-v0.1-52b"]["mamba_scan"],
         "max_abs_err": lm["check"]["scan_err"],
         **{k: lm["timing"]["scan_prefill"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms", "bound_terms_ms")},
         **_decode_row(lm["timing"]["scan_decode"])},
    ]
    summary = {"single_task": {k: v for k, v in single.items()
                               if k != "stats"},
               "tenants": {k: v for k, v in tenants.items() if k != "stats"},
               "service": {k: v for k, v in service.items()
                           if k not in ("stats", "executor")},
               "service_stats": service["stats"],
               "modelserver": {k: v for k, v in ms.items()
                               if k not in ("stats", "executor")},
               "modelserver_stats": ms["stats"],
               "frontdesk": desk, "vault": vault,
               "launches": {"single_task": launches,
                            "tenants": tenant_launches,
                            "service": service_launches,
                            "frontdesk": fd_launches,
                            "modelserver": ms_launches},
               "routes": routes,
               "pareto": p_times, "store_add_ms": store_add,
               "descend": d,
               "compose_path": c_main, "compose_4096": c_big,
               "mlp_check": m_chk, "mlp_gate": m_gate, "mlp_4096": m_big,
               "lm": lm, "phase_s": phase_s}
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
    print(json.dumps({"frontdesk_latency_s": {
        n: {k: c[k] for k in ("admit_s", "queue_wait_s", "dispatch_s",
                              "e2e_s")}
        for n, c in desk["by_class"].items()}}), flush=True)
    print(json.dumps({"frontdesk_wave_latency_s": {
        n: {k: c[k] for k in ("admit_s", "queue_wait_s", "dispatch_s",
                              "e2e_s")}
        for n, c in desk["wave_by_class"].items()}}), flush=True)
    print(json.dumps({"frontdesk_shed": {
        part: {n: {"done": c["done"], "shed": c["shed"]}
               for n, c in desk[part].items()}
        for part in ("by_class", "wave_by_class")}}), flush=True)
    print(json.dumps({"frontdesk_recommend_s": desk["recommend_s"]}),
          flush=True)
    print(json.dumps({"frontdesk_launches": fd_launches}), flush=True)
    print(json.dumps({"frontdesk": {
        k: desk[k] for k in ("tickets", "wall_s", "dispatches",
                             "dispatch_walls_s", "persist_s",
                             "vault_snapshots")}}), flush=True)
    print(json.dumps({"vault": {
        k: vault[k] for k in ("sessions", "restores", "restore_all_s",
                              "restore_per_session_s",
                              "executor_dispatches", "launches")}
        | {"registry": {k: vault["registry"][k]
                        for k in ("workloads", "rehydrate_s", "fits")}}}),
        flush=True)
    print(json.dumps({"modelserver": {
        "fit_s": {n: w["fit_s"] for n, w in ms["workloads"].items()},
        "gate_s": {n: w["gate_s"] for n, w in ms["workloads"].items()},
        "gate_error": {n: w["gate_error"]
                       for n, w in ms["workloads"].items()},
        "drift_to_fresh_frontier_s":
            ms["drift"]["drift_to_fresh_frontier_s"],
        "recommend_ms": ms["recommend_ms"],
        "gp_dispatch_s": ms["gp_dispatch_s"],
        "mlp_forward_launches": ms_launches["mlp_forward"],
        "mlp_forward_ms": {"gate_rows": m_gate["ms"], "4096": m_big["ms"]}}}),
        flush=True)
    print(json.dumps({"lm_serving": {
        arch: {**{k: m[k] for k in ("layers", "param_dtype", "tokens",
                                    "tokens_per_s", "decode_ms_median",
                                    "decode_ms_p90", "decode_bound_ms",
                                    "decode_ops_bound_ms", "prefill_ms",
                                    "peak_mem_gb", "fp32_check_err")},
               "idle_share": {k: v["idle_share"]
                              for k, v in m["profile"].items()}}
        for arch, m in lm["models"].items()}}), flush=True)
    print(json.dumps({"decode_host_us": lm["timing"]["decode_host_us"]}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def timing_main(name: str) -> int:
    """``--timing NAME``: the card line, the build, then only the dominance
    and compose kernels' timings (``PARETO_SHAPES``; the ETL job's 27 x 25 x
    2 and 4096 x 4096 x 2 beside the broadcast add) and the frontier store's
    add, as ``main`` makes them; written as ``NAME.json`` beside
    ``chip_smoke.json``.  It needs only the
    wrappers' public functions, so this script run from a copy of an
    earlier tree times that tree's kernels the same way."""
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = phase_card()
    dev = torch.device("cuda", 0)
    res = {"card": card}
    res["pareto"] = {f"{N}x{M}": pareto_timing(
        dev, N, M, 2, reps=20 if N * M > 1 << 20 else 200)
        for N, M in PARETO_SHAPES}
    res["compose"] = {"27x25": compose_timing(dev, 27, 25, 2),
                      "4096x4096": compose_timing(dev, 4096, 4096, 2,
                                                  reps=20)}
    res["store_add_ms"] = store_add_timing(dev)
    for timing in res["pareto"].values():
        timing.update(pareto_device_ms(dev, *timing["shape"]))
    for timing in res["compose"].values():
        timing.update(compose_device_ms(dev, *timing["shape"]))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({name: {
        "pareto": {s: [t["ms"], t["device_ms"]]
                   for s, t in res["pareto"].items()},
        "compose": {s: [t["ms"], t["device_ms"], t["broadcast_add_ms"],
                        t["broadcast_add_device_ms"]]
                    for s, t in res["compose"].items()},
        "store_add_ms": res["store_add_ms"]}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--timing"]:
        sys.exit(timing_main(sys.argv[2] if len(sys.argv) > 2 else "timing"))
    sys.exit(main())
