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
   Then the graph check (``GRAPH_CASES``): the probe executor's programs
   are CUDA graphs on the card, a bucket's first dispatch run eagerly
   (the warm-up) and captured, every later one replayed.  One dispatch of
   ZDT1 (the scan route), of 64 tenants' paper-shape Spark structures
   (the fused route) and of qwen3-4b's plan (a ``PlanModel`` closure)
   must give its replay's result bit for bit, and the eager program the
   replay's on one set of inputs; each is timed eager against replayed
   (back to back, and device time from the profiler after phase 6), with
   the capture seconds and the graph's pool MB.
3. Main path, one task: PF-AP over the 12 Spark knobs with two random
   paper-shape MLP surrogates, through the fused descend kernel and the
   kernel path of the frontier store, then the task's recommendation; then
   (after phase 6, profiled) the same task again on each descend route,
   each on a fresh executor, for its time to a frontier and its descend
   launches' device time.
4. Main path, coalesced tenants: one task per workload of ``batch_suite()``
   (258 tenants), ten rounds of ``coalesce_step`` over ``solve_grouped``.
5. The service: one ``MOOService`` holding the 258 tenants, the 5-stage ETL
   job of ``examples/multistage_job.py`` and an 8-stage random
   series-parallel job (``benchmarks/expt5_multistage.py``'s
   ``make_job(8, seed=8)``) as DAG sessions; coalesced ``step_all`` rounds,
   ``recommend`` for every tenant, ``recommend_dag`` for both jobs through
   the pairwise-compose kernel, then ``solve_dag`` on the 8-stage job at
   expt5's full size.
5d. The paper's comparison (``benchmarks/expt1_batch2d.py``'s settings:
   MOGD 100 steps x 8 starts, PF-AP 24 probes through the kernel path of
   the frontier store, WS and NC 10 probes, NSGA-II 40 x 8 generations) on
   the Spark task of phase 3, once untimed and once timed, then on the
   same task with a cost cap at the median of PF-AP's costs, and on the
   first ``batch_suite()`` workload as a closure task: per method the
   frontier size, its HV against expt1's point, wall and first-frontier
   seconds and its launches by kernel and route.  Every frontier must be
   non-dominated, no capped method may return a point above the cap, NC
   and PF-AP must launch the descend kernel, PF-AP the dominance kernel,
   and no plain version may run on the card.  WS is timed on both of its
   routes (its descent step replayed as a CUDA graph, and the eager loop)
   from the same bounds, and both must give the same frontier bit for
   bit.  Then ZDT1: PF-AP (60
   probes) must cover at least WS's frontier (10 probes), as
   ``tests/test_progressive_frontier.py`` asserts.
5e. The execution planner: ``plan_job`` (24 probes) at train_4k for
   qwen3-4b, qwen2-moe-a2.7b and rwkv6-3b (all ten configurations took
   92 s) and for qwen3-4b and jamba-v0.1-52b at decode_32k, then a cost-capped plan (the cap at the
   median cost of qwen3-4b's free one), ``replan_elastic`` to 200 chips, an incremental plan from
   the free one's state, ``plan_dag`` on expt5's 8-stage job through the
   dominance and compose kernels (its composed frontier equal to the
   host's composition) and the registry's ``ingest_dryrun`` of two
   artifacts written to a temporary directory.  Every recommendation must
   decode to a valid plan, the capped frontier must honor its cap and the
   elastic plan fit in 200 chips.
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
   The engine serves on its graph route: every decode must be a replay of
   its slot's CUDA graph (one warm-up and capture a slot), every prefill
   eager; three more decode steps of slot 0 must each equal the same step
   run eagerly on a copy of the slot's cache, bit for bit (logits and
   every cache leaf), and a second engine whose decode steps run eagerly
   must give the first 4 requests' tokens again (the eager decode times
   of the same run).  The graphs' capture seconds, nodes and pool bytes,
   and the profile of a decode on both routes and of a 512-token prefill
   (idle share, kernels, the port's kernels' device ms a launch) are
   kept.
7b. LM training: ``qwen3-4b``, ``rwkv6-3b`` and ``jamba-v0.1-52b`` at full
   width (depth cut by ``TRAIN_CUTS`` to fit one card with Adam; Jamba
   without its experts), weights from seed 0, bf16 compute with fp32
   parameters and Adam moments: ``TRAIN_STEPS`` calls of a
   ``GraphTrainStep`` (the step as a CUDA graph: the first call eager,
   the second captures, every call after it a replay) on one MarkovCorpus
   batch of B x S tokens drawn through the ``TokenLoader``, each model
   freed before the next.  The
   first step's loss and gradient norm must agree with the same step's
   with the kernels forced to their plain versions (``TRAIN_PLAIN_TOL``);
   every loss must be finite and the last below the first; counted over
   the steps alone, each kernel launches once per mixer layer and step, its plain version
   never runs forward on the card and recomputes once per mixer layer and
   step in the backward (``PLAIN_BACKWARD_ON_CUDA``: the recompute is the
   backward by design), and every flash launch takes the tensor-core
   route; one step ran eagerly and every other replayed.  Step ms (median
   of steps 3-6, all replays), tokens/s, peak memory, the capture's
   seconds, nodes and pool bytes, the eager first step's forward /
   backward / Adam split (CUDA events from the step's ``_mark``
   instrumentation hook) and one more replay profiled (device ms, idle
   share).  Then, at full width and depth 2 (``REPLAY_CUTS``: both states
   fit), two replays each held to an eager ``make_train_step`` step from
   the same state, bit for bit on every leaf and metric, or within
   ``CHAOS_FACTOR`` of two eager steps' difference (the control) on the
   leaves where the control differs.  Then ``launch.train.main`` at each mixer kind's
   smoke config: ``DRIVER_STEPS[0]`` steps with checkpoints, an
   ``ElasticController`` handling a node loss (the planner's
   ``replan_elastic`` at train_4k from 256 chips, the step rebuilt, the
   checkpoint restored onto the card and held to the saved state bit for
   bit), then a second ``main`` that resumes to ``DRIVER_STEPS[1]``: the
   resumed run's losses finite and as many as its steps, the mean of the
   last 10 losses ``DRIVER_MARGIN`` below the first 10's, the launches as
   above in both runs, and each run's first step eager and every other
   replayed (the driver's graph route).
7c. Distribution: the tenants' structure through probe meshes of the
   one card, ``compressed_psum`` on a one-rank NCCL group, and on a
   (1, 1) ``DeviceMesh`` of that group with the sharding rules: qwen3-4b
   (``DIST_LAYERS`` layers, full width) and the sharded MoE,
   qwen2-moe-a2.7b (``DIST_LAYERS`` layers, full width) on both routes
   (``DIST_MOE_ROUTES``: EP, and TP inside the experts) and Jamba
   (``DIST_JAMBA_LAYERS`` layers, full width, bf16 parameters) on EP.
   Each train step, prefill and decode is held to the same call without
   the rules (``DIST_LM_TOL``), each kernel launched once a mixer layer
   and call and no plain version on the card; the collectives of each
   sharded call by kind and bytes, the step and call ms with and without
   the mesh and the peak memory are reported.  On the same mesh: the
   qwen3-4b state (parameters and Adam moments after one step, full
   width) saved through ``CheckpointManager`` under the group and
   restored with its shardings into fresh DTensors, held to the saved
   state bit for bit with the same placements, one more step from each
   held to the other at ``DIST_LM_TOL`` (save and restore seconds and GB
   written reported); ``launch.train.main`` under the group at the
   qwen3-4b smoke config with ``--ckpt`` to ``MESH_DRIVER_STEPS[0]``, its
   checkpoint restored bit for bit, and a second ``main`` resuming to
   ``MESH_DRIVER_STEPS[1]``; ``ServeEngine(rules=)`` against the plain
   engine on ``ENGINE_REQUESTS`` requests over ``ENGINE_SLOTS`` slots
   (qwen3-4b and Jamba on EP): equal tokens, each kernel once a mixer
   layer and call, no plain version on the card.
7d. The port's twins of the reference's twelve examples and of
   ``scripts/smoke_archs.py`` and ``scripts/smoke_core.py`` (``TWINS``),
   each run once on the card in its own process as a user runs it: each
   must exit 0 and end with its launch counts, which must show no plain
   version on the card and the kernels of ``TWIN_KERNELS`` launched
   (``torch_smoke_archs.py``: flash, WKV and scan over all ten
   architectures; the surrogate-MLP examples: ``mlp_forward`` and
   ``descend_batch``).  Each twin runs under ``--twin-child``, which runs
   it as ``__main__`` and ends its stderr with its replay check.  Each
   twin's seconds, launch counts and ``exec:*`` counts are reported, and
   its output kept under ``chiprun_out/twins/``.
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
``python3 chip_smoke.py --twins NAME`` runs only phase 1 and phase 7d (the
twins, with their checks), into ``NAME.json``; ``--graphs NAME`` only
phase 1 and the graph check, with its cases' device times; ``--serve
NAME`` only phase 1 and phase 7 (LM serving, with its checks); ``--train
NAME`` only phase 1 and phase 7b (LM training, with its checks).

Every MOO phase (3-5e, 5b, 5c, 6, 7d) also fails unless every executor
dispatch and every surrogate fit on the card was answered by graph
replays: since the phase's reset of the launch counts,
``ROUTES["exec:graph"]`` must equal the dispatches and
``ROUTES["exec:eager"]`` (the warm-ups) the programs built, and
``fit:eager`` and ``fit:graph`` must each equal the fits made
(``replay_check``); the counts print beside the phase's launches.

Standard output ends with the service, comparison, planner, front-desk
(latency by class,
shed counts, ``recommend`` while dispatching, launches, the plane), vault,
model-server and LM-serving summary lines, the decode calls' host pieces,
the LM training line (with the card's name and power limit), the
distribution line, the checkpoint line (7c's save and restore seconds and
GB written, with the card's name and power limit; the sharded driver; the
engines with rules), the graphs line (the graph check's cases and every
phase's ``exec:*`` counts, with the card's name and power limit), the
twins line (7d, with every phase's seconds),
the kernels' JSON record (seven kernels; WKV and the scan with their
decode call's times beside the prefill's, their device ms a launch inside
the replayed decode graph and the eager prefill, the scan's bound
counting its exps on the SFUs) and the device JSON line.  Without a CUDA device, or outside the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import weakref
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
# dealt round-robin, and the recommend calls a second thread makes; one
# executor dispatch of the plane is held (at most FD_HOLD_S) while that
# thread makes FD_RECOMMENDS calls, which must all answer
FD_CLASSES = ("interactive", "standard", "batch")
FD_PROBES = 16
FD_RECOMMENDS = 200
FD_RECOMMEND_PAUSE_S = 1e-3
FD_HOLD_S = 120.0
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
# the LM training phase: one model of each mixer kind at full width, bf16
# compute, fp32 parameters and Adam moments, B x S MarkovCorpus tokens a
# step.  Depth is cut to fit one card with Adam (16 bytes a parameter plus
# the bf16 cast copy and its gradient): qwen3-4b and rwkv6-3b at 8 layers,
# Jamba at one period of its plan with the dense FFN in the MoE layers'
# place (one MoE layer alone is 2.82 B parameters; the MoE has no kernel)
TRAIN_CUTS = {"qwen3-4b": {"n_layers": 8}, "rwkv6-3b": {"n_layers": 8},
              "jamba-v0.1-52b": {"n_layers": 8, "moe": None}}
# The steps train on one batch, drawn once through the TokenLoader: on
# fresh batches 6 steps of 2,048 tokens leave the loss flat against the
# batch-to-batch spread (on an H100: 12.433 -> 12.399 qwen3-4b,
# 11.563 -> 11.606 rwkv6-3b, 11.575 -> 11.546 Jamba), while one batch
# repeated shows that each step learns (12.43 -> 5.25, 11.56 -> 0.03,
# 11.57 -> 0.19); the driver below trains on fresh batches
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 512, 6, 3e-4
TRAIN_TIMED = slice(2, 6)  # steps 3-6 (replays): the median step
# the replays held to eager steps at full width, depth cut so that the
# graph's state, a copy and the eager step's new state fit at once:
# 2 layers, Jamba's one Mamba and one attention layer (a plan of 2)
REPLAY_CUTS = {"qwen3-4b": {"n_layers": 2}, "rwkv6-3b": {"n_layers": 2},
               "jamba-v0.1-52b": {"n_layers": 2, "moe": None,
                                  "hybrid": {"period": 2, "attn_index": 1}}}
REPLAY_STEPS = 2
# the first step's loss and gradient norm against the same step with the
# kernels forced to their plain versions, relative: bf16 compute (flash's
# bf16 tolerance above, tests/test_archs.py's 2e-2)
TRAIN_PLAIN_TOL = 2e-2
# the driver at the smoke config of each of those archs: 100 steps with a
# checkpoint every 50, a node loss handled by the elastic controller, then
# a resume to step 200; the mean of the last 10 losses must sit this far
# below the first 10's (on a CPU the same runs descend by 2.84, 2.62 and
# 2.80 nats: qwen3-4b, rwkv6-3b, Jamba).  512 tokens a step as 16 x 32:
# the recompute backward's eager loop runs over the sequence, and at 8 x
# 64 Jamba's 200 steps took 104 s of the phase's 214 on an H100 host
DRIVER_ARGS = ("--smoke", "--batch", "16", "--seq", "32", "--ckpt-every",
               "50", "--log-every", "50")
DRIVER_STEPS = (100, 200)
# the kernels' shapes on the driver's path (16 x 32 tokens at the smoke
# configs: qwen3-4b's and Jamba's 4/2 heads of 16, rwkv6-3b's 4 WKV heads
# of 16, Jamba's Mamba d_inner 128 with 4 states), held to their plain
# versions in phase 7
TRAIN_SMOKE_SHAPES = {
    "flash_attention": {"B": 16, "S": 32, "H": 4, "Hk": 2, "dh": 16},
    "rwkv6_wkv": {"B": 16, "T": 32, "H": 4, "dh": 16},
    "mamba_scan": {"B": 16, "T": 32, "d": 128, "n": 4}}
DRIVER_MARGIN = 1.5
ELASTIC_CHIPS = 256
# the distribution phase: the tenants' paper-shape structure dispatched
# through probe meshes (DIST_BOXES boxes a tenant coalesced on the group
# axis, DIST_ROW_BOXES boxes of one tenant on the row axis) held to the
# unsharded dispatch at DIST_PROBE_TOL (the reference's TestMeshPath), and
# qwen3-4b at full width, DIST_LAYERS layers, on a (1, 1) DeviceMesh with
# the sharding rules held to the same calls without them at DIST_LM_TOL
DIST_BOXES, DIST_ROW_BOXES = 2, 64
DIST_PROBE_TOL = 1e-5
DIST_LAYERS = 2
DIST_LM_TOL = 1e-4
# and the sharded MoE on the same mesh: qwen2-moe-a2.7b at full width,
# DIST_LAYERS layers, on both routes of nn.moe (EP under the default rules;
# TP inside the experts under the override that launch.plans.rules_for sets
# where the experts do not divide the model axis), and Jamba at full width,
# the first DIST_JAMBA_LAYERS layers of its period (Mamba; the MoE at 1 and
# 3; attention at 3) with bf16 parameters, on EP
DIST_MOE_ROUTES = {"ep": {}, "tp": {"expert": (), "expert_ff": ("model",)}}
DIST_JAMBA_LAYERS = 4
# qwen2-moe's steps keep their Adam moments in bf16 (the plans'
# state_dtype): with fp32 moments a step of its 1.76 B fp32 parameters
# holds ~60 GB and ran out of the card's memory
DIST_MOE_STATE = "bfloat16"
# what the distribution summary line keeps of each sharded model's run
DIST_SUMMARY = ("train_rel_err", "step_ms", "mesh_overhead",
                "train_collectives", "rel_err", "ms", "collectives",
                "peak_gb")
# the sharded driver on the (1, 1) mesh: a checkpoint every 5 steps, a
# run to step 10, a resume to step 15
MESH_DRIVER_ARGS = ("--arch", "qwen3-4b", "--smoke", "--batch", "16",
                    "--seq", "32", "--ckpt-every", "5", "--log-every", "100")
MESH_DRIVER_STEPS = (10, 15)
# ServeEngine(rules=) against the plain engine on the (1, 1) mesh
ENGINE_SLOTS, ENGINE_NEW = 2, 8
ENGINE_PROMPTS = (16, 48, 32, 64)  # one request each
# phase 7d: the twins of the reference's examples and scripts, each run
# once on the card in its own process, TWIN_PARALLEL processes at a time
TWINS = ("scripts/torch_smoke_archs.py", "examples/torch_serve_batched.py",
         "examples/torch_train_e2e.py", "scripts/torch_smoke_core.py",
         "examples/torch_quickstart.py", "examples/torch_moo_service.py",
         "examples/torch_multistage_job.py",
         "examples/torch_tune_spark_analytics.py",
         "examples/torch_plan_tpu_job.py",
         "examples/torch_adaptive_tuning.py",
         "examples/torch_budget_tuning.py", "examples/torch_warm_restart.py",
         "examples/torch_trace_serving.py", "examples/torch_serve_moo.py")
# the kernels each twin's path must launch (the others run closures on the
# scan path, a host store or the plain compose tier, and launch none)
TWIN_KERNELS = {
    "scripts/torch_smoke_archs.py": ("flash_attention", "rwkv6_wkv",
                                     "mamba_scan"),
    "examples/torch_tune_spark_analytics.py": ("mlp_forward",),
    "examples/torch_adaptive_tuning.py": ("mlp_forward", "descend_batch"),
    "examples/torch_budget_tuning.py": ("descend_batch",),
    "examples/torch_warm_restart.py": ("mlp_forward", "descend_batch"),
    "examples/torch_trace_serving.py": ("descend_batch",),
}
TWIN_TIMEOUT_S = 300
TWIN_PARALLEL = 4
# the graph check (phase 2): one dispatch a case, the eager program
# against its replays bit for bit, both timed back to back (reps eager,
# reps replayed): ZDT1 at phase 5d's settings (the scan route), 64
# tenants' paper-shape Spark structures at phase 2's descend shape (the
# fused route), qwen3-4b's plan at train_4k as plan_job dispatches it (a
# PlanModel closure on the scan route)
GRAPH_CASES = {"zdt1": (2, 30), "spark": (10, 30), "plan_model": (1, 20)}
GRAPH_BOXES = 4  # boxes a dispatch (PF-AP's batch of rectangles)
# batched evaluation in the graph check: rows a call (an NSGA-II
# population, a bounds estimate, a large frontier re-seed), reps a route
GRAPH_EVAL_ROWS = (100, 1000, 4096)
GRAPH_EVAL_REPS = 50
GRAPH_EVAL_TOL = 1e-6  # sliced padded rows against the unpadded call


# every probe executor made on the card in this process (its dispatch
# counter, its builds by structure key, a weak reference to it) and their
# totals at the last platform.reset_launches(): see track_executors
_EXECUTORS: list = []
_FITS = [0]  # surrogate fits made on the card in this process
_UNTRACKED: dict = {}  # the functions track_executors wrapped, by name
_AT_RESET = {"dispatches": 0, "builds": 0, "fits": 0}
_CAPTURE_AT_RESET: dict = {}  # graphs.CAPTURE_S at the last reset


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


def track_executors() -> None:
    """Keep every ``ProbeExecutor`` made on the card from now on, count the
    surrogate fits made there, and keep the totals at each
    ``platform.reset_launches()``, so that :func:`replay_check` can hold
    the ``exec:*`` and ``fit:*`` routes counted since the last reset to
    the dispatches, program builds and fits made since then."""
    from repro_torch.exec import executor
    from repro_torch.kernels import graphs, platform
    from repro_torch.models import train

    init, reset = executor.ProbeExecutor.__init__, platform.reset_launches
    fit = _UNTRACKED["fit"] = train._fit

    def tracked_fit(*args, **kwargs):
        dev = args[6] if len(args) > 6 else kwargs["dev"]
        if dev.type == "cuda":
            _FITS[0] += 1
        return fit(*args, **kwargs)

    def tracked_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if self.device.type == "cuda":
            _EXECUTORS.append((self._c_dispatches, self.compile_counts,
                               weakref.ref(self)))

    def tracked_reset():
        reset()
        _AT_RESET.update(_exec_totals())
        _CAPTURE_AT_RESET.clear()
        _CAPTURE_AT_RESET.update(graphs.CAPTURE_S)

    executor.ProbeExecutor.__init__ = tracked_init
    platform.reset_launches = tracked_reset
    train._fit = tracked_fit


def drop_graphs() -> None:
    """Drop the programs cached by every executor of the MOO phases (the
    default executors keep theirs for the life of the process), and with
    them their CUDA graphs and private memory pools, before the LM phases
    need the card's memory; then hand the memory back to the card."""
    for _, _, ref in _EXECUTORS:
        ex = ref()
        if ex is not None:
            with ex._lock:
                ex._programs.clear()
                ex._built_buckets.clear()
                ex._evals.clear()
    _free()


def _exec_totals() -> dict:
    return {"dispatches": sum(int(c.value) for c, _, _ in _EXECUTORS),
            "builds": sum(sum(b.values()) for _, b, _ in _EXECUTORS),
            "fits": _FITS[0]}


def replay_check(label: str) -> dict:
    """Since the last reset of the launch counts: every dispatch on the
    card was answered by replays (``exec:graph`` equals the dispatches),
    the warm-ups are the builds (``exec:eager``: one a bucket, before its
    captures), and every surrogate fit warmed up once and ran by replays
    (``fit:eager`` and ``fit:graph`` each equal the fits).  Holds for
    executors without a multi-shard mesh (a shard is a program run of its
    own).  Returns the counts, printed beside the launches: the batched
    evaluations' too (``eval:first``, a bucket's first call, eager;
    ``eval:eager``, a warm-up before a bucket's capture at its second
    call; ``eval:graph``, a replay), and the seconds of the captures by
    route (``capture_s``)."""
    from repro_torch.kernels import graphs, platform

    routes = platform.route_counts()
    now = _exec_totals()
    got = {key: routes.get(key, 0)
           for key in ("exec:eager", "exec:graph", "fit:eager", "fit:graph",
                       "eval:first", "eval:eager", "eval:graph")}
    got.update({key: now[key] - _AT_RESET[key]
                for key in ("dispatches", "builds", "fits")})
    got["capture_s"] = {
        route: s - _CAPTURE_AT_RESET.get(route, 0.0)
        for route, s in sorted(graphs.CAPTURE_S.items())
        if s > _CAPTURE_AT_RESET.get(route, 0.0)}
    if (got["exec:eager"] != got["builds"]
            or got["exec:graph"] != got["dispatches"]
            or got["fit:eager"] != got["fits"]
            or got["fit:graph"] != got["fits"]):
        fail(f"{label}: dispatches and fits on the card not answered by "
             f"replays after one warm-up a build: {got}")
    return got


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


def graph_cases(dev) -> dict:
    """The graph check's cases (``GRAPH_CASES``): label -> (a fresh
    executor on the card, the requests of one dispatch)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import MOGDConfig, MOGDSolver, as_problem
    from repro_torch.core import make_zdt1
    from repro_torch.data.workloads import batch_suite
    from repro_torch.exec import ProbeExecutor
    from repro_torch.nn import SHAPES
    from repro_torch.planner.planner import plan_task

    def request(solver, seed):
        rng = np.random.default_rng(seed)
        k, B = solver.problem.k, GRAPH_BOXES
        x0s = rng.random((B, solver.config.multistart,
                          solver.problem.dim)).astype(np.float32)
        lo = rng.uniform(0.0, 1.0, (B, k))
        return solver._request(x0s, lo, lo + rng.uniform(1.0, 50.0, (B, k)),
                               seed % k)

    cases = {}
    ex = ProbeExecutor(device=dev, mesh=None)
    solver = MOGDSolver(make_zdt1(device=dev),
                        MOGDConfig(steps=120, multistart=8), executor=ex,
                        device=dev)
    cases["zdt1"] = (ex, [request(solver, 0)])
    ex = ProbeExecutor(device=dev, mesh=None)
    reqs = []
    for i, w in enumerate(batch_suite()[:64]):
        solver = MOGDSolver(as_problem(spark_task(1 + i, dev, w)),
                            MOGDConfig(), executor=ex, device=dev)
        reqs.append(request(solver, i))
    cases["spark"] = (ex, reqs)
    ex = ProbeExecutor(device=dev, mesh=None)
    spec, _ = plan_task(get_config("qwen3-4b"), SHAPES["train_4k"],
                        device=dev)
    solver = MOGDSolver(as_problem(spec), MOGDConfig(steps=80, multistart=8),
                        executor=ex, device=dev)
    cases["plan_model"] = (ex, [request(solver, 0)])
    return cases


def _ms_per_call(fn, reps: int) -> float:
    """Mean host milliseconds of ``fn()`` (which reads its result back to
    the host) over ``reps`` back-to-back calls (``fn`` has run before)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_graphs(dev, cases) -> dict:
    """Phase 2's graph check: per case, the first dispatch (the parity gate
    on the fused route, the warm-up, the captures, the replays that answer
    it) and a second dispatch of the same requests must agree bit for
    bit, and so must the eager program and the replays on one set of
    inputs; then the eager program and the replays (copy-in, replays,
    read-back) are timed back to back on those inputs, and the whole
    dispatch (``solve_requests``) replayed.  Reports the first dispatch's
    seconds, each graph's capture and instantiation seconds and nodes, the
    steps a replay covers, and the graphs' private pool MB.  Then the
    surrogate fit and the batched evaluations (:func:`fit_graph_check`,
    :func:`eval_graph_check`)."""
    import torch

    from repro_torch.exec import tree_map
    from repro_torch.kernels import platform

    out = {}
    for label, (ex, reqs) in cases.items():
        reps_eager, reps_replay = GRAPH_CASES[label]
        platform.reset_launches()
        t0 = time.perf_counter()
        first = ex.solve_requests(reqs)
        first_s = time.perf_counter() - t0
        second = ex.solve_requests(reqs)
        counts = replay_check(f"graph check {label}")
        (prog,) = ex._programs.values()
        (graph,) = prog.graphs.values()
        params, rows = tree_map(torch.clone, graph.inputs)

        def eager():
            return tuple(o.cpu() for o in prog.fn(params, *rows))

        def replay():
            return graph(params, rows)

        pairs = [(torch.as_tensor(a), torch.as_tensor(b))
                 for a, b in zip(first, second)]
        pairs += list(zip(eager(), replay()))
        for got, want in pairs:
            if not (torch.equal(got, want) if got.dtype == torch.bool
                    else _same_bits(got, want)):
                fail(f"graph check {label}: a replay differs from the "
                     f"eager program")
        out[label] = {
            "bucket": list(ex.last_bucket), "fused": ex.fused_dispatches > 0,
            "first_dispatch_s": first_s, "capture_s": graph.capture_s,
            "instantiate_s": graph.instantiate_s,
            "graphs": {name: {"capture_s": p.capture_s,
                              "instantiate_s": p.instantiate_s,
                              "nodes": p.nodes}
                       for name, p in graph.pieces.items()},
            "steps_a_replay": graph.steps_a_replay,
            "pool_mb": graph.pool_bytes / 2**20,
            "eager_ms": _ms_per_call(eager, reps_eager),
            "replay_ms": _ms_per_call(replay, reps_replay),
            "dispatch_replay_ms": _ms_per_call(
                lambda: ex.solve_requests(reqs), reps_replay),
            "launches": platform.launch_counts(), "exec": counts}
        log(f"graph check {label}: {out[label]}")
    if not out["spark"]["fused"] or out["zdt1"]["fused"]:
        fail(f"graph check: routes {({k: v['fused'] for k, v in out.items()})}")
    out["fit"] = fit_graph_check(dev)
    out["eval"] = eval_graph_check(dev)
    return out


def fit_graph_check(dev) -> dict:
    """The model server's surrogate fit at the paper's shape (phase 6's
    traces of its first workload, the registry's trainer settings: hidden
    (128,)*4, dropout 0.05, 60 epochs, log target), run eagerly and then
    through its graphs: the parameters, the best validation loss and the
    epochs must agree bit for bit, and so must the launch counts."""
    import numpy as np
    import torch

    from repro_torch.data.workloads import (
        batch_problem,
        batch_suite,
        generate_traces,
    )
    from repro_torch.kernels import platform
    from repro_torch.models import train

    X, Y = generate_traces(batch_problem(batch_suite()[0], device=dev),
                           MS_TRACES, seed=100)
    cfg = train.TrainConfig(max_epochs=60, dropout=0.05)
    res, launches, seconds = {}, {}, {}
    # the eager fit is a reference, not a fit of the path: untracked
    for route, fit in (("eager", _UNTRACKED.get("fit", train._fit)),
                       ("graph", train._fit)):
        platform.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[route] = fit(X, Y[:, 0], PAPER_HIDDEN, cfg, True, None, dev,
                         route == "graph")
        torch.cuda.synchronize()
        seconds[route] = time.perf_counter() - t0
        launches[route] = platform.launch_counts()
    counts = replay_check("graph check fit")
    (m_e, val_e, ep_e), (m_g, val_g, ep_g) = res["eager"], res["graph"]
    same = (val_e == val_g and ep_e == ep_g and all(
        _same_bits(a["w"], b["w"]) and _same_bits(a["b"], b["b"])
        for a, b in zip(m_e.params, m_g.params)))
    if not same or launches["eager"] != launches["graph"]:
        fail(f"graph check fit: the graph fit differs from the eager fit "
             f"(best {val_e} / {val_g}, epochs {ep_e} / {ep_g}, launches "
             f"{launches})")
    n_tr = MS_TRACES - max(1, int(MS_TRACES * cfg.val_frac))
    out = {"traces": MS_TRACES, "epochs": ep_g, "best_val": val_g,
           "steps_an_epoch": -(-n_tr // cfg.batch_size),
           "eager_s": seconds["eager"], "graph_s": seconds["graph"],
           "launches": launches["graph"], "exec": counts,
           "finite": bool(np.isfinite(val_g))}
    log(f"graph check fit: {out}")
    return out


def eval_graph_check(dev) -> dict:
    """Batched evaluation through its graphs: ``eval_batch`` of the
    paper-shape Spark structure and ``evaluate_batch`` of ZDT1 at each of
    ``GRAPH_EVAL_ROWS``.  A bucket's first call runs eagerly on the padded
    rows and its second is captured and replayed: the two, and the eager
    function on the same padded rows, must agree bit for bit, and the
    first N rows must agree with the unpadded eager call within
    ``GRAPH_EVAL_TOL`` relative (reported with whether they are equal bit
    for bit).  Reports each call's seconds and the capture's, then both
    routes timed back to back."""
    import torch

    from repro_torch.core import as_problem, make_zdt1
    from repro_torch.exec import ProbeExecutor, bucket

    spark = as_problem(spark_task(1, dev)).program
    zdt1 = make_zdt1(device=dev)
    ex = ProbeExecutor(device=dev, mesh=None)
    params = ex._params_to(spark.params)
    out = {}
    for label in ("spark_eval_batch", "zdt1_evaluate_batch"):
        for N in GRAPH_EVAL_ROWS:
            gen = torch.Generator().manual_seed(N)
            if label.startswith("spark"):
                X = torch.rand((N, 13), generator=gen).to(dev)

                def call():
                    return ex.eval_batch(spark, X)

                shared = (params,)
            else:
                X = torch.rand((N, zdt1.dim), generator=gen).to(dev)

                def call():
                    return zdt1.evaluate_batch(X)

                shared = ()
            seconds = []
            for _ in range(2):  # the bucket's first call, then its capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = call()
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                if len(seconds) == 1:
                    first = got
            rows = (next(iter(ex._evals.values())) if shared
                    else zdt1._batch_rows)
            graph = rows.graphs[bucket(N)]
            Xp = graph.leaves[-1].clone()
            with torch.no_grad():
                padded = rows.fn(*shared, Xp)
                alone = rows.fn(*shared, X)
            if not (_same_bits(got, padded[:N]) and _same_bits(first, got)):
                fail(f"graph check {label} N={N}: the replay differs from "
                     f"the eager function on its padded rows")
            rel = float(torch.max(torch.abs(got - alone)
                                  / torch.clamp_min(torch.abs(alone),
                                                    1e-30)))
            if not rel <= GRAPH_EVAL_TOL:
                fail(f"graph check {label} N={N}: sliced rows {rel:.3g} "
                     f"relative from the unpadded call")
            out[f"{label}_{N}"] = {
                "rows": N, "bucket": int(Xp.shape[0]),
                "bits_equal_unpadded": _same_bits(got, alone),
                "max_rel_unpadded": rel,
                "first_call_s": seconds[0], "second_call_s": seconds[1],
                "capture_s": graph.captured.capture_s,
                "nodes": graph.captured.nodes,
                "eager_ms": _ms_per_call(
                    lambda: rows.fn(*shared, X).cpu(), GRAPH_EVAL_REPS),
                "replay_ms": _ms_per_call(lambda: call().cpu(),
                                          GRAPH_EVAL_REPS)}
    log(f"graph check eval: {out}")
    return out


def graph_device_ms(cases, graphs: dict) -> None:
    """The profiler's device time of one eager run and of one replay of
    each graph check case (the sum of their kernels' and copies' times),
    and the device operations a replay runs, into ``graphs[label]``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.exec import tree_map

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        each = [ev.time_range.end - ev.time_range.start
                for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        return sum(each) / 1e3, len(each)

    for label, (ex, _) in cases.items():
        (prog,) = ex._programs.values()
        (graph,) = prog.graphs.values()
        params, rows = tree_map(torch.clone, graph.inputs)
        graphs[label]["eager_device_ms"], _ = profiled(
            lambda: prog.fn(params, *rows))
        (graphs[label]["replay_device_ms"],
         graphs[label]["replay_kernels"]) = profiled(
            lambda: graph(params, rows))


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
    descend launches, by route: PF-AP on phase 3's task again, each route
    on a fresh executor (its programs captured on that route), as the port
    routes it (resident) and forced onto the streaming route; twice a
    route, the second run (replays of the first's graphs) profiled.  The
    descend kernels' device time comes from the profiler, so this runs
    after the host-bound phases (a profiler session may leave CUPTI set up
    for the process and slow later launches on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (
        MOGDConfig,
        MOGDSolver,
        ProgressiveFrontier,
        as_problem,
    )
    from repro_torch.exec import ProbeExecutor
    from repro_torch.kernels import platform

    out = {}
    for label, ctx in (("resident", contextlib.nullcontext()),
                       ("streaming", streaming_descend())):
        with ctx:
            problem = as_problem(spark_task(0, dev))
            solver = MOGDSolver(problem, MOGDConfig(),
                                executor=ProbeExecutor(device=dev, mesh=None),
                                device=dev)
            walls = []
            for run in range(2):  # the second run replays the first's
                platform.reset_launches()
                pf = ProgressiveFrontier(problem, mode="AP",
                                         mogd=MOGDConfig(), solver=solver,
                                         use_kernel=True, device=dev)
                with (profile(activities=[ProfilerActivity.CUDA]) if run
                      else contextlib.nullcontext()) as prof:
                    t0 = time.perf_counter()
                    pf.run(n_probes=64)
                    _sync(dev)
                    walls.append(time.perf_counter() - t0)
        routes = platform.route_counts()
        out[label] = {
            "first_run_s": walls[0], "seconds": walls[1], "routes": routes,
            "exec": replay_check(f"single task forced to {label}"),
            "descend_kernels": sum(1 for ev in prof.events()
                                   if ev.device_type == DeviceType.CUDA
                                   and "descend" in ev.name),
            "descend_device_s": sum(
                ev.time_range.end - ev.time_range.start
                for ev in prof.events()
                if ev.device_type == DeviceType.CUDA
                and "descend" in ev.name) / 1e6}
        if {r for r in routes if r.startswith("descend_batch:")} != {
                f"descend_batch:{label}"}:
            fail(f"single task forced to {label}: routes {routes}")
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
# Phases 5d-5e: the paper's comparison and the execution planner
# ---------------------------------------------------------------------------

# benchmarks/expt1_batch2d.py's settings: MOGD (steps, multistart), PF-AP's
# probes, WS's and NC's probes, NSGA-II's population and generations
CMP_MOGD = (100, 8)
CMP_PF_PROBES, CMP_GRID_PROBES = 24, 10
CMP_POP, CMP_GENS = 40, 8
# the first batch_suite() workload as a closure task: PF-AP and NC take
# 11-12 and 4-5 s a workload there (the executor's eager scan path), so
# three (65 s for the phase on the H100) were cut to one
CMP_WORKLOADS = 1


def _hv_ref(problem):
    """expt1's HV reference point: the sampled bounds' upper edge plus
    10 % of their span."""
    from repro_torch.core import estimate_objective_bounds

    b = estimate_objective_bounds(problem)
    return b[1] + 0.1 * (b[1] - b[0])


def _cap_slack(cap: float) -> float:
    """The value-bound slack every method allows (``feasible_mask``'s 1e-6
    of the bound's scale)."""
    return 1e-6 * max(abs(cap), 1.0)


def compare_methods(task, dev, label: str, capped: bool = False) -> dict:
    """PF-AP, WS, NC and NSGA-II on one task at expt1's budgets: per method
    the frontier size, HV against expt1's point, wall and first-frontier
    seconds, and the launches of its own run, by kernel and by route.
    Every frontier must be finite and mutually non-dominated, and not empty
    unless the task is ``capped`` (a method may find no point under a
    cap)."""
    import numpy as np
    import torch

    from repro_torch.core import (
        MOGDConfig,
        ProgressiveFrontier,
        as_problem,
        hypervolume_2d,
        normalized_constraints,
        nsga2,
        pareto_mask,
        weighted_sum,
    )
    from repro_torch.kernels import platform

    mogd = MOGDConfig(steps=CMP_MOGD[0], multistart=CMP_MOGD[1])
    problem = as_problem(task)
    ref = np.asarray(_hv_ref(problem))
    runs = {
        "pf_ap": lambda: ProgressiveFrontier(
            task, mode="AP", mogd=mogd, use_kernel=True,
            device=dev).run(n_probes=CMP_PF_PROBES),
        "ws": lambda: weighted_sum(task, n_probes=CMP_GRID_PROBES, mogd=mogd,
                                   device=dev),
        "nc": lambda: normalized_constraints(task, n_probes=CMP_GRID_PROBES,
                                             mogd=mogd, device=dev),
        "nsga2": lambda: nsga2(task, n_probes=CMP_PF_PROBES,
                               pop_size=CMP_POP, n_gens=CMP_GENS,
                               device=dev),
    }
    out = {}
    for name, run in runs.items():
        platform.reset_launches()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        F = np.asarray(res.F)
        if (not len(F) and not capped) or not np.all(np.isfinite(F)):
            fail(f"{label} {name}: empty or non-finite frontier")
        if not bool(pareto_mask(F).all()):
            fail(f"{label} {name}: frontier points dominate each other")
        out[name] = {"points": len(F), "hv": hypervolume_2d(F, ref),
                     "seconds": wall,
                     "first_frontier_s": (float(res.trace[0][0])
                                          if res.trace else None),
                     "probes": int(res.probes),
                     "launches": platform.launch_counts(),
                     "routes": platform.route_counts(),
                     "exec": replay_check(f"{label} {name}"),
                     "plain_on_cuda": platform.plain_on_cuda_counts(),
                     "F": F}
    log(f"{label}: " + json.dumps({n: {k: v for k, v in r.items()
                                       if k != "F"}
                                   for n, r in out.items()}))
    return out


def ws_routes(task, dev, label: str) -> dict:
    """WS at expt1's budget on both of its routes from the same bounds:
    the card's (the descent step captured and replayed ``steps`` times)
    and the eager loop (``graphs.captures`` answering False for the call),
    each run twice in turn after a warm-up of each; wall seconds of the
    timed runs.  Both routes must give the same frontier bit for bit, the
    graph route one warm-up step and ``steps`` replays a call."""
    import numpy as np
    import torch

    from repro_torch.core import (
        MOGDConfig,
        as_problem,
        estimate_objective_bounds,
        weighted_sum,
    )
    from repro_torch.kernels import graphs, platform

    mogd = MOGDConfig(steps=CMP_MOGD[0], multistart=CMP_MOGD[1])
    problem = as_problem(task)
    bounds = estimate_objective_bounds(problem)

    def run(route):
        platform.reset_launches()
        with contextlib.ExitStack() as stack:
            if route == "eager":
                stack.enter_context(forced(graphs, "captures", False))
            t0 = time.perf_counter()
            res = weighted_sum(problem, n_probes=CMP_GRID_PROBES, mogd=mogd,
                               bounds=bounds, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        routes = platform.route_counts()
        want = ({"ws:eager": 1, "ws:graph": mogd.steps} if route == "graph"
                else {})
        if {k: v for k, v in routes.items() if k.startswith("ws:")} != want:
            fail(f"{label} WS on the {route} route: routes {routes}")
        return res, wall

    out = {"graph_s": [], "eager_s": []}
    results = {}
    for route in ("graph", "eager", "graph", "eager", "graph", "eager"):
        res, wall = run(route)
        if route in results:  # the first run of each is the warm-up
            out[f"{route}_s"].append(wall)
        results[route] = res
    g, e = results["graph"], results["eager"]
    if not (np.array_equal(g.F, e.F) and np.array_equal(g.X, e.X)):
        fail(f"{label}: WS's graph route and eager loop give other "
             f"frontiers")
    out["points"] = len(g.F)
    out["capture_s"] = graphs.CAPTURE_S["ws"]
    log(f"{label} WS routes: {out}")
    return out


def phase_comparison(dev) -> dict:
    """The paper's comparison on the Spark task and on the first
    ``batch_suite()`` workloads, a cost-capped rerun of the Spark task, and
    ZDT1's coverage assertion (tests/test_progressive_frontier.py's
    ``test_pf_beats_ws_coverage_on_zdt1``)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import (
        MOGDConfig,
        Objective,
        hypervolume_2d,
        make_zdt1,
        solve_pf,
        weighted_sum,
    )
    from repro_torch.data.workloads import batch_problem, batch_suite
    from repro_torch.kernels import platform

    task = spark_task(0, dev)
    # untimed warm-up of every method (expt1's amortized regime): first
    # calls build the kernel library's plans and allocator pools
    compare_methods(task, dev, "comparison warm-up")
    spark = compare_methods(task, dev, "comparison spark")
    ws_both = ws_routes(task, dev, "comparison spark")
    for name in ("nc", "pf_ap"):
        if spark[name]["launches"].get("descend_batch", 0) <= 0:
            fail(f"comparison: {name} did not launch the descend kernel")
    if spark["pf_ap"]["launches"].get("cross_dominator_counts", 0) <= 0:
        fail("comparison: PF-AP did not launch the dominance kernel")
    cap = float(np.median(spark["pf_ap"]["F"][:, 1]))
    capped_task = dataclasses.replace(task, objectives=(
        Objective("latency_s"), Objective("cost_usd", bound=(None, cap))))
    capped = compare_methods(capped_task, dev, "comparison spark capped",
                             capped=True)
    for name, r in capped.items():
        over = r["F"][:, 1] > cap + _cap_slack(cap)
        if over.any():
            fail(f"comparison: {name} returned {int(over.sum())} points "
                 f"above the cost cap {cap}")
    workloads = {}
    for w in batch_suite()[:CMP_WORKLOADS]:
        workloads[w.name] = compare_methods(batch_problem(w, device=dev),
                                            dev, f"comparison {w.name}")
    for label, runs in (("spark", spark), ("spark capped", capped),
                        *workloads.items()):
        for name, r in runs.items():
            if r["plain_on_cuda"]:
                fail(f"comparison {label} {name}: plain versions ran on the "
                     f"card: {r['plain_on_cuda']}")
    zdt1 = make_zdt1(device=dev)
    cfg = MOGDConfig(steps=120, multistart=8)
    platform.reset_launches()
    t0 = time.perf_counter()
    pf = solve_pf(zdt1, mode="AP", n_probes=60, mogd=cfg, device=dev)
    ws = weighted_sum(zdt1, n_probes=10, mogd=cfg, device=dev)
    zdt1_s = time.perf_counter() - t0
    zref = np.array([1.5, 1.5])
    z = {"pf_points": len(pf.F), "ws_points": len(ws.F),
         "pf_hv": hypervolume_2d(pf.F, zref),
         "ws_hv": hypervolume_2d(ws.F, zref), "seconds": zdt1_s,
         "exec": replay_check("comparison zdt1")}
    log(f"comparison zdt1: {z}")
    if not (z["pf_points"] >= z["ws_points"]
            and z["pf_hv"] >= z["ws_hv"] - 0.05):
        fail(f"zdt1: PF-AP does not cover at least WS's frontier: {z}")

    def strip(runs):
        return {n: {k: v for k, v in r.items() if k != "F"}
                for n, r in runs.items()}

    return {"spark": strip(spark), "spark_capped": strip(capped),
            "cost_cap": cap, "ws_routes": ws_both,
            "workloads": {n: strip(r) for n, r in workloads.items()},
            "zdt1": z}


# plan_job takes 6.8-10 s a cell on the H100 (the eager scan path over
# the closure program), so the ten configurations at train_4k (139 s for
# the phase) were cut to a dense, an MoE and an RWKV one; the hybrid
# (Jamba) is planned at decode_32k
PLAN_ARCHS = ("qwen3-4b", "qwen2-moe-a2.7b", "rwkv6-3b")
PLAN_SHAPES = (("qwen3-4b", "decode_32k"), ("jamba-v0.1-52b", "decode_32k"))
PLAN_ELASTIC_CHIPS = 200


def _check_plan(rec, label: str, chips_max: int = 512) -> None:
    """A recommendation is a plan: every frontier row decodes to the knob
    space's values and the objectives are finite and positive."""
    import numpy as np

    from repro_torch.launch.plans import Plan

    plans = [(rec.plan, rec.num_chips, rec.model_parallel),
             *rec.frontier_plans]
    if not len(rec.frontier_F) or len(rec.frontier_plans) != len(
            rec.frontier_F):
        fail(f"{label}: {len(rec.frontier_F)} frontier rows, "
             f"{len(rec.frontier_plans)} plans")
    if not (np.all(np.isfinite(rec.frontier_F))
            and np.all(rec.frontier_F > 0)):
        fail(f"{label}: non-finite or non-positive objectives")
    for plan, chips, tp in plans:
        if not (isinstance(plan, Plan) and chips in (64, 128, 256, 512)
                and chips <= chips_max and tp in (1, 2, 4, 8, 16, 32)
                and plan.remat in ("none", "dots", "full")
                and plan.param_dtype in ("float32", "bfloat16")
                and plan.state_dtype in ("float32", "bfloat16")
                and plan.microbatches in (1, 2, 4, 8)
                and plan.moe_impl in ("einsum", "gather")
                and plan.attn_chunk in (512, 1024, 2048, 4096)):
            fail(f"{label}: invalid plan {plan}, chips {chips}, tp {tp}")


def _write_dryrun_artifacts(root) -> None:
    """Two dry-run artifacts of one cell, as tests/test_modelserver.py's
    ingest bridge test writes them."""
    rec = {
        "arch": "qwen3-4b", "shape": "train_4k", "mesh": "16x16",
        "plan": {"fsdp": True, "remat": "dots", "param_dtype": "float32",
                 "state_dtype": "float32", "microbatches": 1,
                 "moe_impl": "einsum", "attn_chunk": 1024,
                 "seq_shard_all": False, "pure_dp": False,
                 "grad_reduce_dtype": "float32"},
        "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                     "collective_s": 3.0},
    }
    (root / "qwen3-4b__train_4k__16x16.json").write_text(json.dumps(rec))
    rec2 = dict(rec, roofline={"compute_s": 0.5, "memory_s": 1.0,
                               "collective_s": 1.5})
    rec2["plan"] = dict(rec["plan"], remat="none")
    (root / "qwen3-4b__train_4k__16x16__opt.json").write_text(
        json.dumps(rec2))


def phase_planner(dev) -> dict:
    """``plan_job`` for three configurations at train_4k and two decode
    cells, a cost-capped plan, an elastic replan, an
    incremental plan, ``plan_dag`` through the dominance and compose
    kernels, and the registry's dry-run ingest."""
    import tempfile
    import types

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import platform
    from repro_torch.modelserver import (
        ModelRegistry,
        TrainerConfig,
        ingest_dryrun,
    )
    from repro_torch.planner import plan_dag, plan_job, replan_elastic

    def timed(fn):
        t0 = time.perf_counter()
        rec = fn()
        torch.cuda.synchronize()
        return rec, time.perf_counter() - t0

    platform.reset_launches()
    plans, recs = {}, {}
    cells = [(a, "train_4k") for a in PLAN_ARCHS] + list(PLAN_SHAPES)
    for arch, shape in cells:
        rec, s = timed(lambda: plan_job(get_config(arch), shape,
                                        n_probes=24, deadline_s=None,
                                        device=dev))
        _check_plan(rec, f"plan {arch} {shape}")
        recs[arch, shape] = rec
        plans[f"{arch}:{shape}"] = {
            "seconds": s, "points": len(rec.frontier_F),
            "num_chips": rec.num_chips, "model_parallel": rec.model_parallel,
            "objectives": rec.objectives.tolist()}
    log(f"planner plans: {plans}")
    cfg = get_config("qwen3-4b")
    free = recs["qwen3-4b", "train_4k"]
    cap = float(np.median(free.frontier_F[:, 1]))
    capped, capped_s = timed(lambda: plan_job(
        cfg, "train_4k", n_probes=24, deadline_s=None,
        objective_bounds={"cost": (None, cap)}, device=dev))
    _check_plan(capped, "capped plan")
    if np.any(capped.frontier_F[:, 1] > cap + _cap_slack(cap)):
        fail(f"capped plan: a frontier cost above the cap {cap}")
    elastic, elastic_s = timed(lambda: replan_elastic(
        cfg, "train_4k", surviving_chips=PLAN_ELASTIC_CHIPS,
        deadline_s=None, device=dev))
    _check_plan(elastic, "elastic plan", chips_max=PLAN_ELASTIC_CHIPS)
    # a short plan whose queue still holds rectangles, resumed for 16 more
    # probes
    first = plan_job(cfg, "train_4k", n_probes=8, deadline_s=None,
                     device=dev)
    before, left = first.pf_state.probes, len(first.pf_state.queue)
    more, more_s = timed(lambda: plan_job(cfg, "train_4k", n_probes=16,
                                          deadline_s=None,
                                          state=first.pf_state, device=dev))
    _check_plan(more, "incremental plan")
    if left and more.pf_state.probes <= before:
        fail("incremental plan: no probe added to the resumed state")
    if len(more.frontier_F) < len(first.frontier_F) - 2:
        fail(f"incremental plan: the frontier shrank from "
             f"{len(first.frontier_F)} to {len(more.frontier_F)} points")
    job = expt5_job(8, 8, dev)
    exec_plans = replay_check("planner plan_job")
    platform.reset_launches()
    dag, dag_s = timed(lambda: plan_dag(job, use_kernel=True, device=dev))
    dag_launches = platform.launch_counts()
    dag_plain = platform.plain_on_cuda_counts()
    for name in ("pairwise_compose", "cross_dominator_counts"):
        if dag_launches.get(name, 0) <= 0:
            fail(f"plan_dag: kernel {name} was not launched")
    if dag_plain:
        fail(f"plan_dag: plain versions ran on the card: {dag_plain}")
    check_composed(job, types.SimpleNamespace(F=dag.frontier_F,
                                              X=dag.frontier_X),
                   dag.stage_frontiers, "plan_dag job8")
    if set(dag.stage_configs) != set(job.stage_names):
        fail("plan_dag: the pick does not configure every stage")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as root:
        root = Path(root)
        _write_dryrun_artifacts(root)
        reg = ModelRegistry(trainer=TrainerConfig(hidden=(24, 24),
                                                  max_epochs=30, seed=0),
                            device=dev)
        sig, n = ingest_dryrun(reg, "qwen3-4b", "train_4k", root=root)
        sig2, n2 = ingest_dryrun(reg, "qwen3-4b", "train_4k", root=root)
        traces = reg.info(sig)["traces"]
    if (n, n2, sig2, traces) != (2, 2, sig, 4):
        fail(f"ingest_dryrun: rows {n}, {n2}, traces {traces}")
    out = {"plans": plans, "cost_cap": cap,
           "capped": {"seconds": capped_s,
                      "points": len(capped.frontier_F)},
           "elastic": {"seconds": elastic_s, "num_chips": elastic.num_chips,
                       "points": len(elastic.frontier_F)},
           "incremental": {"seconds": more_s,
                           "points": len(more.frontier_F),
                           "probes": [before, more.pf_state.probes]},
           "plan_dag": {"seconds": dag_s, "points": len(dag.frontier_F),
                        "probes": dag.probes, "launches": dag_launches,
                        "routes": platform.route_counts()},
           "ingest": {"rows": n + n2, "traces": traces},
           "exec": {"plan_job": exec_plans,
                    "plan_dag": replay_check("planner plan_dag")}}
    log(f"planner: {out}")
    return out


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
    The first executor dispatch the plane makes after a ticket has
    completed is held inside its ``frontdesk.dispatch`` span until the
    second thread has made ``FD_RECOMMENDS`` ``recommend`` calls, each of
    which must answer while it is held (the service lock is released
    while a dispatch is in flight).  Then every session is closed (its state persisted) and the vault
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
    rec_s: list = []  # seconds a recommend call
    held_s: list = []  # seconds of the calls made while a dispatch is held
    stop = threading.Event()
    held, release = threading.Event(), threading.Event()
    hold: dict = {}  # the held dispatch's window on the tracer's clock
    errors: list = []
    solve = svc.executor.solve_requests

    def held_solve(*args, **kwargs):
        # the plane's first executor dispatch after a ticket completed
        # waits (inside its dispatch span) for the reader's burst
        if (served and not held.is_set() and threading.current_thread()
                .name == "frontdesk-dispatcher"):
            hold["t0"] = time.perf_counter()
            held.set()
            if not release.wait(timeout=FD_HOLD_S):
                errors.append(f"the held dispatch was not released in "
                              f"{FD_HOLD_S} s")
            hold["t1"] = time.perf_counter()
        return solve(*args, **kwargs)

    svc.executor.solve_requests = held_solve

    def call(i) -> float | None:
        sid = served[i % len(served)]
        t0 = time.perf_counter()
        try:
            rec = svc.recommend(sid)
        except Exception as e:  # reported and failed below
            errors.append(repr(e))
            return None
        dt = time.perf_counter() - t0
        rec_s.append(dt)
        if len(rec.config) != 12:
            errors.append(f"recommend({sid}) set {len(rec.config)} knobs")
            return None
        return dt

    def reader():
        i = 0
        while not stop.is_set():
            if held.is_set() and not release.is_set():
                for _ in range(FD_RECOMMENDS):
                    dt = call(i)
                    i += 1
                    if dt is None:
                        return
                    held_s.append(dt)
                release.set()
                continue
            if not served:
                time.sleep(FD_RECOMMEND_PAUSE_S)
                continue
            if call(i) is None:
                return
            i += 1
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
    svc.executor.solve_requests = solve
    spans = svc.obs.tracer.spans()
    windows = sorted((sp.t0, sp.t1) for sp in spans
                     if sp.name == "frontdesk.dispatch")
    if len(held_s) != FD_RECOMMENDS or "t1" not in hold:
        fail(f"front desk: {len(held_s)} recommend calls answered while a "
             f"dispatch was held, want {FD_RECOMMENDS}")
    if not any(a <= hold["t0"] and hold["t1"] <= b for a, b in windows):
        fail("front desk: the held dispatch lies in no frontdesk.dispatch "
             "span")
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
           "recommend_s": {"while_held": _pcts(held_s),
                           "hold_s": hold["t1"] - hold["t0"],
                           "all": _pcts(rec_s)},
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
                 dh=LM_HEAD_DIM, B=1):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda *sh: torch.tensor(rng.normal(size=sh), dtype=torch.float32,  # noqa: E731
                                 device=dev).to(dtype)
    return t(B, S, H, dh), t(B, S, Hk, dh), t(B, S, Hk, dh)


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
    run from a state; y and the final state at 3e-4).  Then the training
    phase's shapes: flash at B = 4, S = 512 (the full-width steps) and all
    three kernels at the driver's smoke shapes (``TRAIN_SMOKE_SHAPES``),
    each from zero, at the same tolerances."""
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
    sm = TRAIN_SMOKE_SHAPES["rwkv6_wkv"]
    args = _wkv_inputs(dev, sm["B"], sm["T"], sm["H"], sm["dh"], 7, False)
    y, S = rwkv6_wkv_cuda(*args)
    want_y, want_S = ref.rwkv6_wkv(*args)
    wkv_err = max(wkv_err,
                  _close(y, want_y, LM_WKV_TOL, f"rwkv6_wkv smoke {sm} y"),
                  _close(S, want_S, LM_WKV_TOL, f"rwkv6_wkv smoke {sm} S"))
    flash_err = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-3)):
        worst = 0.0
        smoke = TRAIN_SMOKE_SHAPES["flash_attention"]
        cases = [(S, {}) for S in LM_FLASH_S] + [
            (TRAIN_S, {"B": TRAIN_B}),
            (smoke["S"], {k: smoke[k] for k in ("B", "H", "Hk", "dh")})]
        for S, shape in cases:
            q, k, v = _attn_inputs(dev, S, dtype, S, **shape)
            got = flash_attention_cuda(q, k, v)
            if got.dtype != dtype:
                fail(f"flash_attention returned {got.dtype} for {dtype}")
            worst = max(worst, _close(
                got.float(), flash_attention_plain(q, k, v).float(), tol,
                f"flash_attention S={S} {shape} {dtype}"))
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
    sm = TRAIN_SMOKE_SHAPES["mamba_scan"]
    args = _scan_inputs(dev, sm["T"], 7, False, d=sm["d"], n=sm["n"],
                        B=sm["B"])
    y, h = mamba_scan_cuda(*args)
    want_y, want_h = ref.mamba_scan(*args)
    scan_err = max(scan_err,
                   _close(y, want_y, LM_SCAN_TOL, f"mamba_scan smoke {sm} y"),
                   _close(h, want_h, LM_SCAN_TOL,
                          f"mamba_scan smoke {sm} h_fin"))
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
    ``kernels.ops``; ``graph_replay`` is ``ops`` captured as a CUDA graph
    and replayed back to back (what a decode step on the engine's graph
    route pays for the call: none of the pieces above)."""
    import torch

    from repro_torch.kernels import graphs, native, ops, platform
    from repro_torch.kernels import mamba_scan as msc
    from repro_torch.kernels import rwkv6_wkv as rk

    lib = native.library()
    idx = dev.index
    t = lambda fn: _us_per_call(fn, reps)  # noqa: E731

    def replayed(fn):
        with graphs.building(dev) as stream:
            graphs.warm_up(stream, fn)
            cap = graphs.capture(fn, stream, dev, "a decode call",
                                 route="decode_host")
        return t(cap.graph.replay)

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
               ops=t(lambda: ops.rwkv_wkv(*args)),
               graph_replay=replayed(lambda: ops.rwkv_wkv(*args)))

    args = _scan_inputs(dev, 1, 12, True)
    scan = pieces(msc, args, msc.mamba_scan_cuda(*args), (), lib.mamba_scan)
    scan.update(call=t(lambda: msc.mamba_scan_cuda(*args)),
                apply=t(lambda: msc.mamba_scan(*args)),
                ops=t(lambda: ops.mamba_selective_scan(*args)),
                graph_replay=replayed(
                    lambda: ops.mamba_selective_scan(*args)))
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


# the port's kernels by the name of their CUDA function in a profile
LM_KERNEL_KEYS = {"rwkv6_wkv": "wkv_kernel", "mamba_scan": "scan_kernel",
                  "flash_attention": "flash_fwd"}


def lm_profile(dev, engine, cfg) -> dict:
    """Where one decode step and one 512-token prefill spend their time:
    the decode on the engine's graph route (a replay of slot 0's decode
    graph at the slot's position) and eagerly (``decode_eager``: the same
    step closure run on a copy of slot 0's cache), the prefill as the
    engine calls it: wall ms (host clock, mean of 3, ending in a sync),
    the device's kernel ms and count from the profiler (CUDA activity
    only, one call), and the device's idle share of the wall time; the
    five kernels that take most device time, and each of the port's
    kernels that ran: its launches and device ms a launch
    (``kernel_ms``)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.exec import tree_map

    tok = 1
    prompt = engine._tokens(np.arange(max(LM_PROMPTS))[None] % cfg.vocab)
    copy = tree_map(torch.clone, engine.slot_cache[0])
    step = engine._decode_fn(copy, torch.full((1, 1), tok, device=dev),
                             torch.tensor(int(engine.slot_pos[0]),
                                          device=dev))
    calls = {
        "decode": lambda: engine._decode_call(0, tok),
        "decode_eager": step,
        "prefill_512": lambda: engine._prefill(engine.cparams,
                                               {"tokens": prompt}),
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
        ours = {}
        for kernel, key in LM_KERNEL_KEYS.items():
            hits = [e for e in kern if key in e.key]
            n = sum(e.count for e in hits)
            if n:
                ours[kernel] = {"launches": n, "device_ms_a_launch": sum(
                    dev_t(e) for e in hits) / n / 1e3}
        out[name] = {"wall_ms": wall_ms,
                     "device_ms": busy_ms if seen else None,
                     "kernels": sum(e.count for e in kern),
                     "idle_share": 1.0 - busy_ms / wall_ms if seen else None,
                     "kernel_ms": ours,
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


def _host_route(*args, **kwargs):
    """A ``ServeEngine(*args, **kwargs)`` whose decode steps run eagerly
    on the card: the graph route's step closure, uncaptured."""
    from repro_torch.serving import ServeEngine

    class HostRoute(ServeEngine):
        def _decode_call(self, slot: int, token: int):
            return self._decode_fn(self.slot_cache[slot], self._tokens(
                [[token]]), int(self.slot_pos[slot]))()[0]

    return HostRoute(*args, **kwargs)


def _timed(dev, engine) -> dict:
    """Time ``engine``'s prefill steps and decode calls, each ending in a
    device sync: seconds by prompt length (``prefill``), a slot's first
    decode on the graph route (``first``: its warm-up, capture and
    replay) and every other decode (``decode``)."""
    rec = {"prefill": {}, "decode": [], "first": []}
    inner_prefill, inner_decode = engine._prefill, engine._decode_call

    def timed_prefill(p, b):
        t1 = time.perf_counter()
        out = inner_prefill(p, b)
        _sync(dev)
        rec["prefill"].setdefault(int(b["tokens"].shape[1]), []).append(
            time.perf_counter() - t1)
        return out

    def timed_decode(slot, token):
        before = engine.decode_graphs[slot]
        t1 = time.perf_counter()
        out = inner_decode(slot, token)
        _sync(dev)
        first = before is None and engine.decode_graphs[slot] is not None
        rec["first" if first else "decode"].append(time.perf_counter() - t1)
        return out

    engine._prefill, engine._decode_call = timed_prefill, timed_decode
    return rec


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
    must be one per mixer layer and call.

    The engine runs on its graph route: the phase fails unless every
    decode is a replay of its slot's graph (one warm-up and capture a
    slot) and no prefill is captured, three more steps of slot 0 each
    equal the same step run eagerly on a copy of the slot's cache (logits
    and every cache leaf, bit for bit), and an engine whose decode steps
    run eagerly (``_host_route``) gives the first 4 requests' tokens again
    on the same card (its decode times are the eager route's, measured in
    the same run).  The graphs' capture seconds, nodes and shared pool
    bytes are kept."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import graphs, platform
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
    untimed = engine._prefill
    now = _timed(dev, engine)
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, LM_PROMPTS[i % len(LM_PROMPTS)]).astype(np.int32),
        max_new=LM_MAX_NEW) for i in range(LM_REQUESTS)]
    platform.reset_launches()
    capture_s = graphs.CAPTURE_S["serve"]
    t0 = time.perf_counter()
    engine.run(reqs)
    _sync(dev)
    wall = time.perf_counter() - t0
    # untimed from here; nothing left that refers back to the engine, so
    # it is freed as soon as it is dropped
    engine._prefill = untimed
    del engine._decode_call
    capture_s = graphs.CAPTURE_S["serve"] - capture_s
    launches = platform.launch_counts()
    routes = platform.route_counts()
    plain = _no_plain_on_card(platform, f"{arch} ServeEngine.run")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"{arch} ServeEngine.run launches: {launches}; routes: {routes}; "
        f"plain versions on the card: {plain}")
    if routes.get("flash_attention:wgmma", 0) != launches.get(
            "flash_attention", 0):
        fail(f"{arch}: bf16 prefills' flash launches by route {routes}, "
             f"want all {launches.get('flash_attention', 0)} on wgmma")
    prefill_s, decode_s = now["prefill"], now["first"] + now["decode"]
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
    # every decode a replay, one warm-up and capture a slot; no prefill
    # captured
    graph = engine.graph_stats()
    want_routes = {"serve:decode:eager": min(LM_SLOTS, LM_REQUESTS),
                   "serve:decode:graph": len(decode_s)}
    got_routes = {k: v for k, v in routes.items() if k.startswith("serve:")}
    if got_routes != want_routes or graph["decode_graphs"] != min(
            LM_SLOTS, LM_REQUESTS):
        fail(f"{arch}: ServeEngine.run's steps by route {got_routes}, want "
             f"{want_routes} ({graph['decode_graphs']} decode graphs)")
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
    exact = replay_equals_eager(dev, engine, 0, 3, arch)
    # the eager route on the same card: the first LM_SLOTS requests, one a
    # slot, must give the graph route's tokens
    host = _host_route(params, cfg, batch=LM_SLOTS, max_seq=max_seq,
                       device=dev)
    eager = _timed(dev, host)
    eager_reqs = host.run([Request(rid=r.rid, prompt=r.prompt,
                                   max_new=LM_MAX_NEW)
                           for r in reqs[:LM_SLOTS]])
    del host
    _free()
    if [r.out for r in eager_reqs] != [r.out for r in reqs[:LM_SLOTS]]:
        fail(f"{arch}: the graph route's tokens differ from the eager "
             f"route's on the same requests")
    decode_bytes = _decode_bytes(engine.cparams)
    decode_flops = _decode_flops(engine.cparams, cfg)
    prof = lm_profile(dev, engine, cfg)
    ms = lambda v: float(np.median(v)) * 1e3  # noqa: E731
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "param_dtype": cfg.param_dtype,
           "params_b": n_params / 1e9, "init_s": init_s,
           "launches": launches, "routes": routes,
           "fp32_check_err": check, "requests": len(reqs),
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "decode_calls": len(decode_s),
           "decode_ms_median": ms(decode_s),
           "decode_ms_p90": float(np.percentile(decode_s, 90)) * 1e3,
           "decode_replay_ms_median": ms(now["decode"]),
           "decode_first_ms": [t * 1e3 for t in now["first"]],
           "decode_eager_ms_median": ms(eager["decode"]),
           "decode_eager_ms_p90": float(np.percentile(
               eager["decode"], 90)) * 1e3,
           "decode_bound_ms": decode_bytes / PEAK_BYTES_S * 1e3,
           "decode_ops_bound_ms": decode_flops / PEAK_BF16_S * 1e3,
           "prefill_ms": {n: ms(v) for n, v in sorted(prefill_s.items())},
           "prefill_calls_ms": {n: [t * 1e3 for t in v]
                                for n, v in sorted(prefill_s.items())},
           "graphs": {**graph, "capture_s": capture_s,
                      "replay_exact_steps": exact},
           "peak_mem_gb": peak_gb,
           "peak_mem_gb_after_checks":
               torch.cuda.max_memory_allocated(dev) / 1e9,
           "profile": prof}
    log(f"{arch} serving: {out}")
    del engine, params
    _free()
    return out


def replay_equals_eager(dev, engine, slot: int, steps: int,
                        arch: str) -> int:
    """``steps`` greedy decode steps of ``slot`` on its graph (the
    engine's ``_decode_call``), each held to the
    same step closure run eagerly on a copy of the slot's cache, with the
    same token and position: the logits and every cache leaf bit for bit.
    Returns the steps held."""
    import torch

    from repro_torch.exec import tree_map
    from repro_torch.nn.model import tree_leaves

    tok = 1
    for k in range(steps):
        copy = tree_map(torch.clone, engine.slot_cache[slot])
        pos = int(engine.slot_pos[slot])
        want = engine._decode_fn(copy, torch.full((1, 1), tok, device=dev),
                                 torch.tensor(pos, device=dev))()[0]
        got = engine._decode_call(slot, tok)
        if not torch.equal(got, want):
            fail(f"{arch}: slot {slot}'s decode replay at position {pos} "
                 f"differs from the eager step by "
                 f"{float((got.float() - want.float()).abs().max())}")
        for i, (g, w) in enumerate(zip(tree_leaves(engine.slot_cache[slot]),
                                       tree_leaves(copy))):
            if not torch.equal(g, w):
                fail(f"{arch}: slot {slot}'s cache leaf {i} after the "
                     f"replay at position {pos} differs from the eager "
                     f"step's")
        engine.slot_pos[slot] += 1
        tok = int(torch.argmax(got[0]))
    return steps


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


# ---------------------------------------------------------------------------
# Phase 7b: LM training
# ---------------------------------------------------------------------------


def _train_counts(platform, cfg, steps: int, label: str) -> dict:
    """The launch counts since the last reset, held to a train step's: per
    step, each mixer layer launches its kernel once in the forward and
    recomputes through its plain version once in the backward; no plain
    forward on the card, and every flash launch of a bf16 model on the
    tensor-core route."""
    import torch

    launches = platform.launch_counts()
    plain = platform.plain_on_cuda_counts()
    back = platform.plain_backward_on_cuda_counts()
    routes = platform.route_counts()
    want = {name: _mixer_layers(cfg, kind) * steps
            for name, kind in (("rwkv6_wkv", "rwkv"),
                               ("flash_attention", "attn"),
                               ("mamba_scan", "mamba"))}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            fail(f"{label}: {name} launched {launches.get(name, 0)} times, "
                 f"want {n} ({steps} steps)")
        if back.get(name, 0) != n:
            fail(f"{label}: {name} recomputed {back.get(name, 0)} times in "
                 f"the backward, want {n}")
        if plain.get(name, 0):
            fail(f"{label}: the plain {name} ran {plain[name]} times on a "
                 f"CUDA tensor in the forward")
    if cfg.cdtype() == torch.bfloat16 and routes.get(
            "flash_attention:wgmma", 0) != want["flash_attention"]:
        fail(f"{label}: flash launches by route {routes}, want all on wgmma")
    return {"launches": launches, "plain_backward": back, "routes": routes}


def plain_first_step(cfg, params, batch, arch: str) -> dict:
    """The first train step's loss and gradient norm with the forward
    kernels forced to their plain versions on the card (the same
    ``grads_of`` and ``global_norm`` as ``make_train_step``; no Adam state
    is needed for them, so none is allocated beside the parameters).  The
    counts show that nothing launched and that each mixer layer ran its
    plain forward and its recompute once."""
    from repro_torch.kernels import flash_attention, mamba_scan, platform
    from repro_torch.kernels import rwkv6_wkv
    from repro_torch.nn import attention
    from repro_torch.training.adam import global_norm
    from repro_torch.training.train_step import grads_of

    platform.reset_launches()
    with contextlib.ExitStack() as stack:
        for module in (flash_attention, rwkv6_wkv, mamba_scan, attention):
            stack.enter_context(forced(module, "use_kernel", False))
        grads, metrics = grads_of(params, cfg, batch)
        out = {"loss": float(metrics["loss"]),
               "grad_norm": float(global_norm(grads))}
    del grads
    launches = platform.launch_counts()
    plain = platform.plain_on_cuda_counts()
    back = platform.plain_backward_on_cuda_counts()
    for name, kind in (("rwkv6_wkv", "rwkv"), ("flash_attention", "attn"),
                       ("mamba_scan", "mamba")):
        n = _mixer_layers(cfg, kind)
        if (launches.get(name, 0), plain.get(name, 0),
                back.get(name, 0)) != (0, n, n):
            fail(f"{arch} plain step: {name} launched "
                 f"{launches.get(name, 0)}, plain {plain.get(name, 0)}, "
                 f"recomputed {back.get(name, 0)} (want 0, {n}, {n})")
    platform.reset_launches()
    return out


def profile_call(dev, fn, wall_ms: float) -> dict:
    """One call of ``fn`` under the profiler (CUDA activity only, ending in
    a sync): the device's kernel ms and count, and its idle share of
    ``wall_ms`` (None where the profiler recorded no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
                  for e in kern) / 1e3
    seen = busy_ms > 0
    return {"device_ms": busy_ms if seen else None,
            "kernels": sum(e.count for e in kern),
            "idle_share": 1.0 - busy_ms / wall_ms if seen else None}


def train_full(dev, arch: str) -> dict:
    """One model at full width, depth cut by ``TRAIN_CUTS``, weights from
    seed 0: ``TRAIN_STEPS`` calls of a ``GraphTrainStep`` (bf16 compute,
    fp32 parameters and moments; the first eager, then replays) on one
    MarkovCorpus batch drawn through the ``TokenLoader``, its first step
    held to ``plain_first_step``'s.  CUDA events from the step's ``_mark``
    hook split the eager first step into forward, backward and Adam
    update; one more replay is profiled; the launch counts are those of
    the steps alone."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import MarkovCorpus, TokenLoader
    from repro_torch.kernels import graphs, platform
    from repro_torch.training import (
        AdamConfig,
        GraphTrainStep,
        TrainStepConfig,
        adam_init,
    )

    cfg = get_config(arch).replace(**TRAIN_CUTS[arch])
    torch.cuda.reset_peak_memory_stats(dev)
    params, n_params, init_s = _instance(dev, cfg)
    loader = TokenLoader(MarkovCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S,
                         device=dev, seed=1)
    batch = next(loader)  # one batch, every step (TRAIN_STEPS' note)
    loader.close()
    plain = plain_first_step(cfg, params, batch, arch)
    adam = AdamConfig(lr=TRAIN_LR)
    marks: dict = {}

    def mark(label: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[label] = ev

    step = GraphTrainStep(cfg, params, adam_init(params, adam),
                          TrainStepConfig(adam=adam), _mark=mark)
    del params  # the step owns the state
    capture_before = graphs.CAPTURE_S["train"]
    losses, walls, norms = [], [], []
    platform.reset_launches()
    for i in range(TRAIN_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        if i == 0:
            mark("start")
        metrics = step(batch)
        losses.append(float(metrics["loss"]))  # syncs
        walls.append(time.perf_counter() - t0)
        norms.append(float(metrics["grad_norm"]))
    counts = _train_counts(platform, cfg, TRAIN_STEPS, f"{arch} training")
    routes = platform.route_counts()
    if (routes.get("train:eager"), routes.get("train:graph")) != (
            1, TRAIN_STEPS - 1):
        fail(f"{arch} training: routes {routes}, want one eager step and "
             f"{TRAIN_STEPS - 1} replays")
    first = {"loss": losses[0], "grad_norm": norms[0]}
    plain_err = {k: abs(first[k] - plain[k]) / abs(plain[k]) for k in plain}
    if not all(e <= TRAIN_PLAIN_TOL for e in plain_err.values()):
        fail(f"{arch} training: the first step {first}, with the plain "
             f"versions {plain} (relative {plain_err}, want <= "
             f"{TRAIN_PLAIN_TOL})")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"{arch} training: losses {losses}")
    split, prev = {}, marks["start"]
    for name in ("forward", "backward", "update"):
        split[name] = prev.elapsed_time(marks[name])
        prev = marks[name]
    step_ms = float(np.median(walls[TRAIN_TIMED])) * 1e3
    cap = step.captured
    capture_s = graphs.CAPTURE_S["train"] - capture_before
    first_ms = walls[0] * 1e3
    out = {"layers": cfg.n_layers, "params_b": n_params / 1e9,
           "init_s": init_s, "losses": losses, "route": "graph",
           "step_ms": step_ms, "step_ms_all": [w * 1e3 for w in walls],
           "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3),
           "device_ms": split,
           "backward_share": split["backward"] / sum(split.values()),
           "capture_s": capture_s, "instantiate_s": cap.instantiate_s,
           "nodes": cap.nodes, "pool_gb": cap.pool_bytes / 1e9,
           # steps after which the time a replay saves against the eager
           # first step has paid for the capture
           "payback_steps": (capture_s / ((first_ms - step_ms) / 1e3)
                             if first_ms > step_ms else None),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "grad_norms": norms, "plain_first": plain,
           "plain_rel_err": plain_err, "routes": routes, **counts}
    out["replay"] = profile_call(dev, lambda: step(batch), step_ms)
    log(f"{arch} training: {out}")
    del step, metrics, batch, cap
    _free()
    return out


def _leaf_items(tree, path: str = ""):
    """``(path, tensor)`` of every leaf of a dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{path}/{i}")
    else:
        yield path, tree


def _leaf_diffs(got, want) -> dict:
    """The largest absolute difference of each leaf, by path."""
    out = {}
    for (path, a), (_, b) in zip(_leaf_items(got), _leaf_items(want)):
        out[path] = float((a.double() - b.double()).abs().max())
    return out


def train_replay_check(dev, arch: str) -> dict:
    """At full width and ``REPLAY_CUTS``' depth: two eager
    ``make_train_step`` steps from one state (the control), then a
    ``GraphTrainStep``'s eager first call and ``REPLAY_STEPS`` replays,
    each replay held to an eager step from the state it started from.
    Every leaf of the state and every metric must equal bit for bit,
    except on the leaves where the control differs, held to
    ``CHAOS_FACTOR`` times the control's difference there."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import MarkovCorpus, TokenLoader
    from repro_torch.exec import tree_map
    from repro_torch.kernels import platform
    from repro_torch.training import (
        AdamConfig,
        GraphTrainStep,
        TrainStepConfig,
        adam_init,
        make_train_step,
    )

    cuts = dict(REPLAY_CUTS[arch])
    cfg = get_config(arch)
    if "hybrid" in cuts:
        cuts["hybrid"] = dataclasses.replace(cfg.hybrid, **cuts["hybrid"])
    cfg = cfg.replace(**cuts)
    params, n_params, _ = _instance(dev, cfg)
    loader = TokenLoader(MarkovCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S,
                         device=dev, seed=1)
    batch = next(loader)
    loader.close()
    ts = TrainStepConfig(adam=AdamConfig(lr=TRAIN_LR))
    eager = make_train_step(cfg, ts)
    opt = adam_init(params, ts.adam)

    def state_of(out):
        return {"params": out[0], "opt": out[1], "metrics": out[2]}

    a = state_of(eager(params, opt, batch))
    b = state_of(eager(params, opt, batch))
    control = _leaf_diffs(a, b)
    del a, b
    step = GraphTrainStep(cfg, params, opt, ts)
    step(batch)  # the eager first call
    platform.reset_launches()
    worst = {}
    for _ in range(REPLAY_STEPS):
        before = tree_map(torch.clone, step.state)
        got = {**step.state, "metrics": step(batch)}
        want = state_of(eager(before["params"], before["opt"], batch))
        for path, x in _leaf_diffs(got, want).items():
            worst[path] = max(worst.get(path, 0.0), x)
        del before, got, want
    if platform.route_counts().get("train:graph") != REPLAY_STEPS:
        fail(f"{arch} replay check: routes {platform.route_counts()}")
    off = {p: (x, control[p]) for p, x in worst.items()
           if x > CHAOS_FACTOR * control[p]}
    if off:
        fail(f"{arch} replay check: leaves apart from the eager step "
             f"beyond the control (replay, control): {off}")
    out = {"layers": cfg.n_layers, "params_b": n_params / 1e9,
           "leaves": len(worst),
           "bit_exact_leaves": sum(x == 0 for x in worst.values()),
           "control_differs": {p: x for p, x in control.items() if x},
           "replay_differs": {p: x for p, x in worst.items() if x}}
    log(f"{arch} replay check: {out}")
    del step, params, opt, batch, eager
    _free()
    return out


def _probe_mesh_runs(dev) -> dict:
    """The tenants' structure (D = 13, hidden (128,)*4, one task a
    ``batch_suite()`` workload) through three executors: ``mesh=None``,
    ``probe_mesh()`` (one card: the unsharded program) and a two-shard
    ``ProbeMesh((cuda:0, cuda:0))``; all tenants coalesced (the group
    axis), then one tenant's many boxes (the row axis).  Each dispatch is
    held to the unsharded one; the descend kernel must launch once a
    shard and no plain version run on the card."""
    import numpy as np

    from repro_torch.core import MOGDConfig
    from repro_torch.core.mogd import (
        MOGDSolver,
        estimate_objective_bounds,
        solve_grouped,
    )
    from repro_torch.data.workloads import batch_suite
    from repro_torch.distributed import ProbeMesh, probe_mesh
    from repro_torch.exec import ProbeExecutor
    from repro_torch.kernels import platform

    problems = [spark_task(1 + i, dev, w).compile()
                for i, w in enumerate(batch_suite())]
    boxes = []
    for i, p in enumerate(problems):
        b = estimate_objective_bounds(p, n=256, seed=i)
        rng = np.random.default_rng(i)
        n = DIST_ROW_BOXES if i == 0 else DIST_BOXES
        lo = b[0] + rng.random((n, p.k)) * 0.3 * (b[1] - b[0])
        hi = lo + (0.2 + 0.5 * rng.random((n, p.k))) * (b[1] - b[0])
        boxes.append(np.stack([lo, hi], axis=1))
    meshes = {"none": None, "probe_mesh": probe_mesh(),
              "two_shards": ProbeMesh([dev, dev])}
    runs = {}
    for name, mesh in meshes.items():
        # "fused": no one-time parity gate, whose own launch would count
        ex = ProbeExecutor(mesh=mesh, backend="fused", device=dev)
        for axis in ("group", "row"):
            solvers = [MOGDSolver(p, MOGDConfig(), executor=ex, device=dev)
                       for p in problems]
            platform.reset_launches()
            t0 = time.perf_counter()
            if axis == "group":
                res = solve_grouped([(s, b[:DIST_BOXES], 0)
                                     for s, b in zip(solvers, boxes)])
            else:
                res = solvers[0].solve(boxes[0], 0)
            seconds = time.perf_counter() - t0
            runs[(name, axis)] = {
                "res": res, "seconds": seconds,
                "launches": platform.launch_counts().get("descend_batch", 0),
                "plain": platform.plain_on_cuda_counts(),
                "exec": {k: n for k, n in platform.route_counts().items()
                         if k.startswith("exec:")},
                "bucket": list(ex.last_bucket),
                "sharded_axis": ex.last_shard_axis,
                "sharded_dispatches": ex.sharded_dispatches}
    out = {}
    refs = {axis: runs[("none", axis)]["res"] for axis in ("group", "row")}
    for (name, axis), r in runs.items():
        ref, res = refs[axis], r.pop("res")
        dx = float(np.abs(res.x - ref.x).max())
        df = float(np.abs(res.f - ref.f).max())
        same_feas = bool((res.feasible == ref.feasible).all())
        label = f"probe mesh {name}, {axis} axis"
        if not (dx <= DIST_PROBE_TOL and df <= DIST_PROBE_TOL and same_feas):
            fail(f"{label}: |dx| {dx}, |df| {df}, feasibility equal "
                 f"{same_feas} against mesh=None (want <= {DIST_PROBE_TOL})")
        shards = 2 if name == "two_shards" else 1
        if r["launches"] != shards:
            fail(f"{label}: descend launched {r['launches']} times, want "
                 f"{shards} (once a shard)")
        if name == "two_shards" and r["sharded_axis"] != axis:
            fail(f"{label}: the dispatch was sharded on "
                 f"{r['sharded_axis']}")
        if name != "two_shards" and r["sharded_dispatches"]:
            fail(f"{label}: {r['sharded_dispatches']} sharded dispatches")
        if r["plain"]:
            fail(f"{label}: plain versions ran on the card: {r['plain']}")
        out[f"{name}/{axis}"] = {**r, "max_dx": dx, "max_df": df,
                                 "feasible_equal": same_feas}
    log(f"probe meshes: {out}")
    return out


def _psum_one_rank(dev) -> dict:
    """``compressed_psum`` over the running one-rank NCCL group: the mean
    is ``dequantize(quantize(g))`` and within half a step of ``g``."""
    import torch

    from repro_torch.distributed import (
        compressed_psum,
        dequantize_int8,
        quantize_int8,
    )

    g = torch.randn((4096,), generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    mean, resid = compressed_psum(g, torch.zeros_like(g))
    q, scale = quantize_int8(g)
    want = dequantize_int8(q, scale)
    exact = float((mean - want).abs().max())
    half = float((mean - g).abs().max())
    resid_err = float((resid - (g - want)).abs().max())
    if exact != 0.0 or half > float(scale) / 2 * (1 + 1e-6) or resid_err:
        fail(f"compressed_psum on NCCL: |mean - dequantize(quantize(g))| "
             f"{exact}, |mean - g| {half} against scale/2 "
             f"{float(scale) / 2}, residual off by {resid_err}")
    out = {"max_abs_vs_dequantized": exact, "max_abs_vs_grad": half,
           "half_scale": float(scale) / 2}
    log(f"compressed_psum on NCCL: {out}")
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _one_rank_mesh():
    """A (1, 1) ``("data", "model")`` DeviceMesh of the running group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


def _kernels_a_call(cfg, decode: bool) -> dict:
    """Each kernel's launches a forward of ``cfg``: once a mixer layer
    (a decode step's attention reads its cache without flash)."""
    return {name: n for name, n in (
        ("flash_attention", 0 if decode else _mixer_layers(cfg, "attn")),
        ("mamba_scan", _mixer_layers(cfg, "mamba")),
        ("rwkv6_wkv", _mixer_layers(cfg, "rwkv"))) if n}


def _check_launches(platform, cfg, label: str, decode: bool) -> dict:
    """The launches since the last reset: each kernel once a mixer layer,
    no other, and no plain version on the card."""
    got = platform.launch_counts()
    want = _kernels_a_call(cfg, decode)
    if {k: v for k, v in got.items() if v} != want:
        fail(f"{label}: launches {got}, want {want}")
    if platform.plain_on_cuda_counts():
        fail(f"{label}: plain versions on the card "
             f"{platform.plain_on_cuda_counts()}")
    return got


def _max_rel(got, want) -> float:
    got = got.full_tensor().float() if hasattr(got, "full_tensor") \
        else got.float()
    want = want.float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _mesh_train(dev, cfg, params, params_s, rules, batch, batch_s, adam,
                label: str) -> dict:
    """One train step with the rules against the same step without them
    (three of each, the first a warm-up): loss and gradient norm within
    ``DIST_LM_TOL`` relative, the forward kernels launched once a mixer
    layer, no plain version on the card, the parameters' placements
    kept; the collectives of the first sharded step and the step's ms
    (the median of the last two, CUDA-synchronized wall) with and
    without the mesh."""
    import numpy as np

    from repro_torch.distributed import collective_log
    from repro_torch.kernels import platform
    from repro_torch.nn import param_axes
    from repro_torch.nn.model import tree_leaves
    from repro_torch.training import (
        TrainStepConfig,
        adam_init,
        make_train_step,
    )

    ts = TrainStepConfig(adam=adam)
    steps = {"plain": (make_train_step(cfg, ts), params, batch),
             "mesh": (make_train_step(cfg, ts, rules,
                                      param_axes=param_axes(cfg)),
                      params_s, batch_s)}
    res, walls = {}, {"plain": [], "mesh": []}
    for rep in range(3):  # the first of each is a warm-up
        for name, (step, p, b) in steps.items():
            first = name == "mesh" and rep == 0
            clog = collective_log() if first else contextlib.nullcontext()
            _free()  # the last step's blocks, before the next's
            platform.reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            with clog:
                p_new, _, m = step(p, adam_init(p, adam), b)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            walls[name].append(time.perf_counter() - t0)
            res[name] = {"loss": loss, "grad_norm": gnorm,
                         "launches": platform.launch_counts(),
                         "plain_on_card": platform.plain_on_cuda_counts()}
            if first:
                colls = clog.by_kind()
                kept = all(a.placements == c.placements for a, c in zip(
                    tree_leaves(p_new), tree_leaves(p)))
            del p_new, m
    step_ms = {k: float(np.median(v[1:])) * 1e3 for k, v in walls.items()}
    err = {k: _rel(res["mesh"][k], res["plain"][k])
           for k in ("loss", "grad_norm")}
    if max(err.values()) > DIST_LM_TOL or not kept:
        fail(f"{label} train step: {res['mesh']} against {res['plain']} "
             f"(relative {err}), placements kept {kept}")
    got = {k: v for k, v in res["mesh"]["launches"].items() if v}
    if got != _kernels_a_call(cfg, False) or res["mesh"]["plain_on_card"]:
        fail(f"{label} train step: launches {got} (want "
             f"{_kernels_a_call(cfg, False)}), plain versions on the card "
             f"{res['mesh']['plain_on_card']}")
    return {"train": res, "train_rel_err": err, "step_ms": step_ms,
            "mesh_overhead": step_ms["mesh"] / step_ms["plain"] - 1.0,
            "train_collectives": colls, "placements_kept": kept,
            "train_launches": got}


def _mesh_serve(dev, cfg, params, params_s, rules, toks, toks_s,
                label: str) -> dict:
    """A prefill and one decode with the rules, each held to the same
    call without them at ``DIST_LM_TOL`` (logits, relative to their
    largest), the kernels launched once a mixer layer and call, the
    collectives of each sharded call, and each call's ms (the second of
    each, CUDA-synchronized wall) with and without the mesh."""
    import torch

    from repro_torch.distributed import collective_log
    from repro_torch.kernels import platform
    from repro_torch.serving import make_decode_step, make_prefill_step

    S = toks.shape[1]
    calls = {
        "plain": (make_prefill_step(cfg, max_seq=S + 4),
                  make_decode_step(cfg), params, toks),
        "mesh": (make_prefill_step(cfg, rules, max_seq=S + 4),
                 make_decode_step(cfg, rules), params_s, toks_s)}
    logits, ms, launches, colls = {}, {}, {}, {}

    def timed(call, fn, check, wall):
        log_ = collective_log() if check else contextlib.nullcontext()
        platform.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        with log_:
            out = fn()
            _sync(dev)
        wall[call] = (time.perf_counter() - t0) * 1e3
        if check:
            launches[call] = _check_launches(platform, cfg,
                                             f"{label} {call}",
                                             call == "decode")
            colls[call] = log_.by_kind()
        return out

    with torch.no_grad():
        for name, (prefill, decode, p, t) in calls.items():
            for rep in range(2):  # the mesh's first is checked and logged
                check, ms[name] = name == "mesh" and rep == 0, {}
                lg, cache = timed("prefill", lambda: prefill(
                    p, {"tokens": t}), check, ms[name])
                dl, _ = timed("decode", lambda: decode(
                    p, cache, {"tokens": t[:, -1:]}, S), check, ms[name])
                del cache
            logits[name] = (lg, dl)
    err = {call: _max_rel(g, w) for call, g, w in zip(
        ("prefill", "decode"), logits["mesh"], logits["plain"])}
    if max(err.values()) > DIST_LM_TOL:
        fail(f"{label}: logits relative {err} against the plain calls")
    return {"rel_err": err, "ms": ms, "launches": launches,
            "collectives": colls}


def _mesh_lm(dev, cfg, params, n_params: int, rules, adam,
             label: str) -> dict:
    """``cfg``'s parameters sharded by ``rules``, then ``_mesh_train``
    (unless ``adam`` is None) and ``_mesh_serve`` on one ``TRAIN_B`` x
    ``TRAIN_S`` batch of seeded tokens; the peak GB over both."""
    import torch

    from repro_torch.distributed import shard_tree
    from repro_torch.nn import param_axes

    torch.cuda.reset_peak_memory_stats()
    params_s = shard_tree(rules, params, param_axes(cfg))
    toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                         generator=torch.Generator(dev).manual_seed(3),
                         device=dev, dtype=torch.int32)
    toks_s = shard_tree(rules, toks, ("batch", None))
    out = {"layers": cfg.n_layers, "params_b": n_params / 1e9}
    if cfg.moe is not None:
        w1 = next(layer["moe"]["w1"] for unit in params_s["blocks"]
                  for layer in unit.values() if "moe" in layer)
        out["w1_shard_dims"] = [q.dim for q in w1.placements
                                if q.is_shard()]
        out["w1_local_shape"] = list(w1.to_local().shape)
    if adam is not None:
        out.update(_mesh_train(dev, cfg, params, params_s, rules,
                               {"tokens": toks}, {"tokens": toks_s}, adam,
                               label))
    out.update(_mesh_serve(dev, cfg, params, params_s, rules, toks, toks_s,
                           label))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: { {k: v for k, v in out.items() if k != 'train'} }")
    del params_s
    _free()
    return out


def _mesh_checkpoint(dev, cfg, params, rules, adam) -> dict:
    """``cfg``'s state after one step with the rules (parameters and Adam
    moments, DTensors on the mesh) saved through ``CheckpointManager``
    under the group (``save_async`` then ``wait``: save seconds, the
    snapshot's share, GB written, one sha256 pass of the file timed
    apart), restored by ``launch.train.restore_train_state`` into fresh
    DTensors (restore seconds), held to the saved state bit for bit with
    the same placements; then one more step from each, loss and gradient
    norm within ``DIST_LM_TOL`` relative.  The read is warm (the page
    cache holds the file just written)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.distributed import shard_tree
    from repro_torch.launch import train
    from repro_torch.nn import param_axes
    from repro_torch.nn.model import tree_leaves
    from repro_torch.persist.store import sha256_file
    from repro_torch.runtime import CheckpointManager
    from repro_torch.training import (
        TrainStepConfig,
        adam_init,
        make_train_step,
    )

    label = f"{cfg.name} checkpoint"
    axes = param_axes(cfg)
    step = make_train_step(cfg, TrainStepConfig(adam=adam), rules,
                           param_axes=axes)
    toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                         generator=torch.Generator(dev).manual_seed(4),
                         device=dev, dtype=torch.int32)
    batch = {"tokens": shard_tree(rules, toks, ("batch", None))}
    params_s = shard_tree(rules, params, axes)
    p1, o1, _ = step(params_s, adam_init(params_s, adam), batch)
    del params_s
    _free()
    saved = {"params": p1, "opt": o1}
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(saved)) / 1e9
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        mgr = CheckpointManager(root)
        _sync(dev)
        t0 = time.perf_counter()
        mgr.save_async(1, train.checkpoint_tree(saved))
        snapshot_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        _free()
        files = list((root / "step_00000001").iterdir())
        written_gb = sum(f.stat().st_size for f in files) / 1e9
        t0 = time.perf_counter()
        sha256_file(root / "step_00000001" / "shard_00000.npz")
        sha256_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _sync(dev)
        t0 = time.perf_counter()
        restored, manifest = train.restore_train_state(mgr, saved)
        _sync(dev)
        restore_s = time.perf_counter() - t0
        restore_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if manifest["step"] != 1:
        fail(f"{label}: restored step {manifest['step']}")
    leaves = _same_state(restored, saved, label)
    steps = {}
    for name, state in (("saved", saved), ("restored", restored)):
        _free()
        _, _, m = step(state["params"], state["opt"], batch)
        steps[name] = {"loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"])}
        del m
    err = {k: _rel(steps["restored"][k], steps["saved"][k])
           for k in ("loss", "grad_norm")}
    if max(err.values()) > DIST_LM_TOL:
        fail(f"{label}: the step from the restored state {steps['restored']}"
             f" against the saved state's {steps['saved']}")
    del saved, restored, p1, o1
    _free()
    out = {"state_gb": state_gb, "written_gb": written_gb,
           "save_s": save_s, "snapshot_s": snapshot_s,
           "sha256_s": sha256_s, "restore_s": restore_s,
           "restore_peak_gb": restore_peak_gb, "leaves": leaves,
           "next_step": steps, "next_step_rel_err": err}
    log(f"{label}: {out}")
    return out


def _mesh_engine(dev, cfg, params, rules, label: str) -> dict:
    """``ServeEngine(rules=)`` on ``cfg``'s parameters sharded by the
    rules against the plain engine, ``len(ENGINE_PROMPTS)`` requests on
    ``ENGINE_SLOTS`` slots, ``ENGINE_NEW`` new tokens each: equal greedy
    tokens, each kernel launched once a mixer layer and call (prefills
    and decodes counted from the requests), no plain version on the
    card; each engine's wall seconds."""
    import numpy as np

    from repro_torch.distributed import shard_tree
    from repro_torch.kernels import platform
    from repro_torch.nn import param_axes
    from repro_torch.serving import Request, ServeEngine

    max_seq = max(ENGINE_PROMPTS) + ENGINE_NEW + 8
    runs = {}
    for name, r in (("plain", None), ("rules", rules)):
        p = params if r is None else shard_tree(r, params, param_axes(cfg))
        engine = ServeEngine(p, cfg, batch=ENGINE_SLOTS, max_seq=max_seq,
                             rules=r, device=dev)
        rng = np.random.default_rng(5)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
            np.int32), max_new=ENGINE_NEW)
                for i, n in enumerate(ENGINE_PROMPTS)]
        _free()
        platform.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        engine.run(reqs)
        _sync(dev)
        wall = time.perf_counter() - t0
        prefills, decodes = len(reqs), sum(len(q.out) - 1 for q in reqs)
        want = {}
        for calls, decode in ((prefills, False), (decodes, True)):
            for k, v in _kernels_a_call(cfg, decode).items():
                want[k] = want.get(k, 0) + calls * v
        got = {k: v for k, v in platform.launch_counts().items() if v}
        if got != want:
            fail(f"{label} engine ({name}): launches {got}, want {want}")
        if platform.plain_on_cuda_counts():
            fail(f"{label} engine ({name}): plain versions on the card "
                 f"{platform.plain_on_cuda_counts()}")
        runs[name] = {"tokens": [q.out for q in reqs], "wall_s": wall,
                      "launches": got}
        del engine, p
    if runs["rules"]["tokens"] != runs["plain"]["tokens"]:
        fail(f"{label} engine: tokens with the rules "
             f"{runs['rules']['tokens']} against "
             f"{runs['plain']['tokens']}")
    out = {"requests": len(ENGINE_PROMPTS),
           "tokens": sum(len(t) for t in runs["rules"]["tokens"]),
           "wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "launches": runs["rules"]["launches"]}
    log(f"{label} engine: {out}")
    _free()
    return out


def _mesh_driver(dev) -> dict:
    """``launch.train.main`` under the running group (the (1, 1) mesh of
    its one rank) at the qwen3-4b smoke config with ``--ckpt``: a run to
    ``MESH_DRIVER_STEPS[0]`` whose state is DTensors, its checkpoint
    restored bit for bit with the same placements, a second ``main``
    resuming to ``MESH_DRIVER_STEPS[1]`` (``TestTrainDriver``'s contract:
    as many finite losses as its steps); launches as ``_train_counts``
    holds them, in both runs."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.distributed import is_dtensor
    from repro_torch.kernels import platform
    from repro_torch.launch import train
    from repro_torch.runtime import CheckpointManager

    cfg = get_smoke("qwen3-4b")
    k, n = MESH_DRIVER_STEPS
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_driver_"))
    args = [*MESH_DRIVER_ARGS, "--device", "cuda", "--ckpt", str(root)]
    try:
        platform.reset_launches()
        with contextlib.redirect_stdout(sys.stderr):
            r1 = train.main(args + ["--steps", str(k)])
        _sync(dev)
        c1 = _train_counts(platform, cfg, k, "sharded driver")
        saved = r1.pop("state")
        if not is_dtensor(saved["params"]["embed"]["tok"]):
            fail("sharded driver: the state is not on the mesh")
        state, manifest = train.restore_train_state(CheckpointManager(root),
                                                    saved)
        if manifest["step"] != k:
            fail(f"sharded driver: restored step {manifest['step']}")
        leaves = _same_state(state, saved, "sharded driver restore")
        del state, saved
        platform.reset_launches()
        with contextlib.redirect_stdout(sys.stderr):
            r2 = train.main(args + ["--steps", str(n)])
        _sync(dev)
        c2 = _train_counts(platform, cfg, n - k, "resumed sharded driver")
        count = int(r2.pop("state")["opt"]["count"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = r1["losses"] + r2["losses"]
    if (len(r1["losses"]) != k or len(r2["losses"]) != n - k or count != n
            or not np.isfinite(losses).all()):
        fail(f"sharded driver: {len(r1['losses'])} then "
             f"{len(r2['losses'])} losses, step count {count}, finite "
             f"{np.isfinite(losses).all()}")
    out = {"losses": losses, "leaves": leaves,
           "step_ms": [r1["wall_s"] / k * 1e3, r2["wall_s"] / (n - k) * 1e3],
           "slowdown": [r1["slowdown"], r2["slowdown"]],
           "launches": [c1["launches"], c2["launches"]]}
    log(f"sharded driver: {out}")
    _free()
    return out


def _sharded_lm(dev) -> dict:
    """qwen3-4b at full width, ``DIST_LAYERS`` layers, bf16 compute, on
    the (1, 1) mesh under the default rules: ``_mesh_lm`` (a train step,
    a prefill and a decode), ``_mesh_checkpoint`` (its state saved and
    restored) and ``_mesh_engine`` (the engine with the rules)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingRules
    from repro_torch.training import AdamConfig

    cfg = get_config("qwen3-4b").replace(n_layers=DIST_LAYERS)
    params, n_params, _ = _instance(dev, cfg)
    rules = ShardingRules(_one_rank_mesh())
    adam = AdamConfig(lr=TRAIN_LR)
    out = _mesh_lm(dev, cfg, params, n_params, rules, adam,
                   "sharded qwen3-4b")
    out["checkpoint"] = _mesh_checkpoint(dev, cfg, params, rules, adam)
    out["engine"] = _mesh_engine(dev, cfg, params, rules, "sharded qwen3-4b")
    del params
    _free()
    return out


def _sharded_moe(dev) -> dict:
    """The sharded MoE on the (1, 1) mesh, by "model (route)":
    qwen2-moe-a2.7b (``DIST_LAYERS`` layers, full width, bf16 compute,
    ``DIST_MOE_STATE`` Adam moments) under each ``DIST_MOE_ROUTES``
    rules, a train step, a prefill and a decode; Jamba at full width,
    the first ``DIST_JAMBA_LAYERS`` layers of its period, bf16
    parameters, on EP (its 16 experts on the model axis), a prefill, a
    decode and ``_mesh_engine``.  Each route's ``w1`` must be sharded on
    its dim."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingRules
    from repro_torch.training import AdamConfig

    mesh = _one_rank_mesh()
    jamba = get_config("jamba-v0.1-52b")
    jamba = jamba.replace(n_layers=DIST_JAMBA_LAYERS, param_dtype="bfloat16",
                          hybrid=dataclasses.replace(
                              jamba.hybrid, period=DIST_JAMBA_LAYERS))
    out = {}
    for cfg, routes, adam in (
            (get_config("qwen2-moe-a2.7b").replace(n_layers=DIST_LAYERS),
             DIST_MOE_ROUTES,
             AdamConfig(lr=TRAIN_LR, state_dtype=DIST_MOE_STATE)),
            (jamba, {"ep": {}}, None)):
        params, n_params, _ = _instance(dev, cfg)
        for route, over in routes.items():
            label = f"{cfg.name} ({route})"
            r = _mesh_lm(dev, cfg, params, n_params,
                         ShardingRules(mesh).with_overrides(**over), adam,
                         f"sharded {label}")
            if r["w1_shard_dims"] != [{"ep": 0, "tp": 2}[route]]:
                fail(f"sharded {label}: w1 sharded on dims "
                     f"{r['w1_shard_dims']}")
            if cfg is jamba:
                r["engine"] = _mesh_engine(
                    dev, cfg, params,
                    ShardingRules(mesh).with_overrides(**over),
                    f"sharded {label}")
            out[label] = r
        del params
        _free()
    return out


def phase_distribution(dev) -> dict:
    """Probe meshes in the executor, the int8 compressed all-reduce on a
    one-rank NCCL group, and the sharded LM steps and the sharded MoE on
    a (1, 1) mesh of that group (destroyed after)."""
    import tempfile

    import torch.distributed as dist

    probe = _probe_mesh_runs(dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", init_method=f"file://{root}/pg",
                            rank=0, world_size=1)
    try:
        psum = _psum_one_rank(dev)
        lm = _sharded_lm(dev)
        moe = _sharded_moe(dev)
        driver = _mesh_driver(dev)
    finally:
        dist.destroy_process_group()
    return {"probe_mesh": probe, "compressed_psum": psum, "lm": lm,
            "moe": moe, "driver": driver}


def phase_twins(dev) -> dict:
    """Phase 7d: each of ``TWINS`` once on the card, in its own process
    (with this run's kernel build), ``TWIN_PARALLEL`` at a time: exit code
    0 and its seconds; its last line, the launch counts of its run, must
    show no plain version on the card and every kernel of
    ``TWIN_KERNELS`` launched; ``torch_smoke_archs.py`` must pass every
    architecture.  Each twin's output is kept under
    ``chiprun_out/twins/``."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    _free()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)}
    logs = ROOT / "chiprun_out" / "twins"
    logs.mkdir(parents=True, exist_ok=True)

    def run(rel: str):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--twin-child", rel],
                              capture_output=True, text=True, cwd=ROOT,
                              env=env, timeout=TWIN_TIMEOUT_S)
        return rel, proc, time.perf_counter() - t0

    out = {}
    with ThreadPoolExecutor(TWIN_PARALLEL) as pool:
        for rel, proc, seconds in pool.map(run, TWINS):
            (logs / f"{Path(rel).stem}.log").write_text(
                f"{proc.stdout}\n--- stderr ---\n{proc.stderr}")
            log(f"{rel} ({seconds:.1f} s, exit {proc.returncode}):\n"
                f"{proc.stdout[-1500:]}{proc.stderr[-1500:]}")
            if proc.returncode != 0:
                fail(f"{rel} exited {proc.returncode}")
            lines = proc.stdout.strip().splitlines()
            try:
                counts = json.loads(lines[-1])
            except (IndexError, ValueError):
                fail(f"{rel}: its last line is not the launch counts: "
                     f"{lines[-3:]}")
            launched = counts["launches"]
            if counts["plain_on_cuda"]:
                fail(f"{rel}: plain versions ran on the card: "
                     f"{counts['plain_on_cuda']}")
            missing = [k for k in TWIN_KERNELS.get(rel, ())
                       if launched.get(k, 0) <= 0]
            if missing:
                fail(f"{rel}: kernels {missing} not launched: {launched}")
            if rel == "scripts/torch_smoke_archs.py" and (
                    "all architectures smoke-pass" not in lines[-2]
                    or sum(line.startswith("OK ") for line in lines) != 10):
                fail(f"{rel}: {lines[-12:]}")
            tagged = [line for line in proc.stderr.splitlines()
                      if line.startswith(TWIN_EXEC_TAG)]
            if not tagged:
                fail(f"{rel}: no {TWIN_EXEC_TAG!r} line")
            execs = json.loads(tagged[-1][len(TWIN_EXEC_TAG):])
            if "failed" in execs:
                fail(f"{rel}: {execs['failed']}")
            out[rel] = {"seconds": seconds, **counts, "exec": execs}
    return out


# the line a twin's wrapper (--twin-child) ends its stderr with
TWIN_EXEC_TAG = "twin exec: "


def twin_child(rel: str) -> int:
    """``--twin-child REL``: run the twin ``REL`` as ``python REL`` runs it
    (``__main__``, its own argv), with :func:`track_executors` on; then
    :func:`replay_check` since the twin's last reset of the launch counts
    as the last line of stderr (``TWIN_EXEC_TAG`` and JSON; a failed check
    as ``{"failed": ...}``, which phase 7d reports)."""
    import runpy

    sys.path.insert(0, str(SRC))
    track_executors()
    sys.argv = [str(ROOT / rel)]
    try:
        runpy.run_path(str(ROOT / rel), run_name="__main__")
    finally:
        try:
            got = replay_check(rel)
        except SystemExit:  # fail() printed the reason
            got = {"failed": "dispatches and fits on the card not "
                             "answered by replays after one warm-up a "
                             "build"}
        print(TWIN_EXEC_TAG + json.dumps(got), file=sys.stderr, flush=True)
    return 0


def _same_state(got, want, label: str, path: str = "") -> int:
    """``got`` equal to ``want`` bit for bit: the same keys, and each leaf
    of the same dtype, device and shape with equal contents (a DTensor's
    whole tensor), a DTensor leaf in the same placements and a plain leaf
    plain.  Returns the number of leaves."""
    import torch

    from repro_torch.distributed import is_dtensor

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            fail(f"{label}: {path or 'the state'} holds other keys")
        return sum(_same_state(got[k], want[k], label, f"{path}/{k}")
                   for k in want)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            fail(f"{label}: {path} holds {len(got)} items, not {len(want)}")
        return sum(_same_state(g, w, label, f"{path}/{i}")
                   for i, (g, w) in enumerate(zip(got, want)))
    if is_dtensor(got) != is_dtensor(want) or (
            is_dtensor(want) and got.placements != want.placements):
        fail(f"{label}: {path} placed as "
             f"{getattr(got, 'placements', 'a plain tensor')}, saved as "
             f"{getattr(want, 'placements', 'a plain tensor')}")
    if is_dtensor(want):
        got, want = got.full_tensor(), want.full_tensor()
    if (got.dtype != want.dtype or got.device != want.device
            or got.shape != want.shape or not torch.equal(got, want)):
        fail(f"{label}: {path} differs from the saved leaf")
    return 1


def _graph_route(platform, steps: int, label: str) -> None:
    """A driver run's first step eager and every other one replayed."""
    routes = platform.route_counts()
    if (routes.get("train:eager"), routes.get("train:graph")) != (
            1, steps - 1):
        fail(f"{label}: routes {routes}, want the first of {steps} steps "
             f"eager and the others replayed")


def train_driver(dev, arch: str, root) -> dict:
    """``launch.train.main`` at ``arch``'s smoke config on the card for
    ``DRIVER_STEPS[0]`` steps with checkpoints; an ``ElasticController``
    handles a node loss (the planner's ``replan_elastic`` for the full
    config at train_4k, the step rebuilt, the checkpoint restored onto the
    card and held to the saved state bit for bit); then a second ``main``
    resumes to ``DRIVER_STEPS[1]``.  Launch counts per run."""
    import numpy as np

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import platform
    from repro_torch.launch import train
    from repro_torch.planner import replan_elastic
    from repro_torch.runtime import (
        CheckpointManager,
        ElasticController,
        FailureEvent,
    )
    from repro_torch.training import AdamConfig, TrainStepConfig
    from repro_torch.training import make_train_step

    cfg = get_smoke(arch)
    ckpt = root / arch
    args = ["--arch", arch, *DRIVER_ARGS, "--device", "cuda", "--ckpt",
            str(ckpt)]
    platform.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):  # stdout ends in results
        r1 = train.main(args + ["--steps", str(DRIVER_STEPS[0])])
    _sync(dev)
    c1 = _train_counts(platform, cfg, DRIVER_STEPS[0], f"{arch} driver")
    _graph_route(platform, DRIVER_STEPS[0], f"{arch} driver")
    saved = r1.pop("state")

    def replan(chips):
        t0 = time.perf_counter()
        rec = replan_elastic(get_config(arch), "train_4k", chips, device=dev)
        replan_s.append(time.perf_counter() - t0)
        return rec

    def rebuild(rec):
        return make_train_step(cfg, TrainStepConfig(
            adam=AdamConfig(lr=1e-3))), dev

    def restore(device):
        state, manifest = train.restore_train_state(
            CheckpointManager(ckpt), saved)
        restored_step.append(manifest["step"])
        return state

    replan_s, restored_step = [], []
    ctl = ElasticController(total_chips=ELASTIC_CHIPS, replan=replan,
                            rebuild=rebuild, restore=restore)
    _, state = ctl.handle(FailureEvent(DRIVER_STEPS[0], "node_loss", -8))
    if restored_step != [DRIVER_STEPS[0]]:
        fail(f"{arch} driver: restored step {restored_step}")
    _same_state(state, saved, f"{arch} elastic restore")
    rec_chips = ctl.log[-1]["replan_chips"]
    if not rec_chips or rec_chips > ELASTIC_CHIPS - 8:
        fail(f"{arch} driver: the replan took {rec_chips} chips")
    del state, saved
    platform.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        r2 = train.main(args + ["--steps", str(DRIVER_STEPS[1])])
    _sync(dev)
    steps2 = DRIVER_STEPS[1] - DRIVER_STEPS[0]
    c2 = _train_counts(platform, cfg, steps2, f"{arch} resumed driver")
    _graph_route(platform, steps2, f"{arch} resumed driver")
    r2.pop("state")
    if len(r2["losses"]) != steps2 or not np.isfinite(r2["losses"]).all():
        fail(f"{arch} driver: the resumed run gave {len(r2['losses'])} "
             f"losses, finite: {np.isfinite(r2['losses']).all()}")
    losses = r1["losses"] + r2["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first - DRIVER_MARGIN:
        fail(f"{arch} driver: mean loss {first:.3f} over the first 10 steps, "
             f"{last:.3f} over the last 10 (want {DRIVER_MARGIN} lower)")
    out = {"first10": first, "last10": last,
           "step_ms": [r1["wall_s"] / DRIVER_STEPS[0] * 1e3,
                       r2["wall_s"] / steps2 * 1e3],
           "slowdown": [r1["slowdown"], r2["slowdown"]],
           "replan_s": replan_s, "replan_chips": rec_chips,
           "downtime_s": ctl.log[-1]["downtime_s"],
           "launches": [c1["launches"], c2["launches"]]}
    log(f"{arch} driver: {out}")
    _free()
    return out


def phase_lm_training(dev) -> dict:
    """The LM training phase: each mixer kind's model at full width
    (``train_full``), its replays against eager steps at depth 2
    (``train_replay_check``), then the driver with resume at its smoke
    config (``train_driver``)."""
    import shutil
    import tempfile

    full = {arch: train_full(dev, arch) for arch in TRAIN_CUTS}
    replay = {arch: train_replay_check(dev, arch) for arch in REPLAY_CUTS}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        driver = {arch: train_driver(dev, arch, root)
                  for arch in TRAIN_CUTS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"full": full, "replay": replay, "driver": driver}


def _decode_row(timing: dict) -> dict:
    """The decode call's numbers beside a recurrence kernel's prefill ones
    in the kernels line (T = 1 from a state, back to back)."""
    return {"decode_ms": timing["ms"], "decode_plain_ms": timing["plain_ms"],
            "decode_bound_ms": timing["bound_ms"],
            "decode_bound_by": timing["bound_by"]}


def _graph_row(lm: dict, arch: str, kernel: str) -> dict:
    """The device ms a launch of ``kernel`` inside ``arch``'s replayed
    decode graph and its eager 512-token prefill (the serving phase's
    profile), None where the profiler recorded none."""
    prof = lm["models"][arch]["profile"]
    return {key: prof[call]["kernel_ms"].get(kernel, {}).get(
        "device_ms_a_launch") for key, call in (
        ("decode_graph_device_ms", "decode"),
        ("prefill_device_ms", "prefill_512"))}


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

    track_executors()
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
    # phase 2's graph check: each route's program eager against its replay
    cases = graph_cases(dev)
    graphs = phase_graphs(dev, cases)
    mark("graphs")

    # phase 3: the main path, one task (launch counts of this run only)
    platform.reset_launches()
    single = phase_single_task(dev)
    launches = platform.launch_counts()
    routes = {"single_task": platform.route_counts()}
    plain = {"single_task": platform.plain_on_cuda_counts()}
    execs = {"single_task": replay_check("single task")}
    log(f"main-path launches: {launches}; {execs['single_task']}")
    mark("single_task")
    # phase 4: coalesced tenants (counted separately)
    platform.reset_launches()
    tenants = phase_tenants(dev)
    tenant_launches = platform.launch_counts()
    routes["tenants"] = platform.route_counts()
    plain["tenants"] = platform.plain_on_cuda_counts()
    execs["tenants"] = replay_check("tenants")
    log(f"tenant-path launches: {tenant_launches}; {execs['tenants']}")
    mark("tenants")
    # phase 5: the service with DAG jobs (counted separately)
    platform.reset_launches()
    service = phase_service(dev)
    service_launches = platform.launch_counts()
    routes["service"] = platform.route_counts()
    plain["service"] = platform.plain_on_cuda_counts()
    execs["service"] = replay_check("service")
    log(f"service-path launches: {service_launches}; routes: {routes}")
    # the compose kernel's time at a shape of its path: the ETL job's
    # extract x transform_a stage frontiers
    pts = service["dags"]["etl"]["stage_points"]
    c_main = compose_timing(dev, pts["extract"], pts["transform_a"], 2)
    c_big = compose_timing(dev, 4096, 4096, 2, reps=20)
    log(f"compose timing path shape: {c_main}")
    log(f"compose timing 4096x4096: {c_big}")
    mark("service")
    # phase 5d: the paper's comparison (launches counted per method inside)
    comparison = phase_comparison(dev)
    mark("comparison")
    # phase 5e: the execution planner (plan_dag's launches counted inside)
    planner = phase_planner(dev)
    mark("planner")
    # phase 5b: the front desk over a kernel-path service with a vault
    # (counted separately; read after its dispatcher thread stops)
    import tempfile

    vault_root = Path(tempfile.mkdtemp(prefix="chip_smoke_vault_"))
    platform.reset_launches()
    desk = phase_frontdesk(dev, vault_root / "frontiers")
    fd_launches = platform.launch_counts()
    fd_plain = platform.plain_on_cuda_counts()
    execs["frontdesk"] = replay_check("front desk")
    log(f"front-desk launches: {fd_launches}; {execs['frontdesk']}; plain "
        f"versions on the card: {fd_plain}")
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
    execs["vault"] = replay_check("vault")
    if vault_plain:
        fail(f"vault: plain versions ran on the card: {vault_plain}")
    mark("vault")
    # phase 6: the model server (counted separately)
    platform.reset_launches()
    ms = phase_modelserver(dev, vault_root / "models")
    ms_launches = platform.launch_counts()
    ms_plain = platform.plain_on_cuda_counts()
    execs["modelserver"] = replay_check("model server")
    log(f"model-server-path launches: {ms_launches}; "
        f"{execs['modelserver']}; plain versions on the card: {ms_plain}")
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
    graph_device_ms(cases, graphs)
    log(f"device times: pareto {p_times}; compose {c_main}, {c_big}; "
        f"descend {d['device_ms']}; graphs {graphs}")
    del cases
    # phase 3's task on each descend route (profiled, so after phase 6)
    single["by_route"] = single_task_descend(dev)
    drop_graphs()
    mark("device_times")
    # phase 7: LM serving (counted per model inside)
    lm = phase_lm(dev)
    mark("lm_serving")
    # phase 7b: LM training (counted per model and run inside)
    training = phase_lm_training(dev)
    mark("lm_training")
    # phase 7c: distribution (launches counted inside)
    distribution = phase_distribution(dev)
    mark("distribution")
    # phase 7d: the twins of the LM examples and of smoke_archs
    twins = phase_twins(dev)
    mark("twins")

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

    def twin_launches(name: str) -> dict:
        """A kernel's launches by the twins of phase 7d that launched it."""
        return {rel: r["launches"][name] for rel, r in twins.items()
                if r["launches"].get(name, 0)}

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
         "device_ms": d["device_ms"],
         "two_shard_launches": distribution["probe_mesh"][
             "two_shards/group"]["launches"],
         "twin_launches": twin_launches("descend_batch")},
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
         "plain_device_ms": m_gate["plain_device_ms"],
         "twin_launches": twin_launches("mlp_forward")},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_wkv.py:27",
         "launches": lm["launches"]["rwkv6-3b"]["rwkv6_wkv"],
         "max_abs_err": lm["check"]["wkv_err"],
         **{k: lm["timing"]["wkv_prefill"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms", "layout")},
         **_decode_row(lm["timing"]["wkv_decode"]),
         **_graph_row(lm, "rwkv6-3b", "rwkv6_wkv"),
         "training_launches": training["full"]["rwkv6-3b"]["launches"][
             "rwkv6_wkv"],
         "twin_launches": twins["scripts/torch_smoke_archs.py"]["launches"][
             "rwkv6_wkv"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": lm["launches"]["qwen3-4b"]["flash_attention"],
         "max_abs_err": max(lm["check"]["flash_err"].values()),
         **{k: lm["timing"]["flash"]["bfloat16_512"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms")},
         "kernel_route": "wgmma",
         **_graph_row(lm, "qwen3-4b", "flash_attention"),
         "training_launches": training["full"]["qwen3-4b"]["launches"][
             "flash_attention"],
         "mesh_launches": {
             "train_step": distribution["lm"]["train_launches"][
                 "flash_attention"],
             "prefill": distribution["lm"]["launches"]["prefill"][
                 "flash_attention"]},
         "moe_mesh_launches": {
             label: r["launches"]["prefill"]["flash_attention"]
             for label, r in distribution["moe"].items()},
         "engine_rules_launches": distribution["lm"]["engine"]["launches"][
             "flash_attention"],
         "twin_launches": twins["scripts/torch_smoke_archs.py"]["launches"][
             "flash_attention"]},
        {"name": "mamba_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:26",
         "launches": lm["launches"]["jamba-v0.1-52b"]["mamba_scan"],
         "max_abs_err": lm["check"]["scan_err"],
         **{k: lm["timing"]["scan_prefill"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms", "bound_terms_ms")},
         **_decode_row(lm["timing"]["scan_decode"]),
         **_graph_row(lm, "jamba-v0.1-52b", "mamba_scan"),
         "training_launches": training["full"]["jamba-v0.1-52b"][
             "launches"]["mamba_scan"],
         "moe_mesh_launches": {
             call: distribution["moe"]["jamba-v0.1-52b (ep)"]["launches"][
                 call]["mamba_scan"] for call in ("prefill", "decode")},
         "engine_rules_launches": distribution["moe"][
             "jamba-v0.1-52b (ep)"]["engine"]["launches"]["mamba_scan"],
         "twin_launches": twins["scripts/torch_smoke_archs.py"]["launches"][
             "mamba_scan"]},
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
               "comparison": comparison, "planner": planner,
               "frontdesk": desk, "vault": vault,
               "launches": {"single_task": launches,
                            "tenants": tenant_launches,
                            "service": service_launches,
                            "frontdesk": fd_launches,
                            "modelserver": ms_launches},
               "routes": routes, "exec": execs, "graphs": graphs,
               "pareto": p_times, "store_add_ms": store_add,
               "descend": d,
               "compose_path": c_main, "compose_4096": c_big,
               "mlp_check": m_chk, "mlp_gate": m_gate, "mlp_4096": m_big,
               "lm": lm, "training": training,
               "distribution": distribution, "twins": twins,
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
    print(json.dumps({"comparison": {
        label: {n: {k: r[k] for k in ("points", "hv", "seconds",
                                      "first_frontier_s", "launches",
                                      "routes")}
                for n, r in runs.items()}
        for label, runs in (("spark", comparison["spark"]),
                            ("spark_capped", comparison["spark_capped"]))}
        | {"cost_cap": comparison["cost_cap"],
           "ws_routes": comparison["ws_routes"],
           "workloads_hv": {w: {n: r["hv"] for n, r in runs.items()}
                            for w, runs in comparison["workloads"].items()},
           "zdt1": comparison["zdt1"]}}), flush=True)
    print(json.dumps({"planner": {
        "plans": {c: [p["seconds"], p["points"]]
                  for c, p in planner["plans"].items()},
        **{k: planner[k] for k in ("capped", "elastic", "incremental",
                                   "plan_dag", "ingest")}}}), flush=True)
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
                                    "decode_ms_p90",
                                    "decode_replay_ms_median",
                                    "decode_eager_ms_median",
                                    "decode_eager_ms_p90", "decode_bound_ms",
                                    "decode_ops_bound_ms", "prefill_ms",
                                    "peak_mem_gb", "fp32_check_err")},
               "graphs": {k: m["graphs"][k] for k in (
                   "capture_s", "decode_nodes",
                   "pool_bytes", "replay_exact_steps")},
               "idle_share": {k: v["idle_share"]
                              for k, v in m["profile"].items()},
               "kernels_a_decode": {k: v["kernels"]
                                    for k, v in m["profile"].items()}}
        for arch, m in lm["models"].items()}}), flush=True)
    print(json.dumps({"decode_host_us": lm["timing"]["decode_host_us"]}),
          flush=True)
    print(json.dumps({"training": {
        "card": card, "full": {
            arch: {k: m[k] for k in ("layers", "params_b", "route",
                                     "step_ms", "step_ms_all",
                                     "tokens_per_s", "device_ms",
                                     "backward_share", "capture_s",
                                     "nodes", "pool_gb", "payback_steps",
                                     "replay", "peak_mem_gb",
                                     "losses", "grad_norms", "plain_first",
                                     "plain_rel_err")}
            for arch, m in training["full"].items()},
        "replay_check": {arch: {k: r[k] for k in (
            "bit_exact_leaves", "leaves", "control_differs",
            "replay_differs")} for arch, r in training["replay"].items()},
        "driver": {arch: {k: d[k] for k in ("first10", "last10", "step_ms",
                                            "replan_s", "replan_chips")}
                   for arch, d in training["driver"].items()}}}),
        flush=True)
    print(json.dumps({"distribution": {
        "probe_mesh": {k: {f: r[f] for f in ("launches", "max_dx", "max_df",
                                             "sharded_axis", "seconds")}
                       for k, r in distribution["probe_mesh"].items()},
        "compressed_psum": distribution["compressed_psum"],
        **{part: {label: {k: r[k] for k in DIST_SUMMARY if k in r}
                      for label, r in runs.items()}
           for part, runs in (("lm", {"qwen3-4b": distribution["lm"]}),
                              ("moe", distribution["moe"]))}}}),
        flush=True)
    ckpt = distribution["lm"]["checkpoint"]
    print(json.dumps({"checkpoint": {
        "card": card, "model": f"qwen3-4b, {DIST_LAYERS} layers, full width",
        **{k: ckpt[k] for k in ("state_gb", "written_gb", "save_s",
                                "snapshot_s", "sha256_s", "restore_s",
                                "restore_peak_gb", "next_step_rel_err")},
        "sharded_driver": {k: distribution["driver"][k]
                           for k in ("losses", "step_ms")},
        "engine_rules": {
            label: r["engine"] for label, r in (
                ("qwen3-4b", distribution["lm"]),
                ("jamba-v0.1-52b (ep)",
                 distribution["moe"]["jamba-v0.1-52b (ep)"]))}}}),
        flush=True)
    print(json.dumps({"graphs": {"card": card, "cases": graphs,
                                 "exec": execs}}), flush=True)
    print(json.dumps({"twins": twins, "phase_s": phase_s}), flush=True)
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


def phases_main(name: str) -> int:
    """``--phases NAME``: the card line, the build, then only phases 6
    (the model server), 7 (LM serving) and 7b (LM training), each timed on
    the host's clock as ``main`` times them, with their own checks; written
    as ``NAME.json`` beside ``chip_smoke.json``.  An earlier tree's own
    copy of this mode times that tree's phases (its eager train step
    against this tree's graph route, in one call)."""
    sys.path.insert(0, str(SRC))
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = phase_card()
    dev = torch.device("cuda", 0)
    phase_s = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_phases_"))
    try:
        t0 = time.perf_counter()
        ms = phase_modelserver(dev, root / "models")
        phase_s["modelserver"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    lm = phase_lm(dev)
    phase_s["lm_serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    training = phase_lm_training(dev)
    phase_s["lm_training"] = time.perf_counter() - t0
    res = {"card": card, "phase_s": phase_s,
           "modelserver_fit_s": {n: w["fit_s"]
                                 for n, w in ms["workloads"].items()},
           "lm_tokens_per_s": {a: m["tokens_per_s"]
                               for a, m in lm["models"].items()},
           "train_step_ms": {a: m["step_ms"]
                             for a, m in training["full"].items()},
           "train_device_ms": {a: m["device_ms"]
                               for a, m in training["full"].items()},
           "train_full": {a: {k: v for k, v in m.items()
                              if k not in ("launches", "plain_backward")}
                          for a, m in training["full"].items()},
           "train_replay": training.get("replay"),
           "driver_step_ms": {a: d["step_ms"]
                              for a, d in training["driver"].items()}}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(res, indent=1,
                                                 default=str))
    print(json.dumps({name: {"phase_s": phase_s,
                             "train_step_ms": res["train_step_ms"]}},
                     default=str), flush=True)
    return 0


def serve_main(name: str) -> int:
    """``--serve NAME``: the card line, the build, then only phase 7 (LM
    serving, with its checks), timed as ``main`` times it; written as
    ``NAME.json`` beside ``chip_smoke.json``."""
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = phase_card()
    t0 = time.perf_counter()
    lm = phase_lm(torch.device("cuda", 0))
    res = {"card": card, "lm_serving_s": time.perf_counter() - t0,
           "lm": lm}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(res, indent=1,
                                                 default=str))
    print(json.dumps({name: {"lm_serving_s": res["lm_serving_s"]}}),
          flush=True)
    return 0


def train_main(name: str) -> int:
    """``--train NAME``: the card line, the build, then only phase 7b (LM
    training, with its checks), timed as ``main`` times it; written as
    ``NAME.json`` beside ``chip_smoke.json``."""
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = phase_card()
    torch.cuda.init()  # the allocator's statistics exist from here
    t0 = time.perf_counter()
    training = phase_lm_training(torch.device("cuda", 0))
    res = {"card": card, "lm_training_s": time.perf_counter() - t0,
           "training": training}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(res, indent=1,
                                                 default=str))
    print(json.dumps({name: {
        "lm_training_s": res["lm_training_s"],
        "step_ms": {a: m["step_ms"] for a, m in training["full"].items()}}}),
        flush=True)
    return 0


def graphs_main(name: str) -> int:
    """``--graphs NAME``: the card line, the build, then only phase 2's
    graph check with its cases' device times, as ``main`` makes them;
    written as ``NAME.json`` beside ``chip_smoke.json``."""
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    track_executors()
    card = phase_card()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cases = graph_cases(dev)
    graphs = phase_graphs(dev, cases)
    res = {"card": card, "graphs_s": time.perf_counter() - t0}
    graph_device_ms(cases, graphs)
    res["graphs"] = graphs
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({name: res}), flush=True)
    return 0


def twins_main(name: str) -> int:
    """``--twins NAME``: the card line, the build, then only phase 7d (the
    twins, with its checks), timed as ``main`` times it; written as
    ``NAME.json`` beside ``chip_smoke.json``."""
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = phase_card()
    t0 = time.perf_counter()
    twins = phase_twins(torch.device("cuda", 0))
    res = {"card": card, "twins_s": time.perf_counter() - t0,
           "twins": twins}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({name: res}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--twin-child"]:
        sys.exit(twin_child(sys.argv[2]))
    if sys.argv[1:2] == ["--twins"]:
        sys.exit(twins_main(sys.argv[2] if len(sys.argv) > 2 else "twins"))
    if sys.argv[1:2] == ["--serve"]:
        sys.exit(serve_main(sys.argv[2] if len(sys.argv) > 2 else "serve"))
    if sys.argv[1:2] == ["--train"]:
        sys.exit(train_main(sys.argv[2] if len(sys.argv) > 2 else "train"))
    if sys.argv[1:2] == ["--graphs"]:
        sys.exit(graphs_main(sys.argv[2] if len(sys.argv) > 2 else "graphs"))
    if sys.argv[1:2] == ["--timing"]:
        sys.exit(timing_main(sys.argv[2] if len(sys.argv) > 2 else "timing"))
    if sys.argv[1:2] == ["--phases"]:
        sys.exit(phases_main(sys.argv[2] if len(sys.argv) > 2 else "phases"))
    sys.exit(main())
