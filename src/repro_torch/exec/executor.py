"""The unified probe-executor plane (DESIGN.md §10).

Every MOGD dispatch goes through one :class:`ProbeExecutor`.  Programs are
keyed by **structure** — the surrogate program's content token, the
encoder's snap structure, the :class:`~repro_torch.core.mogd.MOGDConfig`
and the padded ``(G, R)`` batch bucket — while everything problem-specific
rides into the program as batched **data**: model parameters, the per-cell
constraint boxes, user value bounds, per-objective uncertainty weights and
the target-objective index.

Consequences:

* Probe cells from tenants with *different* workloads but a shared model
  architecture batch into ONE dispatch — the program is the same, only the
  per-group params differ.
* A model promotion (new weights, same architecture) is a pure params swap.
* A ``backend`` seam routes fusable programs (stacked standardizing-MLP
  surrogates — the paper's workload models) through the fused descend
  kernel (``kernels.mogd_descend``), gated once per structure by a numeric
  parity check against the scan path; GP, closure and uncertainty programs
  keep the scan path, which differentiates the Eq. 4 loss with autograd
  (``torch.func.grad`` under ``torch.func.vmap``).

PyTorch runs eagerly, so a "program" here is a Python closure built once
per structure and bucket; the cache, the build counts and the ``stats()``
telemetry keep the reference's meaning.

A probe mesh (``distributed.ProbeMesh``) splits each padded batch along
its group or row axis across the mesh's devices, as the reference's
``shard_map`` does: each shard runs the same program on its own device
and the results are concatenated (rows are independent descents, no
collectives).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, vmap

from ..distributed.sharding import choose_probe_partition, probe_mesh
from ..kernels.mogd_descend import _adam_update
from ..kernels.platform import resolve_device
from ..kernels.ref import clip


# ---------------------------------------------------------------------------
# Math primitives (paper Eq. 4 + §4.2.1 projected descent)
# ---------------------------------------------------------------------------


def _eq4_loss(f: torch.Tensor, lo, hi, target, penalty: float,
              tie_break_eps: float = 0.0) -> torch.Tensor:
    """Paper Eq. 4 over one objective vector ``f: (k,)``.

    ``target`` is a tensor index (one-hot selection), so one program serves
    every CO target and every box's target rides as per-row data.  The
    clip of the tie term splits its subgradient at a bound as ``jnp.clip``
    does (see ``kernels.ref.clip``)."""
    zero = f.new_zeros(())
    width = torch.maximum(hi - lo, f.new_tensor(1e-12))
    fhat = (f - lo) / width
    onehot = (torch.arange(f.shape[-1], device=f.device) == target).to(
        fhat.dtype)
    ft = torch.sum(fhat * onehot)
    inside_t = torch.logical_and(ft >= 0.0, ft <= 1.0)
    target_term = torch.where(inside_t, ft * ft, zero)
    violated = torch.logical_or(fhat < 0.0, fhat > 1.0)
    viol_term = torch.where(violated, (fhat - 0.5) ** 2 + penalty, zero).sum()
    tie_term = tie_break_eps * torch.sum(
        torch.where(violated, zero, clip(fhat, 0.0, 1.0) ** 2))
    return target_term + viol_term + tie_term


def _bound_penalty(f, ulo, uhi, uscale, penalty: float) -> torch.Tensor:
    """User value-bound penalty; 0 at open (±inf) edges."""
    zero = f.new_zeros(())
    excess = torch.maximum(ulo - f, zero) + torch.maximum(f - uhi, zero)
    return torch.where(excess > 0.0, (excess / uscale) ** 2 + penalty,
                       zero).sum()


def adam_project_descend(loss_fn: Callable, x0: torch.Tensor, cfg) -> torch.Tensor:
    """Multi-step Adam descent with cosine LR decay and projection onto
    ``[0,1]^D`` (§4.2.1), from one start ``x0: (D,)``; the gradient comes
    from autograd (``torch.func.grad``).  Works under ``vmap``."""
    grad_fn = grad(loss_fn)
    x = x0
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    for step in range(cfg.steps):
        t = torch.tensor(step + 1.0, dtype=torch.float32, device=x0.device)
        g = grad_fn(x)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        x, m, v = _adam_update(x, m, v, g, t, cfg)
    return x


# ---------------------------------------------------------------------------
# Bucketing policy — the single source of truth for padded batch shapes
# ---------------------------------------------------------------------------


def bucket(B: int, base: int = 1) -> int:
    """Smallest power-of-two-scaled bucket >= B (floor ``base``)."""
    b = base
    while b < B:
        b *= 2
    return b


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of dict/list/tuple trees of equal shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def pad_rows(tree, n_pad: int, axis: int = 0):
    """Pad every leaf's ``axis`` by replicating slice 0 ``n_pad`` times.

    Leaves may be numpy arrays (padded on the host) or tensors (padded on
    their device).  Pad rows are real (duplicate) problems whose results
    are sliced off before anyone sees them — they never enter a frontier."""
    if n_pad == 0:
        return tree

    def one(a):
        if isinstance(a, torch.Tensor):
            first = a.narrow(axis, 0, 1)
            shape = list(a.shape)
            shape[axis] = n_pad
            return torch.cat([a, first.expand(shape)], dim=axis)
        a = np.asarray(a)
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(0, 1)
        shape = list(a.shape)
        shape[axis] = n_pad
        return np.concatenate(
            [a, np.broadcast_to(a[tuple(idx)], shape)], axis=axis)

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Programs: the (structure, params) split
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParamProgram:
    """A surrogate objective program split into structure and data.

    ``apply(params, x) -> (k,)`` (or a scalar for single-objective building
    blocks) must be a pure function of one point ``x: (D,)`` whose behavior
    is fully determined by ``structure``: the executor builds one program
    per structure token and routes every program with an equal token
    through it, feeding each call's ``params`` tree as batched data.

    ``params`` is a dict/list/tuple tree of tensors (stackable along a new
    leading axis).  ``apply_std`` optionally returns predictive standard
    deviations of the same shape (uncertainty-aware MOGD, §4.2.3).
    """

    apply: Callable
    params: Any
    structure: tuple
    apply_std: Callable | None = None


def closure_program(fn: Callable, token) -> ParamProgram:
    """Wrap an opaque objective closure as a program with empty params.

    Each distinct model content is its own structure, so nothing coalesces
    across tenants."""
    return ParamProgram(
        apply=lambda _p, x: fn(x), params=(), structure=("closure", token))


def orient_program(program: ParamProgram, signs) -> ParamProgram:
    """Flip max-objectives to minimized orientation (TaskSpec.compile).
    Predictive stds are direction-invariant and pass through unchanged."""
    signs = tuple(float(s) for s in np.asarray(signs).reshape(-1))
    if all(s == 1.0 for s in signs):
        return program
    inner = program.apply

    def apply(p, x):
        out = inner(p, x)
        return out.new_tensor(signs) * out

    return dataclasses.replace(
        program, apply=apply, structure=("orient", signs, program.structure))


def stack_programs(programs) -> ParamProgram:
    """k single-output programs -> one ``(k,)``-vector program (one
    regressor per objective)."""
    programs = tuple(programs)
    applies = tuple(p.apply for p in programs)
    params = tuple(p.params for p in programs)
    structure = ("stack", tuple(p.structure for p in programs))

    def apply(ps, x):
        return torch.stack([a(p, x) for a, p in zip(applies, ps)])

    apply_std = None
    if all(p.apply_std is not None for p in programs):
        stds = tuple(p.apply_std for p in programs)

        def apply_std(ps, x):
            return torch.stack([s(p, x) for s, p in zip(stds, ps)])

    return ParamProgram(apply, params, structure, apply_std)


def encoder_structure(encoder) -> tuple:
    """The part of a :class:`~repro_torch.core.problem.SpaceEncoder` that
    the program's ``snap`` depends on: per-knob kind, encoded width, and the
    integer level count."""
    out = []
    for s in encoder.specs:
        if s.kind == "integer":
            out.append(("integer", float(s.high - s.low)))
        elif s.kind == "categorical":
            out.append(("categorical", s.width))
        else:
            out.append((s.kind, 1))
    return tuple(out)


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


# Per-row field count of the rows tuple `_materialize` builds
# (x0s, los, his, ulo, uhi, uscale, alphas, targets).
N_ROW_FIELDS = 8


@dataclasses.dataclass
class ProbeRequest:
    """One caller's span of CO problems, everything-as-data.

    ``x0s: (B, S, D)`` multistart seeds; ``los``/``his: (B, k)`` the PF
    constraint boxes; ``targets: (B,)`` int target-objective indices.
    ``params_b`` optionally pre-batches per-box params (leading B); None
    broadcasts ``program.params`` to every box.  ``bounds`` is ``(ulo, uhi,
    uscale)`` each ``(B, k)`` (None = open edges); ``alphas: (B, k)``
    uncertainty weights (used only when ``use_std``).  Row fields are host
    arrays or tensors; params are tensors."""

    program: ParamProgram
    encoder: Any
    cfg: Any  # MOGDConfig (frozen dataclass — hashable)
    x0s: Any
    los: Any
    his: Any
    targets: Any
    params_b: Any = None
    bounds: Any = None
    alphas: Any = None
    use_std: bool = False


def _host(a, dtype=np.float32) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, dtype=dtype)  # a writable copy


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

_exec_ids = itertools.count()  # per-instance metric label suffix


class ProbeExecutor:
    """Structure-keyed program cache + dispatcher for batched MOGD probes.

    Batches are laid out as ``(G groups, R rows)``: params are per-GROUP
    data (one group per tenant span — rows inside a group share their model
    weights), rows are the individual CO cells.  A per-row-params caller
    simply contributes R=1 groups.

    One instance owns a cache of ``solve`` programs keyed by
    ``(structure, k, S, D, G-bucket, R-bucket)`` plus build-count telemetry
    per bucketless structure key (``compile_counts``).

    ``backend`` selects the descend implementation: ``"auto"`` routes
    stacked-MLP structures through the fused kernel after a one-time
    per-structure parity check against the scan path (everything else
    through the scan path); ``"jnp"`` forces the scan path; ``"fused"``
    requires a fusable structure and skips the parity gate.  ``device`` is
    where every dispatch runs (``None`` means ``cuda``).

    ``mesh="auto"`` (the default) builds a 1-D probe mesh over the CUDA
    devices when there is more than one (and the executor's device is a
    CUDA one), else stays unsharded.  An explicit
    :class:`~repro_torch.distributed.ProbeMesh` pins the devices (one may
    be listed more than once: its shards run in turn); ``mesh=None``
    disables sharding.  The sharded batch axis (groups vs rows) and
    device-divisible bucket sizes come from the partitioning policy
    (``distributed.choose_probe_partition``) applied to the tenant mix.
    Buckets a mesh cannot divide fall back to the unsharded program.
    """

    def __init__(self, mesh="auto", mesh_axis: str | None = None,
                 bucket_fn: Callable[[int], int] = bucket,
                 max_programs: int = 512, backend: str = "auto", obs=None,
                 device=None):
        if backend not in ("auto", "jnp", "fused"):
            raise ValueError(f"backend must be auto|jnp|fused, got "
                             f"{backend!r}")
        self.device = resolve_device(device)
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', None or a mesh, "
                                 f"got {mesh!r}")
            mesh = None
            if self.device.type == "cuda" and torch.cuda.device_count() > 1:
                mesh = probe_mesh()
        self.mesh = mesh
        self.mesh_axis = (
            mesh_axis if mesh_axis is not None
            else (mesh.axis_names[0] if mesh is not None else None))
        self.backend = backend
        self.bucket_fn = bucket_fn
        # LRU bound on built programs: a stream of distinct closure
        # structures must not pin their model closures forever.
        self.max_programs = max_programs
        self._programs: dict[tuple, Callable] = {}
        self._built_buckets: dict[tuple, set[tuple]] = {}
        self._evals: dict[tuple, Callable] = {}
        self._lock = threading.RLock()
        self.compile_counts: dict[tuple, int] = {}
        # structure key -> DescendPlan (fused backend) or None (scan path);
        # populated once per structure by _descend_plan's parity gate
        self._descend_plans: dict[tuple, Any] = {}
        from ..obs import Observability

        self.obs = obs if obs is not None else Observability()
        m = self.obs.metrics
        self._labels = {"executor": f"ex{next(_exec_ids)}"}
        self._c_compiles = m.counter(
            "exec.compiles", self._labels,
            help="solve-program builds (all structures and buckets)")
        self._c_eval_compiles = m.counter("exec.eval_compiles", self._labels)
        self._c_dispatches = m.counter(
            "exec.dispatches", self._labels, help="device dispatches")
        self._c_probes = m.counter(
            "exec.probes", self._labels, help="useful probe rows solved")
        self._c_fused_dispatches = m.counter(
            "exec.fused_dispatches", self._labels)
        self._c_fused_fallbacks = m.counter(
            "exec.fused_fallbacks", self._labels)
        self._c_sharded_dispatches = m.counter(
            "exec.sharded_dispatches", self._labels)
        self.last_shard_axis: str | None = None
        self._c_useful_rows = m.counter("exec.useful_rows", self._labels)
        self._c_padded_rows = m.counter("exec.padded_rows", self._labels)
        self.last_bucket: tuple | None = None
        self.last_fill: float = 1.0

    # int counter surface: views over the registry ------------------------
    @property
    def eval_compiles(self) -> int:
        """Batched-evaluation programs built."""
        return int(self._c_eval_compiles.value)

    @property
    def dispatches(self) -> int:
        """Solve dispatches."""
        return int(self._c_dispatches.value)

    @property
    def probes(self) -> int:
        """Useful probe rows solved."""
        return int(self._c_probes.value)

    @property
    def fused_dispatches(self) -> int:
        """Dispatches that ran the fused descend kernel."""
        return int(self._c_fused_dispatches.value)

    @property
    def fused_fallbacks(self) -> int:
        """Structures the parity gate sent back to the scan path."""
        return int(self._c_fused_fallbacks.value)

    @property
    def sharded_dispatches(self) -> int:
        """Mesh-sharded dispatches."""
        return int(self._c_sharded_dispatches.value)

    @property
    def useful_rows(self) -> int:
        """Rows that belonged to a request."""
        return int(self._c_useful_rows.value)

    @property
    def padded_rows(self) -> int:
        """Rows dispatched, padding included."""
        return int(self._c_padded_rows.value)

    @property
    def dispatch_origins(self) -> dict:
        """Per-origin dispatch counts, read from the labeled
        ``exec.dispatches_by_origin`` counters."""
        out = {}
        for inst in self.obs.metrics.instruments("exec.dispatches_by_origin"):
            if all(inst.labels.get(k) == v for k, v in self._labels.items()):
                out[inst.labels["origin"]] = int(inst.value)
        return out

    # -- telemetry ---------------------------------------------------------
    @property
    def structures_compiled(self) -> int:
        """Distinct (bucketless) structure keys ever built."""
        return len(self.compile_counts)

    @property
    def total_compiles(self) -> int:
        """Total solve-program builds (all structures, all buckets)."""
        return sum(self.compile_counts.values())

    def stats(self) -> dict:
        """Telemetry snapshot (the reference's keys)."""
        return {
            "structures": self.structures_compiled,
            "compiles": self.total_compiles,
            "eval_compiles": self.eval_compiles,
            "dispatches": self.dispatches,
            "probes": self.probes,
            "fused_structures": sum(
                1 for p in self._descend_plans.values() if p is not None),
            "fused_dispatches": self.fused_dispatches,
            "fused_fallbacks": self.fused_fallbacks,
            "sharded_dispatches": self.sharded_dispatches,
            "useful_rows": self.useful_rows,
            "padded_rows": self.padded_rows,
            "fill_ratio": (self.useful_rows / self.padded_rows
                           if self.padded_rows else 1.0),
            "last_bucket": self.last_bucket,
            "dispatch_origins": dict(self.dispatch_origins),
        }

    # -- batcher seam ------------------------------------------------------
    def plan_buckets(self, G: int, R: int) -> tuple[int, int]:
        """The padded ``(G, R)`` bucket a dispatch of this size would run
        at (bucket policy + mesh divisibility; the reuse window needs the
        build history)."""
        want_g = self.bucket_fn(max(1, int(G)))
        R = max(1, int(R))
        want_r = self.bucket_fn(R) if R == 1 else max(4, self.bucket_fn(R))
        n = self._mesh_div()
        if n > 1:
            _, want_g, want_r = choose_probe_partition(n, want_g, want_r)
        return want_g, want_r

    # -- keys --------------------------------------------------------------
    def structure_key(self, program: ParamProgram, encoder, cfg,
                      use_std: bool = False) -> tuple:
        """The coalescing identity: requests with equal structure keys are
        solved by one program (params ride as data).  ``cfg.seed`` only
        feeds each solver's own generator, so it is normalized out."""
        if dataclasses.is_dataclass(cfg):
            cfg = dataclasses.replace(cfg, seed=0)
        return (program.structure, encoder_structure(encoder), cfg,
                bool(use_std))

    def _mesh_div(self) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape[self.mesh_axis])

    def _choose_buckets(self, base_key: tuple, G: int, R: int) -> tuple:
        """(G, R) bucketing with reuse: prefer an already-built bucket pair
        within 4x total padded size of the wanted one over building a new
        program.  Multi-row groups floor the row bucket at 4; single-row
        groups stay exact.  On a multi-device mesh the wanted buckets pass
        through the partitioning policy first.  Returns ``(Gp, Rp,
        axis)``."""
        want_g, want_r = self.plan_buckets(G, R)
        built = self._built_buckets.get(base_key, ())
        reuse = [
            (g, r) for (g, r) in built
            if g >= want_g and r >= want_r
            and g * r <= 4 * want_g * want_r
        ]
        Gp, Rp = (min(reuse, key=lambda t: t[0] * t[1]) if reuse
                  else (want_g, want_r))
        axis = None
        n = self._mesh_div()
        if n > 1:
            # the policy is idempotent on its own output, so the axis a
            # reused bucket was built with is re-derived, never stored
            axis, _, _ = choose_probe_partition(n, Gp, Rp)
            if (axis == "group" and Gp % n) or (axis == "row" and Rp % n):
                axis = None  # reused pre-policy bucket: unsharded fallback
        return Gp, Rp, axis

    # -- fused backend (kernels/mogd_descend) ------------------------------
    def _descend_plan(self, req: ProbeRequest, skey: tuple):
        """Resolve (and cache) the fused-backend plan for one structure.

        ``backend="auto"``: structural selection first (stacked
        standardizing-MLP programs only), then a one-time numeric parity
        gate against the scan path — a structure that fails it falls back to
        the scan path forever (``fused_fallbacks`` counts the rejections).
        An exception while building or launching the kernel propagates: it
        is a fault, not a numeric disagreement.  ``backend="fused"`` skips
        the gate and raises on non-fusable structures."""
        if self.backend == "jnp":
            return None
        if skey in self._descend_plans:
            return self._descend_plans[skey]
        from ..kernels.mogd_descend import plan_from_structure

        plan = plan_from_structure(req.program.structure, use_std=req.use_std)
        if plan is None:
            if self.backend == "fused":
                raise ValueError(
                    "backend='fused' requires a stacked-MLP program "
                    f"structure; got {req.program.structure[0]!r}")
        elif self.backend == "auto":
            tr = self.obs.tracer
            t0 = tr.now()
            ok = self._parity_check(req, plan)
            if tr.enabled:
                tr.record_span("exec.parity_gate", t0, tr.now(), cat="exec",
                               args={"passed": ok})
            if not ok:
                self._c_fused_fallbacks.inc()
                plan = None
        self._descend_plans[skey] = plan
        return plan

    def _parity_check(self, req: ProbeRequest, plan) -> bool:
        """One-time per-structure numeric gate: the fused descent must match
        the scan path's end state within 1e-3 on a small slice of the real
        request (first box, first two starts)."""
        from ..kernels.mogd_descend import descend_batch

        dev = self.device
        f32 = lambda a: torch.as_tensor(_host(a), device=dev)  # noqa: E731
        cfg = req.cfg
        x0 = f32(req.x0s)[:1, :2]  # (1, S', D)
        lo, hi = f32(req.los)[:1], f32(req.his)[:1]
        k = lo.shape[-1]
        if req.bounds is not None:
            ulo, uhi, uscale = (f32(b)[:1] for b in req.bounds)
        else:
            ulo = torch.full((1, k), float("-inf"), device=dev)
            uhi = torch.full((1, k), float("inf"), device=dev)
            uscale = torch.ones((1, k), device=dev)
        target = torch.as_tensor(
            np.asarray(req.targets).reshape(-1)[:1].astype(np.int64),
            device=dev)
        if req.params_b is None:
            params = self._params_to(req.program.params)
            params_g = tree_map(lambda a: a[None], params)
        else:
            params_g = tree_map(lambda a: a[:1],
                                self._params_to(req.params_b))
            params = tree_map(lambda a: a[0], params_g)
        apply = req.program.apply
        penalty, tie_eps = cfg.penalty, cfg.tie_break_eps

        def loss_fn(x):
            f = apply(params, x)
            return (_eq4_loss(f, lo[0], hi[0], target[0], penalty, tie_eps)
                    + _bound_penalty(f, ulo[0], uhi[0], uscale[0], penalty))

        want = vmap(lambda x0_: adam_project_descend(loss_fn, x0_, cfg))(x0[0])
        with torch.no_grad():
            got = descend_batch(
                plan, cfg, params_g, x0[:, None], lo[:, None], hi[:, None],
                ulo[:, None], uhi[:, None], uscale[:, None], target[:, None],
            )[0, 0]
        return bool(torch.max(torch.abs(got - want)) <= 1e-3)

    # -- building ----------------------------------------------------------
    def _build(self, req: ProbeRequest, skey: tuple, plan,
               axis: str | None = None) -> Callable:
        """Build the grouped descend-snap-select program for one structure.

        User bounds always participate with ±inf open edges (``max(-inf -
        f, 0) == 0`` — a no-op for unbounded rows).  Params enter once per
        GROUP, so rows of a group share their weights.

        ``plan`` (a :class:`~repro_torch.kernels.mogd_descend.DescendPlan`,
        or None) selects the descend body: the fused kernel computes the
        whole batch's finals in one launch, the scan path descends by
        autograd.  Snap/score/select are shared — the fused backend changes
        *where* the descent runs, never the semantics.  ``axis`` is the
        partitioning policy's shard axis for this bucket (None: one
        program over the whole batch)."""
        apply = req.program.apply
        apply_std = req.program.apply_std
        use_std = req.use_std
        snap = req.encoder.snap
        cfg = req.cfg
        penalty, tie_eps, feas_tol = cfg.penalty, cfg.tie_break_eps, cfg.feas_tol

        def eff(params, alphas, x):
            f = apply(params, x)
            if use_std:
                f = f + alphas * apply_std(params, x)
            return f

        def loss_row(x, params, lo, hi, ulo, uhi, uscale, alphas, target):
            f = eff(params, alphas, x)
            return (_eq4_loss(f, lo, hi, target, penalty, tie_eps)
                    + _bound_penalty(f, ulo, uhi, uscale, penalty))

        # (G, R, S) nesting: starts share their row's constants, rows of a
        # group share its params
        row_grad = vmap(
            vmap(vmap(grad(loss_row), in_dims=(0,) + (None,) * 8),
                 in_dims=(0, None) + (0,) * 7),
            in_dims=(0,) * 9)
        eff_gRS = vmap(vmap(vmap(eff, in_dims=(None, None, 0)),
                            in_dims=(None, 0, 0)), in_dims=(0, 0, 0))

        def scan_descend(params, x0s, los, his, ulo, uhi, uscale, alphas,
                         targets):
            x = x0s
            m = torch.zeros_like(x0s)
            v = torch.zeros_like(x0s)
            for step in range(cfg.steps):
                t = torch.tensor(step + 1.0, dtype=torch.float32,
                                 device=x0s.device)
                g = row_grad(x, params, los, his, ulo, uhi, uscale, alphas,
                             targets)
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                x, m, v = _adam_update(x, m, v, g, t, cfg)
            return x

        def score(params, finals, los, his, ulo, uhi, uscale, alphas,
                  targets):
            snapped = snap(finals)  # (G, R, S, D)
            fvals = eff_gRS(params, alphas, snapped)  # (G, R, S, k)
            width = torch.clamp_min(his - los, 1e-12)[:, :, None, :]
            fhat = (fvals - los[:, :, None, :]) / width
            feas = torch.all(torch.logical_and(fhat >= -feas_tol,
                                               fhat <= 1.0 + feas_tol), dim=-1)
            tol = feas_tol * uscale
            feas = torch.logical_and(feas, torch.all(torch.logical_and(
                fvals >= (ulo - tol)[:, :, None, :],
                fvals <= (uhi + tol)[:, :, None, :]), dim=-1))
            k = fvals.shape[-1]
            onehot = (targets[..., None] == torch.arange(
                k, device=fvals.device)).to(fvals.dtype)
            ft = torch.sum(fvals * onehot[:, :, None, :], dim=-1)  # (G,R,S)
            sc = torch.where(feas, ft, torch.full_like(ft, float("inf")))
            best = torch.argmin(sc, dim=-1)  # first minimum, as jnp.argmin
            pick = best[:, :, None, None]
            x_best = torch.take_along_dim(snapped, pick, dim=2)[:, :, 0]
            f_best = torch.take_along_dim(fvals, pick, dim=2)[:, :, 0]
            return x_best, f_best, torch.any(feas, dim=-1)

        if plan is None:
            def batched(params, x0s, los, his, ulo, uhi, uscale, alphas,
                        targets):
                finals = scan_descend(params, x0s, los, his, ulo, uhi,
                                      uscale, alphas, targets)
                with torch.no_grad():
                    return score(params, finals, los, his, ulo, uhi, uscale,
                                 alphas, targets)
        else:
            from ..kernels.mogd_descend import descend_batch

            def batched(params, x0s, los, his, ulo, uhi, uscale, alphas,
                        targets):
                # one fused descent over the whole (G, R, S) batch; the
                # shared snap/score runs once, not cfg.steps times
                with torch.no_grad():
                    finals = descend_batch(plan, cfg, params, x0s, los, his,
                                           ulo, uhi, uscale, targets)
                    return score(params, finals, los, his, ulo, uhi, uscale,
                                 alphas, targets)

        if axis is not None:
            batched = self._sharded(batched, axis)
        self.compile_counts[skey] = self.compile_counts.get(skey, 0) + 1
        self._c_compiles.inc()
        return batched

    def _sharded(self, batched: Callable, axis: str) -> Callable:
        """``batched`` split across the mesh's devices: shard ``i`` of the
        group axis (params and rows together) or of the row axis (every
        group's params on every device) runs on ``mesh.devices[i]``, and
        the shards' results are concatenated on the executor's device."""
        devices = self.mesh.devices
        n = len(devices)
        dim = 0 if axis == "group" else 1

        def run(params, *rows):
            outs = []
            for i, dev in enumerate(devices):
                take = lambda a: a.chunk(n, dim)[i].to(dev)  # noqa: E731
                p_i = tree_map(take if axis == "group"
                               else (lambda a: a.to(dev)), params)
                outs.append(batched(p_i, *(take(r) for r in rows)))
            return tuple(torch.cat([o[j].to(self.device) for o in outs],
                                   dim=dim) for j in range(3))

        return run

    # -- assembly ----------------------------------------------------------
    def _params_to(self, params):
        return tree_map(lambda a: torch.as_tensor(
            a, dtype=torch.float32, device=self.device), params)

    def _materialize(self, req: ProbeRequest) -> tuple:
        """One request -> ``(params, rows, n_groups, n_rows)``.

        A shared-params request is ONE group of B rows; a per-row-params
        request is B groups of one row each.  Rows are host arrays."""
        x0s = _host(req.x0s)
        B = int(x0s.shape[0])
        los = _host(req.los)
        his = _host(req.his)
        k = los.shape[-1]
        if req.bounds is not None:
            ulo, uhi, uscale = (np.broadcast_to(_host(b), (B, k))
                                for b in req.bounds)
        else:
            ulo = np.full((B, k), -np.inf, dtype=np.float32)
            uhi = np.full((B, k), np.inf, dtype=np.float32)
            uscale = np.ones((B, k), dtype=np.float32)
        alphas = (np.zeros((B, k), dtype=np.float32) if req.alphas is None
                  else np.broadcast_to(_host(req.alphas), (B, k)))
        targets = _host(req.targets, np.int64).reshape(B)
        rows = (x0s, los, his, ulo, uhi, uscale, alphas, targets)
        if req.params_b is None:
            params = tree_map(lambda a: a[None],
                              self._params_to(req.program.params))
            return params, tuple(r[None] for r in rows), 1, B
        return (self._params_to(req.params_b),
                tuple(r[:, None] for r in rows), B, 1)

    # -- dispatch ----------------------------------------------------------
    def solve_requests(self, requests, origin: str | None = None,
                       parent_span=None) -> tuple:
        """Concatenate the requests' spans into one padded (G, R) batch,
        solve it in a single dispatch, and slice results back per caller.

        Every request must carry the same structure key — the coalescing
        contract.  Returns ``(x: (B, D), f: (B, k), feasible: (B,))`` numpy
        arrays over the concatenated (unpadded) spans, in request order.
        ``origin`` tags the dispatch source in ``dispatch_origins``;
        ``parent_span`` nests the emitted ``exec.compile`` /
        ``exec.dispatch`` spans under the caller's trace."""
        requests = list(requests)
        if not requests:
            raise ValueError("solve_requests needs at least one request")
        r0 = requests[0]
        skey = self.structure_key(r0.program, r0.encoder, r0.cfg, r0.use_std)
        for r in requests[1:]:
            other = self.structure_key(r.program, r.encoder, r.cfg, r.use_std)
            if other != skey:
                raise ValueError(
                    "solve_requests spans mix structure keys — group by "
                    "ProbeExecutor.structure_key before dispatching")
        parts = [self._materialize(r) for r in requests]
        G = sum(p[2] for p in parts)
        R = max(p[3] for p in parts)
        S = int(parts[0][1][0].shape[-2])
        D = int(parts[0][1][0].shape[-1])
        k = int(parts[0][1][1].shape[-1])
        base_key = (skey, k, S, D)
        tr = self.obs.tracer
        with self._lock:
            plan = self._descend_plan(r0, skey)
            Gp, Rp, axis = self._choose_buckets(base_key, G, R)
            key = (*base_key, Gp, Rp)
            fn = self._programs.pop(key, None)  # re-insert as newest (LRU)
            if fn is None:
                tc0 = tr.now()
                fn = self._build(r0, skey, plan, axis)
                if tr.enabled:
                    tr.record_span(
                        "exec.compile", tc0, tr.now(), cat="exec",
                        parent=parent_span,
                        args={"bucket": [Gp, Rp], "structure": str(skey)})
                self._built_buckets.setdefault(base_key, set()).add((Gp, Rp))
            self._programs[key] = fn
            while len(self._programs) > self.max_programs:
                old = next(iter(self._programs))
                self._programs.pop(old)
                built = self._built_buckets.get(old[:-2])
                if built is not None:
                    built.discard(old[-2:])
        # pad each part's rows to Rp and concatenate groups on the host;
        # params concatenate on the device; then pad groups to Gp
        params = tree_map(lambda *ls: torch.cat(ls, dim=0),
                          *[p[0] for p in parts])
        rows = [
            np.concatenate([pad_rows(p[1][i], Rp - p[3], axis=1)
                            for p in parts], axis=0)
            for i in range(N_ROW_FIELDS)
        ]
        if Gp != G:
            params, rows = pad_rows(params, Gp - G), pad_rows(rows, Gp - G)
        rows = [torch.as_tensor(r, dtype=torch.int64 if i == N_ROW_FIELDS - 1
                                else torch.float32, device=self.device)
                for i, r in enumerate(rows)]
        td0 = tr.now()
        x, f, feas = fn(params, *rows)
        x, f, feas = x.cpu().numpy(), f.cpu().numpy(), feas.cpu().numpy()
        if tr.enabled:
            tr.record_span(
                "exec.dispatch", td0, tr.now(), cat="exec",
                parent=parent_span,
                args={"bucket": [Gp, Rp], "origin": origin,
                      "fill": sum(p[2] * p[3] for p in parts) / (Gp * Rp)})
        # slice back: group g contributes its first n_rows rows
        outs_x, outs_f, outs_feas = [], [], []
        g0 = 0
        for _, _, n_groups, n_rows in parts:
            outs_x.append(x[g0: g0 + n_groups, :n_rows].reshape(-1, D))
            outs_f.append(f[g0: g0 + n_groups, :n_rows].reshape(-1, k))
            outs_feas.append(feas[g0: g0 + n_groups, :n_rows].reshape(-1))
            g0 += n_groups
        with self._lock:  # shared executors: keep telemetry exact
            useful = sum(p[2] * p[3] for p in parts)
            self._c_dispatches.inc()
            self._c_probes.inc(useful)
            self._c_useful_rows.inc(useful)
            self._c_padded_rows.inc(Gp * Rp)
            self.last_bucket = (Gp, Rp)
            self.last_fill = useful / (Gp * Rp)
            if origin is not None:
                self.obs.metrics.counter(
                    "exec.dispatches_by_origin",
                    {**self._labels, "origin": origin}).inc()
            if plan is not None:
                self._c_fused_dispatches.inc()
            if axis is not None:
                self._c_sharded_dispatches.inc()
                self.last_shard_axis = axis
        return (np.concatenate(outs_x), np.concatenate(outs_f),
                np.concatenate(outs_feas))

    # -- batched evaluation (bounds estimation, frontier re-seeding) -------
    def eval_batch(self, program: ParamProgram, X) -> torch.Tensor:
        """``(N, D) -> (N, k)`` through the program split: one vmapped
        forward per structure (params shared across rows), on the
        executor's device."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        key = ("eval", program.structure)
        with self._lock:
            fn = self._evals.pop(key, None)  # re-insert as newest (LRU)
            if fn is None:
                fn = vmap(program.apply, in_dims=(None, 0))
                self._c_eval_compiles.inc()
            self._evals[key] = fn
            while len(self._evals) > self.max_programs:
                self._evals.pop(next(iter(self._evals)))
        params = self._params_to(program.params)
        with torch.no_grad():
            if X.shape[0] == 0:
                # evaluate one dummy row for the output width, keep none
                return fn(params, torch.zeros((1, *X.shape[1:]),
                                              device=self.device))[:0]
            return fn(params, X)


# ---------------------------------------------------------------------------
# The default executor of each device: solvers constructed outside a
# service share one dispatch plane per device.
# ---------------------------------------------------------------------------

_DEFAULTS: dict[torch.device, ProbeExecutor] = {}
_DEFAULT_LOCK = threading.Lock()


def default_executor(device=None) -> ProbeExecutor:
    """The shared executor of ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    with _DEFAULT_LOCK:
        ex = _DEFAULTS.get(dev)
        if ex is None:
            ex = _DEFAULTS[dev] = ProbeExecutor(device=dev)
        return ex
