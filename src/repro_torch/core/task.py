"""Declarative task-objectives API — the system's single front door (§1, §3.1).

The paper's premise is that users hand the optimizer *task objectives* —
performance goals, budgetary caps, preferences — and the system configures
the job.  This module is that user surface:

* :class:`Objective` — one named objective with a direction (``min``/``max``),
  an optional hard value bound ``[F_i^L, F_i^U]`` (paper §3.1's value
  constraints, *enforced* end-to-end: MOGD penalizes violations and the
  frontier store excludes infeasible points), and an optional per-objective
  uncertainty weight ``alpha`` (``F̃_i = E[F_i] + α_i·std[F_i]``, §4.2.3).
* :class:`Preference` policies — typed replacements for the string-keyed
  ``select()`` protocol of §5: :class:`UtopiaNearest`,
  :class:`WeightedUtopiaNearest`, :class:`WorkloadAware`.
* :class:`TaskSpec` — knob specs + objectives + preference, with a stable
  *content-derived* :meth:`TaskSpec.signature` (sha256 of the spec's
  structure and the objective model's code/constants, never ``id()``) and
  :meth:`TaskSpec.compile` as the single :class:`MOOProblem` construction
  path.  Two structurally-equal specs — e.g. a recurring job re-submitted
  with fresh closures — produce equal signatures, so the service's solver
  cache and probe coalescing reuse one compiled solver across submissions.

Lifecycle (DESIGN.md §7)::

    spec = TaskSpec(knobs=..., objectives=(Objective("latency"),
                                           Objective("cost", bound=(0, 10))),
                    model=f, preference=WeightedUtopiaNearest((0.7, 0.3)))
    problem = as_problem(spec)               # compile-or-reuse by signature
    result = ProgressiveFrontier(problem, device=spec.device).run(64)
    idx = spec.preference.pick(result.F, result.utopia, result.nadir)

The port adds one field, ``device``: where the spec's model tensors live
and where its problem is evaluated (``None`` means ``cuda``).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import types
from typing import Callable, Sequence

import numpy as np
import torch

from .problem import MOOProblem, VariableSpec
from .recommend import (
    WorkloadClassWeights,
    utopia_nearest,
    weighted_utopia_nearest,
    workload_aware_wun,
)

_DIRECTIONS = ("min", "max")
_CLASSES = ("low", "medium", "high")


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Objective:
    """One task objective: a name, a direction, and optional constraints.

    ``bound`` is the paper's hard value constraint ``[F_i^L, F_i^U]`` in the
    objective's *natural* orientation (a cost cap is ``(None, 10.0)``);
    either edge may be ``None`` for unbounded.  ``alpha`` weights the
    predictive std in the uncertainty-aware objective ``F̃`` (§4.2.3).
    """

    name: str
    direction: str = "min"
    bound: tuple | None = None  # (low | None, high | None), natural units
    alpha: float = 0.0

    def __post_init__(self):
        """Validate direction, bound and alpha."""
        if self.direction not in _DIRECTIONS:
            raise ValueError(
                f"objective {self.name!r}: direction must be one of "
                f"{_DIRECTIONS}, got {self.direction!r}")
        if self.bound is not None:
            if len(self.bound) != 2:
                raise ValueError(
                    f"objective {self.name!r}: bound must be (low, high)")
            lo, hi = self.bound
            if lo is not None and hi is not None and not float(hi) > float(lo):
                raise ValueError(
                    f"objective {self.name!r}: bound high ({hi}) must exceed "
                    f"low ({lo})")
        if self.alpha < 0.0:
            raise ValueError(
                f"objective {self.name!r}: alpha must be >= 0, got {self.alpha}")

    def minimized_bound(self) -> tuple[float, float]:
        """The bound as ``(lo, hi)`` in *minimized* orientation (max
        objectives are negated upstream), with ``±inf`` for open edges."""
        lo, hi = self.bound if self.bound is not None else (None, None)
        lo = -math.inf if lo is None else float(lo)
        hi = math.inf if hi is None else float(hi)
        if self.direction == "max":
            lo, hi = -hi, -lo
        return lo, hi


# ---------------------------------------------------------------------------
# Preference policies (typed §5 selectors)
# ---------------------------------------------------------------------------


class Preference:
    """A policy that picks one point from a Pareto frontier (§5)."""

    def pick(self, F: np.ndarray, utopia: np.ndarray, nadir: np.ndarray) -> int:
        """Index of the chosen row of ``F: (N, k)``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UtopiaNearest(Preference):
    """UN: Euclidean-nearest to Utopia in normalized objective space."""

    def pick(self, F, utopia, nadir) -> int:
        """Index of the UN point of ``F``."""
        return utopia_nearest(F, utopia, nadir)


@dataclasses.dataclass(frozen=True)
class WeightedUtopiaNearest(Preference):
    """WUN: application weights scale the normalized distances."""

    weights: tuple

    def __post_init__(self):
        """Validate and normalize the weights to floats."""
        w = np.asarray(self.weights, dtype=np.float64)
        if np.any(w < 0.0):
            raise ValueError(f"WUN weights must be >= 0, got {self.weights}")
        if w.sum() <= 0.0:
            raise ValueError(
                f"WUN weights must have positive sum, got {self.weights}")
        object.__setattr__(self, "weights", tuple(float(x) for x in w))

    def pick(self, F, utopia, nadir) -> int:
        """Index of the WUN point of ``F``."""
        return weighted_utopia_nearest(F, utopia, nadir, self.weights)


@dataclasses.dataclass(frozen=True)
class WorkloadAware(Preference):
    """Workload-aware WUN: internal (latency-class) × external weights."""

    weights: tuple
    default_latency_s: float
    internal: WorkloadClassWeights = WorkloadClassWeights()

    def __post_init__(self):
        """Validate the external weights and the default latency."""
        # reuse WUN's validation on the external weights
        WeightedUtopiaNearest(self.weights)
        if self.default_latency_s < 0.0:
            raise ValueError("default_latency_s must be >= 0")

    def pick(self, F, utopia, nadir) -> int:
        """Index of the workload-aware WUN point of ``F``."""
        return workload_aware_wun(F, utopia, nadir, self.weights,
                                  self.default_latency_s, self.internal)


def preference_from_legacy(
    strategy: str,
    weights=None,
    default_latency_s: float | None = None,
) -> Preference:
    """Deprecation shim: the old ``select()`` string protocol -> a policy."""
    s = strategy.lower()
    if s == "un":
        return UtopiaNearest()
    if s == "wun":
        if weights is None:
            raise ValueError("strategy 'wun' requires weights")
        return WeightedUtopiaNearest(tuple(weights))
    if s == "workload":
        if weights is None or default_latency_s is None:
            raise ValueError(
                "strategy 'workload' requires weights and default_latency_s")
        return WorkloadAware(tuple(weights), float(default_latency_s))
    raise ValueError(f"unknown recommendation strategy {strategy!r}")


# ---------------------------------------------------------------------------
# Content fingerprinting (signature without id())
# ---------------------------------------------------------------------------


def _fingerprint(obj, _depth: int = 0, _seen: frozenset = frozenset()) -> str:
    """Stable content fingerprint of the values a task spec can carry.

    Covers the objects that actually appear in objective-model closures —
    scalars, containers, numpy arrays and torch tensors (with their device
    type), torch devices and dtypes, dataclasses (VariableSpec),
    SpaceEncoder, and functions (hashed by bytecode — including *nested*
    code objects — plus constants, closure contents, and the global
    values the code references, so a re-submitted recurring job with a
    fresh-but-identical closure fingerprints equal while any change to a
    nested def or a module-level helper changes the hash).  Unrecognized
    objects raise ``TypeError`` — callers fall back to an explicit
    ``model_id``.
    """
    if _depth > 24:
        raise TypeError("fingerprint recursion too deep")
    if obj is None or obj is Ellipsis or isinstance(
            obj, (bool, int, str, bytes, complex, range)):
        return f"{type(obj).__name__}:{obj!r}"
    if isinstance(obj, float):
        return f"float:{obj.hex() if math.isfinite(obj) else repr(obj)}"
    if isinstance(obj, (tuple, list)):
        inner = ",".join(_fingerprint(v, _depth + 1, _seen) for v in obj)
        return f"{type(obj).__name__}[{inner}]"
    if isinstance(obj, (set, frozenset)):  # e.g. `in {...}` code constants
        inner = ",".join(sorted(
            _fingerprint(v, _depth + 1, _seen) for v in obj))
        return f"{type(obj).__name__}{{{inner}}}"
    if isinstance(obj, dict):
        inner = ",".join(
            f"{_fingerprint(k, _depth + 1, _seen)}="
            f"{_fingerprint(v, _depth + 1, _seen)}"
            for k, v in sorted(obj.items(), key=lambda kv: repr(kv[0])))
        return f"dict{{{inner}}}"
    if isinstance(obj, np.ndarray):
        h = hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest()[:16]
        return f"array:{obj.shape}:{obj.dtype}:{h}"
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
        h = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]
        return f"tensor:{obj.device.type}:{a.shape}:{a.dtype}:{h}"
    if isinstance(obj, (torch.device, torch.dtype)):
        return f"{type(obj).__name__}:{obj}"
    if isinstance(obj, (types.FunctionType, types.LambdaType)):
        return _fn_fingerprint(obj, _depth, _seen)
    if isinstance(obj, functools.partial):
        # partial state lives in func/args/keywords, NOT __dict__ — the
        # generic fallback would hash every partial equal
        return (f"partial:{_fingerprint(obj.func, _depth + 1, _seen)}:"
                f"{_fingerprint(obj.args, _depth + 1, _seen)}:"
                f"{_fingerprint(obj.keywords, _depth + 1, _seen)}")
    if isinstance(obj, types.ModuleType):
        return f"module:{obj.__name__}"
    if isinstance(obj, type):
        return f"class:{obj.__module__}.{obj.__qualname__}"
    if isinstance(obj, types.MethodType):
        return (f"method:{type(obj.__self__).__qualname__}."
                f"{obj.__func__.__name__}:"
                f"{_fingerprint(obj.__self__, _depth + 1, _seen)}")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)}
        return (f"dc:{type(obj).__qualname__}:"
                f"{_fingerprint(fields, _depth + 1, _seen)}")
    # SpaceEncoder (and anything whose identity is its specs)
    specs = getattr(obj, "specs", None)
    if specs is not None and all(isinstance(s, VariableSpec) for s in specs):
        return (f"enc:{type(obj).__qualname__}:"
                f"{_fingerprint(tuple(specs), _depth + 1, _seen)}")
    # Generic objects: identity is class + attribute content.  Two
    # instances with equal content ARE the same task component, so sharing
    # a solver is correct; anything unfingerprintable inside raises.
    state = getattr(obj, "__dict__", None)
    if state is not None:
        try:
            return (f"obj:{type(obj).__qualname__}:"
                    f"{_fingerprint(state, _depth + 1, _seen)}")
        except TypeError:
            pass
    raise TypeError(
        f"cannot content-fingerprint {type(obj).__qualname__}; pass an "
        f"explicit model_id to TaskSpec")


def _code_fingerprint(code: types.CodeType, _depth: int,
                      _seen: frozenset) -> str:
    """Bytecode + names + constants, recursing into nested code objects —
    a changed constant inside a nested ``def`` must change the hash."""
    consts = _fingerprint(tuple(
        _code_fingerprint(c, _depth + 1, _seen)
        if isinstance(c, types.CodeType) else c
        for c in code.co_consts), _depth + 1, _seen)
    h = hashlib.sha256(code.co_code).hexdigest()[:16]
    return f"code:{h}:{code.co_names!r}:{consts}"


def _global_loads(code: types.CodeType, out: set) -> set:
    """Names the code actually resolves as globals (LOAD_GLOBAL), recursing
    into nested code objects.  ``co_names`` alone also lists *attribute*
    names, which must not be resolved against the module namespace — an
    unrelated module global sharing an attribute's name would otherwise
    leak into the fingerprint."""
    import dis

    for ins in dis.get_instructions(code):
        if ins.opname in ("LOAD_GLOBAL", "LOAD_NAME"):
            out.add(ins.argval)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _global_loads(c, out)
    return out


def _fn_fingerprint(fn, _depth: int = 0, _seen: frozenset = frozenset()) -> str:
    if id(fn) in _seen:  # recursive / mutually-recursive globals
        return f"fn-cycle:{fn.__qualname__}"
    _seen = _seen | {id(fn)}
    code = fn.__code__
    parts = [
        f"fn:{fn.__qualname__}",
        _code_fingerprint(code, _depth, _seen),
    ]
    if fn.__defaults__:
        parts.append(_fingerprint(fn.__defaults__, _depth + 1, _seen))
    if fn.__kwdefaults__:
        parts.append(_fingerprint(fn.__kwdefaults__, _depth + 1, _seen))
    if fn.__closure__:
        parts.append(_fingerprint(
            tuple(c.cell_contents for c in fn.__closure__), _depth + 1, _seen))
    # Global referents: a model calling a module-level helper must change
    # signature when the helper's implementation changes.  Builtins and
    # names the code never resolves globally are skipped.
    gparts = []
    for name in sorted(_global_loads(code, set())):
        if name in fn.__globals__:
            gparts.append(
                f"{name}={_fingerprint(fn.__globals__[name], _depth + 1, _seen)}")
    if gparts:
        parts.append("globals{" + ",".join(gparts) + "}")
    return "|".join(parts)


# ---------------------------------------------------------------------------
# TaskSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """A declarative tuning task: knobs + objectives + preference.

    ``model`` maps an encoded point ``x: (D,)`` to the ``(k,)`` objective
    values in each objective's *natural* orientation (max objectives are
    negated by :meth:`compile`); ``model_stds`` optionally returns
    predictive stds of the same shape.  ``model_id`` overrides the
    content fingerprint of the model callables — recurring jobs whose
    models cannot be fingerprinted (exotic callables) should pass a stable
    identifier like ``("tpch", "q7", "v3")``.  ``device`` is where the
    model's tensors live (``None`` means ``cuda``); it is part of the
    signature, so equal specs on two devices never share a problem.
    """

    knobs: tuple  # tuple[VariableSpec, ...]
    objectives: tuple  # tuple[Objective, ...]
    model: Callable | None = None
    model_stds: Callable | None = None
    preference: Preference = UtopiaNearest()
    model_id: object = None
    name: str = "task"
    # Optional (structure, params) split of the model for the probe
    # executor plane (repro_torch.exec): tasks sharing a program
    # structure batch into one compiled MOGD dispatch with this task's
    # params riding as data.  When given, ``model``/``model_stds`` may be
    # omitted (derived from the program).
    program: object = None
    device: object = None

    def __post_init__(self):
        """Validate the spec and derive the model from a program."""
        object.__setattr__(self, "knobs", tuple(self.knobs))
        # derived-ness flags: signature() skips re-fingerprinting model/
        # model_stds when they are mere views of the program (the program
        # part already hashes the same content)
        object.__setattr__(self, "_derived_model", False)
        object.__setattr__(self, "_derived_stds", False)
        if self.model is None:
            if self.program is None:
                raise ValueError(
                    "TaskSpec needs a model (or a repro_torch.exec."
                    "ParamProgram via program=)")
            prog = self.program
            object.__setattr__(
                self, "model", lambda x: prog.apply(prog.params, x))
            object.__setattr__(self, "_derived_model", True)
            if self.model_stds is None and prog.apply_std is not None:
                object.__setattr__(
                    self, "model_stds",
                    lambda x: prog.apply_std(prog.params, x))
                object.__setattr__(self, "_derived_stds", True)
        objs = tuple(
            Objective(o) if isinstance(o, str) else o for o in self.objectives)
        object.__setattr__(self, "objectives", objs)
        if not self.knobs:
            raise ValueError("TaskSpec needs at least one knob")
        if not all(isinstance(s, VariableSpec) for s in self.knobs):
            raise ValueError("knobs must be VariableSpecs "
                             "(use continuous/integer/categorical/boolean)")
        if not objs:
            raise ValueError("TaskSpec needs at least one Objective")
        names = [o.name for o in objs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        if not isinstance(self.preference, Preference):
            raise ValueError(
                "preference must be a Preference policy (UtopiaNearest, "
                "WeightedUtopiaNearest, WorkloadAware) — the string protocol "
                "is deprecated; see preference_from_legacy()")
        wts = getattr(self.preference, "weights", None)
        if wts is not None and len(wts) != len(objs):
            raise ValueError(
                f"preference has {len(wts)} weights for {len(objs)} objectives")
        if self.model_stds is None:
            with_alpha = [o.name for o in objs if o.alpha > 0.0]
            if with_alpha:
                raise ValueError(
                    f"objectives {with_alpha} declare uncertainty alpha > 0 "
                    f"but no model_stds was given — F̃ = E[F] + α·std needs "
                    f"a predictive-std model")

    # -- derived views ------------------------------------------------------
    @property
    def k(self) -> int:
        """Number of objectives."""
        return len(self.objectives)

    @property
    def objective_names(self) -> tuple:
        """Objective names in declaration order."""
        return tuple(o.name for o in self.objectives)

    def bounds_array(self) -> np.ndarray | None:
        """Value constraints ``(k, 2)`` in minimized orientation, or None
        when no objective declares a bound."""
        if all(o.bound is None for o in self.objectives):
            return None
        return np.array([o.minimized_bound() for o in self.objectives],
                        dtype=np.float64)

    def alphas(self) -> np.ndarray | None:
        """Per-objective uncertainty weights, or None when all zero."""
        a = np.array([o.alpha for o in self.objectives], dtype=np.float64)
        return a if np.any(a != 0.0) else None

    # -- signature ----------------------------------------------------------
    def signature(self) -> str:
        """Stable content-derived identity of the *solver-relevant* spec.

        Hashes the knob space, the objective declarations (names,
        directions, bounds, alphas), and the model content (fingerprint or
        explicit ``model_id``).  The preference is deliberately excluded:
        it selects from the frontier after solving, so specs differing only
        in preference share one compiled solver.  Never uses ``id()`` — a
        re-submitted structurally-equal spec hashes equal.
        """
        if self.model_id is not None:
            model_part = f"model_id:{_fingerprint(self.model_id)}"
        elif self.program is not None:
            # params-as-data split: identity is the program structure plus
            # the parameter *content* (array hashes) — a params swap (new
            # weights, same architecture) changes the signature while the
            # executor structure key stays warm.  model/model_stds (either
            # explicitly supplied alongside the program, or derived from
            # it) are fingerprinted too: compile() builds
            # ``problem.objectives`` from self.model, so an explicit model
            # diverging from the program must never collide signatures.
            model_part = "program:" + _fingerprint(
                (self.program.structure, self.program.params,
                 self.program.apply_std is not None))
            if self.model is not None and not self._derived_model:
                model_part += "|model:" + _fingerprint(self.model)
            if self.model_stds is not None and not self._derived_stds:
                model_part += "|stds:" + _fingerprint(self.model_stds)
        else:
            model_part = _fingerprint(self.model)
            if self.model_stds is not None:
                model_part += "|stds:" + _fingerprint(self.model_stds)
        payload = "||".join([
            _fingerprint(self.knobs),
            _fingerprint(self.objectives),
            model_part,
            "device:" + ("cuda" if self.device is None
                         else str(torch.device(self.device))),
        ])
        return hashlib.sha256(payload.encode()).hexdigest()

    # -- compilation --------------------------------------------------------
    def compile(self) -> MOOProblem:
        """The single MOOProblem construction path: orient all objectives
        for minimization, attach enforced value constraints and per-
        objective uncertainty weights, and stamp the problem with this
        spec's signature.  Raises on a CUDA-less host when ``device`` is
        ``None``."""
        from ..kernels.platform import resolve_device

        dev = resolve_device(self.device)
        signs = np.array(
            [1.0 if o.direction == "min" else -1.0 for o in self.objectives])
        model = self.model
        if np.all(signs == 1.0):
            obj_fn = model
        else:
            sj = torch.as_tensor(signs, dtype=torch.float32, device=dev)

            def obj_fn(x):
                return sj * model(x)

        stds = self.model_stds  # stds are direction-invariant
        problem = MOOProblem(
            specs=list(self.knobs),
            objectives=obj_fn,
            k=self.k,
            names=self.objective_names,
            objective_stds=stds,
            value_constraints=self.bounds_array(),
            alphas=self.alphas(),
            device=dev,
        )
        if self.program is not None:
            from ..exec import orient_program

            # oriented program: the executor plane sees minimized
            # objectives, matching ``problem.objectives`` exactly
            problem.program = orient_program(self.program, signs)
        problem.task_spec = self
        problem.signature = self.signature()
        return problem

    # -- convenience --------------------------------------------------------
    @staticmethod
    def from_problem(
        problem: MOOProblem,
        objectives: Sequence | None = None,
        preference: Preference = UtopiaNearest(),
        model_id: object = None,
        name: str = "task",
    ) -> "TaskSpec":
        """Wrap an existing (minimization-oriented) MOOProblem — the
        migration shim for code that still builds problems by hand."""
        if objectives is None:
            if len(problem.names) != problem.k:
                raise ValueError(
                    f"problem declares k={problem.k} but has "
                    f"{len(problem.names)} names; pass explicit objectives")
            vc = problem.value_constraints
            objectives = tuple(
                Objective(n, bound=None if vc is None else tuple(
                    None if not math.isfinite(float(b)) else float(b)
                    for b in vc[i]))
                for i, n in enumerate(problem.names))
        return TaskSpec(
            knobs=tuple(problem.specs),
            objectives=tuple(objectives),
            model=problem.objectives,
            model_stds=problem.objective_stds,
            preference=preference,
            model_id=model_id,
            name=name,
            device=problem.device,
        )


def as_problem(problem_or_spec) -> MOOProblem:
    """Accept either a compiled MOOProblem or a TaskSpec (compiling it).

    Compiled problems are cached by signature so repeated calls (e.g. PF
    and the baselines sweeping the same spec) reuse one problem and its
    solver cache; the cache is LRU-bounded so a stream of distinct
    specs cannot pin compiled closures forever."""
    if isinstance(problem_or_spec, TaskSpec):
        sig = problem_or_spec.signature()
        cached = _COMPILE_CACHE.pop(sig, None)  # re-insert as newest
        if cached is None:
            cached = problem_or_spec.compile()
        _COMPILE_CACHE[sig] = cached
        while len(_COMPILE_CACHE) > _COMPILE_CACHE_MAX:
            _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))
        return cached
    return problem_or_spec


# Signature-keyed compile cache (module-level so WS/NC/Evo/solve_pf calls
# over equal specs share one MOOProblem and hence one MOGD solver cache).
_COMPILE_CACHE: dict[str, MOOProblem] = {}
_COMPILE_CACHE_MAX = 256
