"""MOO problem abstraction (paper §3.1, Problem 3.1).

A :class:`MOOProblem` bundles

* a mixed-type configuration space ``Σ`` described by :class:`VariableSpec`s
  (continuous / integer / categorical / boolean knobs — the paper's Spark
  parameters),
* ``k`` objective functions ``F_i(x) = Ψ_i(x)`` given as differentiable
  PyTorch callables over the *encoded* space (one-hot + [0,1] normalization
  per paper §4.2), one point ``(D,) -> (k,)`` at a time (batched with
  ``torch.func.vmap``), optionally with predictive-std callables for
  uncertainty-aware optimization (§4.2.3),
* optional hard value constraints ``[F_i^L, F_i^U]`` on each objective,
* the device its objective tensors live on (``None`` means ``cuda``).

Encoding follows the paper exactly: categorical variables become one-hot
blocks, integers are normalized then relaxed to [0,1], continuous variables
are min-max normalized.  ``decode`` rounds/argmaxes back to the raw space.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import vmap

from ..kernels.graphs import RowGraphs
from ..kernels.platform import resolve_device


def to_numpy(a, dtype=None) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype=dtype)


# ---------------------------------------------------------------------------
# Variable specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VariableSpec:
    """One knob of the configuration space."""

    name: str
    kind: str  # "continuous" | "integer" | "categorical" | "boolean"
    low: float = 0.0
    high: float = 1.0
    choices: tuple = ()  # categorical only

    def __post_init__(self):
        """Validate the knob's kind, choices and range."""
        if self.kind not in ("continuous", "integer", "categorical", "boolean"):
            raise ValueError(f"unknown variable kind {self.kind!r}")
        if self.kind == "categorical" and len(self.choices) < 2:
            raise ValueError(f"categorical variable {self.name} needs >=2 choices")
        if self.kind in ("continuous", "integer") and not self.high > self.low:
            raise ValueError(f"variable {self.name}: high must exceed low")

    @property
    def width(self) -> int:
        """Number of encoded dimensions this variable occupies."""
        if self.kind == "categorical":
            return len(self.choices)
        return 1


def continuous(name: str, low: float, high: float) -> VariableSpec:
    """A continuous knob on ``[low, high]``."""
    return VariableSpec(name, "continuous", low=low, high=high)


def integer(name: str, low: int, high: int) -> VariableSpec:
    """An integer knob on ``[low, high]``."""
    return VariableSpec(name, "integer", low=float(low), high=float(high))


def categorical(name: str, choices: Sequence) -> VariableSpec:
    """A categorical knob over ``choices`` (one-hot encoded)."""
    return VariableSpec(name, "categorical", choices=tuple(choices))


def boolean(name: str) -> VariableSpec:
    """A boolean knob."""
    return VariableSpec(name, "boolean", low=0.0, high=1.0)


# ---------------------------------------------------------------------------
# Encoder: raw mixed space  <->  [0,1]^D relaxed space  (paper §4.2 step 1)
# ---------------------------------------------------------------------------


class SpaceEncoder:
    """Encodes a list of VariableSpecs into a flat [0,1]^D box."""

    def __init__(self, specs: Sequence[VariableSpec]):
        self.specs = tuple(specs)
        self.dim = sum(s.width for s in self.specs)
        offs, o = [], 0
        for s in self.specs:
            offs.append(o)
            o += s.width
        self._offsets = tuple(offs)

    # -- decoding: relaxed vector -> dict of raw knob values ---------------
    def decode(self, x) -> dict:
        """Relaxed vector ``(D,)`` -> raw knob dict (rounded / argmaxed)."""
        x = to_numpy(x)
        out = {}
        for spec, off in zip(self.specs, self._offsets):
            block = x[off : off + spec.width]
            if spec.kind == "categorical":
                out[spec.name] = spec.choices[int(np.argmax(block))]
            elif spec.kind == "boolean":
                out[spec.name] = bool(block[0] >= 0.5)
            elif spec.kind == "integer":
                v = spec.low + float(block[0]) * (spec.high - spec.low)
                out[spec.name] = int(np.clip(round(v), spec.low, spec.high))
            else:
                out[spec.name] = spec.low + float(block[0]) * (spec.high - spec.low)
        return out

    # -- encoding: dict of raw values -> relaxed vector --------------------
    def encode(self, cfg: dict) -> np.ndarray:
        """Raw knob dict -> relaxed vector; validates the configuration.

        Unknown knob names, missing knobs, categorical values outside the
        declared choices, and numeric values outside ``[low, high]`` all
        raise ``ValueError`` — a mistyped or stale configuration must fail
        loudly, not silently encode to garbage."""
        known = {s.name for s in self.specs}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(
                f"unknown knob(s) {sorted(unknown)}; valid knobs: "
                f"{sorted(known)}")
        missing = known - set(cfg)
        if missing:
            raise ValueError(f"missing knob value(s) {sorted(missing)}")
        x = np.zeros(self.dim, dtype=np.float64)
        for spec, off in zip(self.specs, self._offsets):
            v = cfg[spec.name]
            if spec.kind == "categorical":
                if v not in spec.choices:
                    raise ValueError(
                        f"knob {spec.name!r}: value {v!r} not in choices "
                        f"{spec.choices}")
                x[off + spec.choices.index(v)] = 1.0
            elif spec.kind == "boolean":
                x[off] = 1.0 if v else 0.0
            else:
                try:
                    fv = float(v)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"knob {spec.name!r}: expected a number, got {v!r}"
                    ) from None
                tol = 1e-9 * (spec.high - spec.low)
                if not (spec.low - tol <= fv <= spec.high + tol):
                    raise ValueError(
                        f"knob {spec.name!r}: value {fv} outside "
                        f"[{spec.low}, {spec.high}]")
                x[off] = (fv - spec.low) / (spec.high - spec.low)
        return x

    def decode_soft(self, x: torch.Tensor) -> dict:
        """Differentiable decode over the last axis of ``x``.

        Continuous/integer knobs return their de-normalized (unrounded)
        value; boolean returns the raw [0,1] relaxation; categorical returns
        the one-hot block *normalized to a convex combination* (soft weights
        summing to 1), so gradient descent cannot saturate every dummy
        variable.  Ground-truth objective models consume this so MOGD can
        differentiate through knob semantics (paper §4.2 relaxation)."""
        out = {}
        for spec, off in zip(self.specs, self._offsets):
            block = x[..., off : off + spec.width]
            if spec.kind == "categorical":
                out[spec.name] = block / (
                    torch.sum(block, dim=-1, keepdim=True) + 1e-9)
            elif spec.kind == "boolean":
                out[spec.name] = block[..., 0]
            else:
                out[spec.name] = spec.low + block[..., 0] * (spec.high - spec.low)
        return out

    def snap(self, x: torch.Tensor) -> torch.Tensor:
        """Project relaxed points onto the feasible (rounded) manifold,
        staying inside [0,1]^D (last axis; any leading batch shape).  Used
        to report *realizable* objective values for integer/categorical
        knobs (paper §4.2: "round the solution returned for a normalized
        integer variable")."""
        parts = []
        for spec, off in zip(self.specs, self._offsets):
            block = x[..., off : off + spec.width]
            if spec.kind == "categorical":
                # the argmax's one-hot by a comparison made on the
                # device (F.one_hot reads its classes back to check them)
                best = torch.argmax(block, dim=-1, keepdim=True)
                parts.append((best == torch.arange(
                    spec.width, device=block.device)).to(block.dtype))
            elif spec.kind == "boolean":
                parts.append(torch.round(block))
            elif spec.kind == "integer":
                n = spec.high - spec.low
                parts.append(torch.round(block * n) / max(n, 1.0))
            else:
                parts.append(block)
        return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Hard value bounds ([F_i^L, F_i^U], ±inf = open edge): shared feasibility
# semantics.  MOGD's solve-time mask, the frontier store's mark-and-exclude
# and the baselines' filter all derive their tolerance from the SAME
# per-objective scale, so a point near a cap is judged identically.
# ---------------------------------------------------------------------------


def bound_scales(vc: np.ndarray) -> np.ndarray:
    """Per-objective tolerance scale for value constraints ``vc: (k, 2)``:
    the bound width where both edges are finite, else the magnitude of the
    single finite edge (min 1), else 1 for fully-open rows."""
    vc = np.asarray(vc, dtype=np.float64).reshape(-1, 2)
    lo, hi = vc[:, 0], vc[:, 1]
    both = np.isfinite(lo) & np.isfinite(hi)
    edge = np.where(np.isfinite(lo), np.abs(lo), np.abs(hi))
    edge = np.nan_to_num(edge, posinf=1.0, neginf=1.0)
    width = np.where(both, hi - lo, 1.0)  # finite where selected
    return np.maximum(np.where(both, width, np.maximum(edge, 1.0)), 1e-12)


def feasible_mask(vc: np.ndarray, F: np.ndarray,
                  tol: float = 1e-6) -> np.ndarray:
    """Boolean mask of rows of ``F: (N, k)`` within the value constraints
    (with relative slack ``tol`` per :func:`bound_scales`)."""
    vc = np.asarray(vc, dtype=np.float64).reshape(-1, 2)
    eps = tol * bound_scales(vc)
    F = to_numpy(F, np.float64)
    return np.all((F >= vc[:, 0] - eps) & (F <= vc[:, 1] + eps), axis=-1)


# ---------------------------------------------------------------------------
# MOO problem
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MOOProblem:
    """k-objective minimization problem over an encoded [0,1]^D box.

    ``objectives`` maps an encoded point ``x: (D,)`` to ``(k,)`` objective
    values (all to be minimized; flip signs upstream for maximization, per
    paper §3.1).  ``objective_stds`` optionally returns predictive standard
    deviations of the same shape for uncertainty-aware solving
    (``F̃ = E[F] + α·std[F]``, paper §4.2.3).  ``device`` is where the
    objectives' tensors live and where the problem is evaluated (``None``
    means ``cuda``; see ``kernels.platform.resolve_device``).
    """

    specs: Sequence[VariableSpec]
    objectives: Callable[[torch.Tensor], torch.Tensor]
    k: int
    names: tuple = ()
    objective_stds: Callable[[torch.Tensor], torch.Tensor] | None = None
    # Optional user value constraints per objective (paper: [F_i^L, F_i^U]),
    # rows (lo, hi) in minimized orientation; ±inf marks an open edge.
    value_constraints: np.ndarray | None = None  # (k, 2) or None
    # Per-objective uncertainty weights (TaskSpec's Objective.alpha).  When
    # set they take precedence over the scalar alpha a solver config passes.
    alphas: np.ndarray | None = None  # (k,) or None
    device: object = None

    def __post_init__(self):
        """Resolve the device and build the encoder and batched objective."""
        self.device = resolve_device(self.device)
        self.encoder = SpaceEncoder(self.specs)
        if not self.names:
            self.names = tuple(f"F{i+1}" for i in range(self.k))
        self._batch_fn = vmap(self.objectives)
        # on the card: a CUDA graph a row bucket from its second call on
        self._batch_rows = RowGraphs(
            self._batch_fn, f"the batch function of problem {self.names!r}")

    @property
    def dim(self) -> int:
        """Encoded dimension D."""
        return self.encoder.dim

    def effective_objectives(self, alpha: float = 0.0) -> Callable:
        """Mean + alpha * std objective vector function (paper Eq. for F̃).

        ``alpha`` may be a scalar (legacy MOGDConfig.alpha) or a (k,)
        vector; a spec-declared ``self.alphas`` vector overrides it."""
        a = self.alphas if self.alphas is not None else alpha
        if self.objective_stds is None or not np.any(np.asarray(a) != 0.0):
            return self.objectives
        mean_fn, std_fn = self.objectives, self.objective_stds
        av = (torch.as_tensor(np.asarray(a), dtype=torch.float32,
                              device=self.device)
              if np.ndim(a) else float(a))

        def fn(x):
            return mean_fn(x) + av * std_fn(x)

        return fn

    def evaluate_batch(self, X) -> torch.Tensor:
        """(N, D) -> (N, k) objective values on the problem's device.

        Problems carrying a ``(structure, params)`` program (stamped by
        ``TaskSpec.compile``) evaluate through the device's default
        executor, so equal-architecture workloads share one batched
        forward; others vmap their objective callable.  On the card both
        pad the rows to a bucket and replay a CUDA graph a bucket from its
        second call on (``kernels.graphs.RowGraphs``)."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        prog = getattr(self, "program", None)
        if prog is not None:
            from ..exec import default_executor

            return default_executor(self.device).eval_batch(prog, X)
        if X.shape[0] == 0:
            return torch.zeros((0, self.k), dtype=X.dtype, device=X.device)
        return self._batch_rows(X)

    def decode_batch(self, X) -> list[dict]:
        """Decode every row of ``X: (N, D)``."""
        X = to_numpy(X)
        return [self.encoder.decode(x) for x in X]

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Uniform random encoded points (multi-start seeds, Evo init),
        drawn from ``generator`` on the host and moved to the device."""
        return torch.rand((n, self.dim), generator=generator).to(self.device)

    def solver_for(self, mogd_config, device=None):
        """Per-problem MOGD solver cache: PF, WS and NC all reuse the same
        solver (the recurring-job amortization the paper assumes).
        ``device`` is resolved like every entry point's and must be the
        problem's own."""
        dev = resolve_device(device)
        if dev != self.device:
            raise ValueError(f"problem lives on {self.device}, solver asked "
                             f"for {dev}")
        if not hasattr(self, "_solver_cache"):
            self._solver_cache = {}
        if mogd_config not in self._solver_cache:
            from .mogd import MOGDSolver

            self._solver_cache[mogd_config] = MOGDSolver(self, mogd_config,
                                                         device=dev)
        return self._solver_cache[mogd_config]
