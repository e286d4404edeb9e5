"""Analytic MOO test problems (ZDT1, bi-sphere, DTLZ2, mixed space).

Shared by the tests and the chip smoke run, so every layer exercises the
same synthetic workloads the paper benchmarks against.

``make_*`` return compiled :class:`MOOProblem`\\ s (solver-layer tests);
``*_task`` return the declarative :class:`TaskSpec` front door — each call
builds fresh closures, so they also exercise content-addressed signature
equality.  Every builder takes ``device`` (``None`` means ``cuda``): the
objectives' constants and weights live there.
"""

from __future__ import annotations

import math

import torch

from ..kernels.platform import resolve_device
from .problem import MOOProblem, SpaceEncoder, boolean, categorical, continuous, integer
from .task import Objective, Preference, TaskSpec, UtopiaNearest


def _zdt1_obj(x):
    f1 = x[0]
    g = 1.0 + 9.0 * torch.mean(x[1:])
    # jnp.clip(f1 / g, 1e-12, None): maximum splits a tie's gradient as JAX
    f2 = g * (1.0 - torch.sqrt(torch.maximum(f1 / g, x.new_full((), 1e-12))))
    return torch.stack([f1, f2])


def make_zdt1(d: int = 6, device=None) -> MOOProblem:
    """ZDT1: convex front f2 = 1 - sqrt(f1), attained at x[1:] = 0."""
    specs = [continuous(f"x{i}", 0.0, 1.0) for i in range(d)]

    def obj(x):
        return _zdt1_obj(x)

    return MOOProblem(specs=specs, objectives=obj, k=2, names=("f1", "f2"),
                      device=resolve_device(device))


def make_sphere2(d: int = 4, device=None) -> MOOProblem:
    """Bi-objective sphere: f1=|x-a|^2, f2=|x-b|^2 — front is the segment
    between a and b (classic, smooth, convex)."""
    dev = resolve_device(device)
    specs = [continuous(f"x{i}", 0.0, 1.0) for i in range(d)]
    a = torch.full((d,), 0.25, device=dev)
    b = torch.full((d,), 0.75, device=dev)

    def obj(x):
        return torch.stack([torch.sum((x - a) ** 2), torch.sum((x - b) ** 2)])

    return MOOProblem(specs=specs, objectives=obj, k=2, device=dev)


def make_dtlz2(k: int = 3, d: int = 6, device=None) -> MOOProblem:
    """DTLZ2 with k objectives: front is the unit sphere octant."""
    specs = [continuous(f"x{i}", 0.0, 1.0) for i in range(d)]

    def obj(x):
        g = torch.sum((x[k - 1:] - 0.5) ** 2)
        fs = []
        for i in range(k):
            f = 1.0 + g
            for j in range(k - 1 - i):
                f = f * torch.cos(x[j] * math.pi / 2)
            if i > 0:
                f = f * torch.sin(x[k - 1 - i] * math.pi / 2)
            fs.append(f)
        return torch.stack(fs)

    return MOOProblem(specs=specs, objectives=obj, k=k,
                      device=resolve_device(device))


def zdt1_task(d: int = 6, f2_cap: float | None = None,
              preference: Preference = UtopiaNearest(),
              device=None) -> TaskSpec:
    """ZDT1 as a declarative TaskSpec; ``f2_cap`` declares a hard upper
    bound on f2 (the regression tests' budget cap)."""
    dev = resolve_device(device)
    specs = [continuous(f"x{i}", 0.0, 1.0) for i in range(d)]

    def obj(x):
        return _zdt1_obj(x)

    return TaskSpec(
        knobs=specs,
        objectives=(Objective("f1"),
                    Objective("f2", bound=None if f2_cap is None
                              else (None, f2_cap))),
        model=obj,
        preference=preference,
        name="zdt1",
        device=dev,
    )


def sphere2_task(d: int = 4, preference: Preference = UtopiaNearest(),
                 device=None) -> TaskSpec:
    """The bi-objective sphere as a declarative TaskSpec."""
    dev = resolve_device(device)
    specs = [continuous(f"x{i}", 0.0, 1.0) for i in range(d)]
    a = torch.full((d,), 0.25, device=dev)
    b = torch.full((d,), 0.75, device=dev)

    def obj(x):
        return torch.stack([torch.sum((x - a) ** 2), torch.sum((x - b) ** 2)])

    return TaskSpec(knobs=specs, objectives=("f1", "f2"), model=obj,
                    preference=preference, name="sphere2", device=dev)


def make_mixed_problem(device=None) -> MOOProblem:
    """Mixed continuous/integer/categorical/boolean space with an analytic
    bi-objective; exercises the §4.2 one-hot/rounding machinery."""
    dev = resolve_device(device)
    specs = [
        continuous("c", 0.0, 1.0),
        integer("n", 1, 8),
        categorical("mode", ("slow", "fast", "turbo")),
        boolean("flag"),
    ]
    enc = SpaceEncoder(specs)
    speed = torch.tensor([1.0, 1.6, 2.1], device=dev)

    def obj(x):
        cfg = enc.decode_soft(x)
        n = cfg["n"]
        s = torch.sum(cfg["mode"] * speed)
        lat = 10.0 / (n**0.8 * s) + 0.5 * cfg["c"] + 0.2 * cfg["flag"]
        cost = n * s * (1.0 + 0.3 * cfg["flag"]) + (1.0 - cfg["c"])
        return torch.stack([lat, cost])

    return MOOProblem(specs=specs, objectives=obj, k=2, device=dev)


def mlp_surrogate_task(
    seed: int = 0,
    d: int = 3,
    arch: tuple = (16, 16),
    k: int = 2,
    bound: tuple | None = None,
    y_offset: float = 0.0,
    name: str | None = None,
    device=None,
) -> TaskSpec:
    """A randomly-initialized MLP-backed workload with the executor plane's
    ``(structure_key, params)`` split (DESIGN.md §10).

    Tasks built with different ``seed``s are *distinct workloads sharing one
    model architecture* — the multi-tenant mix the structure-keyed executor
    exists for.  Objective ``j`` is He-initialized from a ``torch.Generator``
    seeded with ``1000 * seed + j`` (other numbers than the reference's JAX
    draws).  ``bound`` declares a hard value bound on the first objective;
    ``y_offset`` shifts the output scale to separate workload families.
    """
    from ..exec import stack_programs
    from ..models.mlp import MLPRegressor, MLPSpec, init_mlp

    dev = resolve_device(device)
    regs = []
    for j in range(k):
        spec = MLPSpec(d, tuple(arch), 1)
        gen = torch.Generator().manual_seed(1000 * seed + j)
        regs.append(MLPRegressor(
            spec=spec, params=init_mlp(gen, spec, device=dev),
            x_mean=torch.zeros(d, device=dev), x_std=torch.ones(d, device=dev),
            y_mean=torch.tensor(float(y_offset), device=dev),
            y_std=torch.tensor(1.0, device=dev), dropout=0.0))
    objectives = tuple(
        Objective(f"f{j}", bound=bound if j == 0 else None)
        for j in range(k))
    return TaskSpec(
        knobs=tuple(continuous(f"x{t}", 0.0, 1.0) for t in range(d)),
        objectives=objectives,
        program=stack_programs([r.as_program() for r in regs]),
        name=name or f"mlp-wl-{seed}",
        device=dev)
