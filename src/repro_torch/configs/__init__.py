"""Assigned-architecture registry.

``get_config(name)`` -> full :class:`ArchConfig` (exact public-literature
config); ``get_smoke(name)`` -> reduced same-family config for CPU tests.
``runnable(cfg, shape)`` filters the assigned 40 cells to the 32 runnable
ones (long_500k needs sub-quadratic attention).  The config files are the
reference's dataclass literals, unchanged.
"""

from __future__ import annotations

import importlib

from ..nn.config import SHAPES, ArchConfig, ShapeSpec

ARCH_IDS = (
    "internvl2-76b",
    "qwen3-4b",
    "mistral-nemo-12b",
    "internlm2-20b",
    "codeqwen1.5-7b",
    "qwen2-moe-a2.7b",
    "grok-1-314b",
    "musicgen-medium",
    "rwkv6-3b",
    "jamba-v0.1-52b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; know {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).full()


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def runnable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k requires sub-quadratic attention (SSM / hybrid)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name) for the assigned 40 cells (32 runnable)."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if include_skipped or runnable(cfg, s):
                yield a, s.name


__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_smoke", "runnable",
           "all_cells"]
