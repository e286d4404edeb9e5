"""Assigned-architecture registry.

``get_config(name)`` -> full :class:`ArchConfig` (exact public-literature
config); ``get_smoke(name)`` -> reduced same-family config for CPU tests.
``input_specs(cfg, shape)`` -> ``meta`` tensors standing in for every
input of the step function of one (arch x shape) cell (the dry-run's).
``runnable(cfg, shape)`` filters the assigned 40 cells to the 32 runnable
ones (long_500k needs sub-quadratic attention).  The config files are the
reference's dataclass literals, unchanged.
"""

from __future__ import annotations

import importlib

import torch

from ..nn.config import SHAPES, ArchConfig, ShapeSpec
from ..nn.model import abstract_cache
from ..nn.model import cache_axes as _cache_axes

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


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors standing in for the step inputs of one cell, with
    the reference's keys, shapes and dtypes.

    train/prefill: {"batch": {...}}
    decode:        {"batch": {...}, "cache": <tree>, "pos": scalar}
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sd(s, d):
        return torch.empty(s, dtype=d, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.embed_input:
            batch = {"embeds": sd((B, S, cfg.d_model), torch.bfloat16),
                     "labels": sd((B, S), i32)}
        else:
            batch = {"tokens": sd((B, S), i32)}
        return {"batch": batch}
    # decode: one new token against a cache of length S
    if cfg.embed_input:
        batch = {"embeds": sd((B, 1, cfg.d_model), torch.bfloat16)}
    else:
        batch = {"tokens": sd((B, 1), i32)}
    return {"batch": batch, "cache": abstract_cache(cfg, B, S),
            "pos": sd((), i32)}


def cache_axes(cfg: ArchConfig, shape: ShapeSpec):
    """Logical-axes tree matching the decode cache in input_specs."""
    return _cache_axes(cfg, shape.global_batch, shape.seq_len)


__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_smoke", "runnable",
           "all_cells", "input_specs", "cache_axes"]
