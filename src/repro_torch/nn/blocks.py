"""Decoder blocks and the loop over layers.

Three block kinds cover all ten architectures, as in the reference:

* ``attn``  — pre-norm GQA attention + (MLP | MoE)        [dense/moe/vlm/audio]
* ``rwkv``  — RWKV-6 time mix + channel mix               [ssm]
* hybrid superblock — Jamba's 8-layer repeating pattern
  (Mamba ×7 + attention ×1, MoE every other layer)        [hybrid]

Parameters and caches are lists over scan units (``scan_length(cfg)`` of
them), each a dict ``{"l0": ..., }`` over the unit's layer plan — the
reference's stacked leaves, one list entry per leading index
(``nn.convert`` maps one onto the other).  A plain Python loop over the
units replaces ``lax.scan``; remat belongs to training.  The logical-axes
trees (``model.param_axes``, ``blocks_cache_axes``) have the same layout,
each leaf's axes without the reference's leading ``"layers"``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..distributed import constrain
from .attention import attention, attn_init, decode_attention, init_layer_cache
from .config import ArchConfig
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init
from .mamba import mamba, mamba_init
from .moe import moe, moe_init
from .rwkv import (
    rwkv_channel_mix,
    rwkv_channel_mix_init,
    rwkv_time_mix,
    rwkv_time_mix_init,
)


# ---------------------------------------------------------------------------
# Layer plans: which (mixer, ffn) each layer uses
# ---------------------------------------------------------------------------


def layer_plan(cfg: ArchConfig) -> list[tuple[str, str]]:
    """Per-layer (mixer, ffn) within one scan unit.

    Uniform families return a single-entry plan (n_layers units); hybrid
    returns ``period`` entries (n_layers // period units).
    """
    if cfg.family == "ssm":
        return [("rwkv", "rwkv_cm")]
    if cfg.hybrid is not None:
        h = cfg.hybrid
        plan = []
        for i in range(h.period):
            mixer = "attn" if i % h.period == h.attn_index else "mamba"
            ffn = "moe" if (cfg.moe and i % h.moe_period == h.moe_offset) else "mlp"
            plan.append((mixer, ffn))
        return plan
    ffn = "moe" if cfg.moe is not None else "mlp"
    return [("attn", ffn)]


def scan_length(cfg: ArchConfig) -> int:
    n_unit = len(layer_plan(cfg))
    if cfg.n_layers % n_unit:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not tile a "
                         f"plan of {n_unit}")
    return cfg.n_layers // n_unit


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: ArchConfig, mixer: str,
                ffn: str) -> dict:
    dt = cfg.pdtype()
    p: dict[str, Any] = {"norm1": rmsnorm_init(gen, cfg.d_model, dt)}
    if mixer == "attn":
        p["attn"] = attn_init(gen, cfg)
    elif mixer == "mamba":
        p["mamba"] = mamba_init(gen, cfg, cfg.hybrid.mamba)
    elif mixer == "rwkv":
        p["time_mix"] = rwkv_time_mix_init(gen, cfg, cfg.rwkv)
    else:
        raise ValueError(mixer)
    p["norm2"] = rmsnorm_init(gen, cfg.d_model, dt)
    if ffn == "mlp":
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt)
    elif ffn == "moe":
        p["moe"] = moe_init(gen, cfg, cfg.moe)
    elif ffn == "rwkv_cm":
        p["channel_mix"] = rwkv_channel_mix_init(gen, cfg)
    else:
        raise ValueError(ffn)
    return p


def _layer_cache_init(cfg: ArchConfig, mixer: str, ffn: str, batch: int,
                      max_seq: int, make) -> dict:
    """Per-layer decode cache, each leaf ``make(shape, dtype, axes)``."""
    extra = {}
    if ffn == "moe":
        # per-expert loads of the current dispatch chunk: incremental decode
        # reproduces the full pass's capacity drops (see nn/moe.py)
        extra["moe_counts"] = make((batch, cfg.moe.num_experts),
                                   torch.int32, ("batch", None))
    if mixer == "attn":
        return {**init_layer_cache(cfg, batch, max_seq, make), **extra}
    if mixer == "mamba":
        m = cfg.hybrid.mamba
        din = m.expand * cfg.d_model
        return {"h": make((batch, din, m.d_state), torch.float32,
                          ("batch", "d_inner", "d_state")),
                "conv": make((batch, m.d_conv - 1, din), cfg.cdtype(),
                             ("batch", None, "d_inner")),
                **extra}
    if mixer == "rwkv":
        r = cfg.rwkv
        H, dh = cfg.d_model // r.head_size, r.head_size
        row = ("batch", None)
        return {"S": make((batch, H, dh, dh), torch.float32,
                          ("batch", "rwkv_heads", None, None)),
                "x_tm": make((batch, cfg.d_model), cfg.cdtype(), row),
                "x_cm": make((batch, cfg.d_model), cfg.cdtype(), row),
                **extra}
    raise ValueError(mixer)


def _apply_mixer(p, cfg: ArchConfig, mixer: str, x, rules, mode, cache, pos,
                 max_seq):
    """Returns (y, new_cache)."""
    if mixer == "attn":
        if mode == "decode":
            return decode_attention(p["attn"], cfg, x, cache, pos, rules)
        if mode == "prefill":
            y, (k, v) = attention(p["attn"], cfg, x, rules, return_kv=True,
                                  max_seq=max_seq)
            return y, {"k": k, "v": v}
        return attention(p["attn"], cfg, x, rules), None
    if mixer == "mamba":
        st = (cache["h"], cache["conv"]) if cache is not None else None
        y, (h, conv) = mamba(p["mamba"], cfg, cfg.hybrid.mamba, x, st, rules)
        new = {"h": h, "conv": conv} if mode != "train" else None
        return y, new
    if mixer == "rwkv":
        st = (cache["S"], cache["x_tm"]) if cache is not None else None
        y, (S, x_tm) = rwkv_time_mix(p["time_mix"], cfg, cfg.rwkv, x, st,
                                     rules)
        new = {"S": S, "x_tm": x_tm} if mode != "train" else None
        return y, new
    raise ValueError(mixer)


def _apply_ffn(p, cfg: ArchConfig, ffn: str, x, rules, mode, cache, pos):
    """Returns (y, extra_cache_updates or {})."""
    if ffn == "mlp":
        return mlp(p["mlp"], x, cfg.activation, rules), {}
    if ffn == "moe":
        if mode == "train":
            return moe(p["moe"], cfg, cfg.moe, x, rules), {}
        counts = (cache.get("moe_counts")
                  if mode == "decode" and cache is not None else None)
        y, new_counts = moe(p["moe"], cfg, cfg.moe, x, rules, counts=counts,
                            pos=pos, return_counts=True)
        return y, {"moe_counts": new_counts}
    if ffn == "rwkv_cm":
        prev = cache.get("x_cm") if cache is not None else None
        y, x_cm = rwkv_channel_mix(p["channel_mix"], cfg, x, prev, rules)
        return y, ({"x_cm": x_cm} if mode != "train" else {})
    raise ValueError(ffn)


def layer_apply(p, cfg: ArchConfig, mixer: str, ffn: str, x, mode, cache,
                pos, max_seq, rules=None):
    """One pre-norm residual layer. Returns (x', new_cache).

    With rules, each branch's output is laid out as the residual stream
    (``"batch", None, "embed"``) before it is added: a row-parallel
    product's partial sums are reduced there, and the stream never drifts
    into another layout."""
    h, new_cache = _apply_mixer(
        p, cfg, mixer, rmsnorm(p["norm1"], x, cfg.norm_eps), rules, mode,
        cache, pos, max_seq)
    x = x + constrain(h, rules, "batch", None, "embed")
    h, cm_cache = _apply_ffn(
        p, cfg, ffn, rmsnorm(p["norm2"], x, cfg.norm_eps), rules, mode,
        cache, pos)
    x = x + constrain(h, rules, "batch", None, "embed")
    if new_cache is not None and cm_cache:
        new_cache = {**new_cache, **cm_cache}
    elif cm_cache:
        new_cache = cm_cache
    return x, new_cache


# ---------------------------------------------------------------------------
# All layers
# ---------------------------------------------------------------------------


def blocks_init(gen: torch.Generator, cfg: ArchConfig) -> list:
    plan = layer_plan(cfg)
    return [{f"l{i}": _layer_init(gen, cfg, mixer, ffn)
             for i, (mixer, ffn) in enumerate(plan)}
            for _ in range(scan_length(cfg))]


def _cache_tree(cfg: ArchConfig, batch: int, max_seq: int, make) -> list:
    plan = layer_plan(cfg)
    return [{f"l{i}": _layer_cache_init(cfg, mixer, ffn, batch, max_seq,
                                        make)
             for i, (mixer, ffn) in enumerate(plan)}
            for _ in range(scan_length(cfg))]


def blocks_cache_init(cfg: ArchConfig, batch: int, max_seq: int,
                      device) -> list:
    """The zero decode cache of every layer on ``device``."""
    return _cache_tree(cfg, batch, max_seq, lambda s, d, _: torch.zeros(
        s, dtype=d, device=device))


def blocks_cache_axes(cfg: ArchConfig, batch: int, max_seq: int) -> list:
    """The decode cache's logical-axes tree (one tuple a leaf)."""
    return _cache_tree(cfg, batch, max_seq, lambda s, d, axes: axes)


def blocks_apply(block_params: list, cfg: ArchConfig, x, rules=None,
                 mode="train", cache=None, pos=None, max_seq=None):
    """Run all layers. Returns (x, new cache list or None)."""
    plan = layer_plan(cfg)
    caches = []
    for u, unit_p in enumerate(block_params):
        unit_c = cache[u] if cache is not None else None
        new_unit = {}
        for i, (mixer, ffn) in enumerate(plan):
            c = unit_c[f"l{i}"] if unit_c is not None else None
            x, nc = layer_apply(unit_p[f"l{i}"], cfg, mixer, ffn, x, mode, c,
                                pos, max_seq, rules)
            if nc is not None:
                new_unit[f"l{i}"] = nc
        caches.append(new_unit or None)
    new_cache = caches if caches and caches[0] is not None else None
    return x, new_cache
