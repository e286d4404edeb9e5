"""LM assembly: embeddings -> blocks -> final norm -> unembed, plus the
training loss and the prefill/decode serving entry points.

``init_params`` and ``init_cache`` take ``device=None`` (= ``cuda``, which
raises on a host without one); the tests pass ``device="cpu"``.  Parameters
are nested dicts of tensors with the blocks as a list over scan units
(``nn.blocks``).  ``abstract_params`` / ``abstract_cache`` build the same
trees as tensors on the ``meta`` device: shapes and dtypes, no storage.
"""

from __future__ import annotations

import torch

from ..exec import tree_map
from ..kernels.platform import resolve_device
from .blocks import blocks_apply, blocks_cache_init, blocks_init
from .config import ArchConfig
from .layers import (
    MetaGen,
    embed,
    embed_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
    unembed_init,
)

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _params(gen, cfg: ArchConfig) -> dict:
    dt = cfg.pdtype()
    p = {}
    if not cfg.embed_input:
        p["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, dt)
    p["blocks"] = blocks_init(gen, cfg)
    p["final_norm"] = rmsnorm_init(gen, cfg.d_model, dt)
    if not cfg.tie_embeddings:
        p["unembed"] = unembed_init(gen, cfg.d_model, cfg.vocab, dt)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Random parameters at ``cfg``'s shapes, drawn in the reference's order
    from one ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    return _params(torch.Generator(device=dev).manual_seed(seed), cfg)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the dry-run's; no
    allocation)."""
    return _params(MetaGen(), cfg)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> list:
    """A zero decode cache for ``batch`` rows of up to ``max_seq`` tokens."""
    return blocks_cache_init(cfg, batch, max_seq, resolve_device(device))


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int) -> list:
    """The decode cache as ``meta`` tensors (no allocation)."""
    return blocks_cache_init(cfg, batch, max_seq, torch.device("meta"))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def tree_leaves(tree):
    """The tensor leaves of a dict/list tree, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def cast_params(params, dtype: torch.dtype):
    """Floating leaves cast to the compute dtype; a leaf already in it is
    returned as it is (no copy)."""
    return tree_map(
        lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def _embed_inputs(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    if cfg.embed_input:
        return batch["embeds"].to(cfg.cdtype())
    return embed(params["embed"], batch["tokens"].long()).to(cfg.cdtype())


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(cfg.cdtype()).T
    else:
        logits = unembed(params["unembed"], x)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.float() / c)
    return logits


def forward(params, cfg: ArchConfig, batch: dict, mode: str = "train",
            max_seq: int | None = None):
    """Full-sequence forward. Returns (logits, cache_or_None)."""
    params = cast_params(params, cfg.cdtype())
    x = _embed_inputs(params, cfg, batch)
    max_seq = max_seq or x.shape[1]
    x, cache = blocks_apply(params["blocks"], cfg, x, mode=mode,
                            max_seq=max_seq)
    return _logits(params, cfg, x), cache


def loss_fn(params, cfg: ArchConfig, batch: dict) -> tuple:
    """Next-token cross entropy in fp32, the last position masked (for
    ``embed_input`` archs: ``batch["labels"]``, every position counted).
    Returns (loss, {"loss", "accuracy", "tokens"}), 0-d tensors; the loss
    carries the graph of ``params``."""
    logits, _ = forward(params, cfg, batch, mode="train")
    if cfg.embed_input:
        labels = batch["labels"].long()
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    else:
        tokens = batch["tokens"].long()
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
        mask[:, -1] = 0.0
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - lab) * mask
    count = mask.sum()
    denom = count.clamp_min(1.0)
    loss = nll.sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": count}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int | None = None):
    """Prompt processing: returns (last-position logits, populated cache)."""
    logits, cache = forward(params, cfg, batch, mode="prefill",
                            max_seq=max_seq)
    return logits[:, -1], cache


def decode_step(params, cfg: ArchConfig, cache, batch: dict, pos: int):
    """One incremental decode step.

    ``batch`` holds ``tokens (B, 1)`` (or ``embeds (B, 1, D)`` for stub-
    frontend archs); ``pos`` is the write position.  Attention caches are
    written in place (``nn.attention.decode_attention``).  Returns
    (logits (B, vocab), new_cache).
    """
    params = cast_params(params, cfg.cdtype())
    x = _embed_inputs(params, cfg, batch)
    x, new_cache = blocks_apply(params["blocks"], cfg, x, mode="decode",
                                cache=cache, pos=int(pos),
                                max_seq=cache_max_seq(cfg, cache))
    logits = _logits(params, cfg, x)
    return logits[:, -1], new_cache


def cache_max_seq(cfg: ArchConfig, cache) -> int:
    """Infer max_seq from an attention cache (1 for pure-SSM caches)."""
    for unit in cache:
        for layer in unit.values():
            if "k" in layer:  # (B, Smax, Hk, dh)
                return layer["k"].shape[1]
    return 1
