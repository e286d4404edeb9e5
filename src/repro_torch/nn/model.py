"""LM assembly: embeddings -> blocks -> final norm -> unembed, plus the
training loss and the prefill/decode serving entry points.

``init_params`` and ``init_cache`` take ``device=None`` (= ``cuda``, which
raises on a host without one); the tests pass ``device="cpu"``.  Parameters
are nested dicts of tensors with the blocks as a list over scan units
(``nn.blocks``).  ``abstract_params`` / ``abstract_cache`` build the same
trees as tensors on the ``meta`` device: shapes and dtypes, no storage.
``param_axes`` / ``cache_axes`` build the mirrored trees of logical axes
(the reference returns them beside the values), each block leaf's without
the reference's leading ``"layers"`` (the port's blocks are a list over
units).

Every entry point takes ``rules`` (a
:class:`~repro_torch.distributed.ShardingRules` on a ``DeviceMesh``) for
the reference's activation constraints: with rules, parameters and caches
are DTensors (``distributed.shard_tree``), plain inputs are taken as
replicated, and the activations are redistributed where the reference
constrains them.
"""

from __future__ import annotations

import torch

from ..distributed import constrain, gather_over, sharded_region
from ..exec import tree_map
from ..kernels.platform import resolve_device
from .blocks import (
    blocks_apply,
    blocks_cache_axes,
    blocks_cache_init,
    blocks_init,
)
from .config import ArchConfig
from .layers import (
    AxesGen,
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


def param_axes(cfg: ArchConfig) -> dict:
    """The parameters' logical-axes tree: ``init_params``'s structure with
    a tuple of axis names (or None) at each leaf."""
    return _params(AxesGen(), cfg)


def cache_axes(cfg: ArchConfig, batch: int, max_seq: int) -> list:
    """The decode cache's logical-axes tree (``init_cache``'s structure)."""
    return blocks_cache_axes(cfg, batch, max_seq)


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


def cast_params(params, dtype: torch.dtype, rules=None):
    """Floating leaves cast to the compute dtype; a leaf already in it is
    returned as it is (no copy).  With rules, each leaf is also gathered
    over the batch's mesh axes (the FSDP all-gather: a weight sharded at
    rest on the data axes is whole there while it computes)."""
    def one(p):
        p = p.to(dtype) if p.is_floating_point() else p
        if rules is not None:
            p = gather_over(p, rules.physical("batch"))
        return p

    return tree_map(one, params)


def _embed_inputs(params, cfg: ArchConfig, batch: dict,
                  rules=None) -> torch.Tensor:
    if cfg.embed_input:
        x = batch["embeds"].to(cfg.cdtype())
    else:
        x = embed(params["embed"], batch["tokens"].long(), rules).to(
            cfg.cdtype())
    return constrain(x, rules, "batch", None, "embed")


def _logits(params, cfg: ArchConfig, x: torch.Tensor,
            rules=None) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(cfg.cdtype()).T
    else:
        logits = unembed(params["unembed"], x)
    logits = constrain(logits, rules, "batch", None, "vocab")
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.float() / c)
    return logits


def forward(params, cfg: ArchConfig, batch: dict, rules=None,
            mode: str = "train", max_seq: int | None = None):
    """Full-sequence forward. Returns (logits, cache_or_None)."""
    with sharded_region(rules):
        params = cast_params(params, cfg.cdtype(), rules)
        x = _embed_inputs(params, cfg, batch, rules)
        max_seq = max_seq or x.shape[1]
        x, cache = blocks_apply(params["blocks"], cfg, x, rules, mode=mode,
                                max_seq=max_seq)
        return _logits(params, cfg, x, rules), cache


def loss_fn(params, cfg: ArchConfig, batch: dict, rules=None) -> tuple:
    """Next-token cross entropy in fp32, the last position masked (for
    ``embed_input`` archs: ``batch["labels"]``, every position counted).
    Returns (loss, {"loss", "accuracy", "tokens"}), 0-d tensors; the loss
    carries the graph of ``params``."""
    with sharded_region(rules):
        return _loss(params, cfg, batch, rules)


def _loss(params, cfg: ArchConfig, batch: dict, rules) -> tuple:
    logits, _ = forward(params, cfg, batch, rules, mode="train")
    # the loss reads every vocab entry of a row: whole rows on each rank
    logits = constrain(logits, rules, "batch", None, None)
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


def prefill(params, cfg: ArchConfig, batch: dict, rules=None,
            max_seq: int | None = None):
    """Prompt processing: returns (last-position logits, populated cache)."""
    logits, cache = forward(params, cfg, batch, rules, mode="prefill",
                            max_seq=max_seq)
    return logits[:, -1], cache


def decode_step(params, cfg: ArchConfig, cache, batch: dict, pos: int,
                rules=None):
    """One incremental decode step.

    ``batch`` holds ``tokens (B, 1)`` (or ``embeds (B, 1, D)`` for stub-
    frontend archs); ``pos`` is the write position.  Attention caches are
    written in place (``nn.attention.decode_attention``).  Returns
    (logits (B, vocab), new_cache).
    """
    with sharded_region(rules):
        params = cast_params(params, cfg.cdtype(), rules)
        x = _embed_inputs(params, cfg, batch, rules)
        x, new_cache = blocks_apply(params["blocks"], cfg, x, rules,
                                    mode="decode", cache=cache, pos=int(pos),
                                    max_seq=cache_max_seq(cfg, cache))
        logits = _logits(params, cfg, x, rules)
        return logits[:, -1], new_cache


def cache_max_seq(cfg: ArchConfig, cache) -> int:
    """Infer max_seq from an attention cache (1 for pure-SSM caches)."""
    for unit in cache:
        for layer in unit.values():
            if "k" in layer:  # (B, Smax, Hk, dh)
                return layer["k"].shape[1]
    return 1
